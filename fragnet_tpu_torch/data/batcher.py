"""Static-shape batch loader: shuffling and padding to one PadSpec, the
packed single-buffer transport (data/packing.py) with threaded or spawned
pack workers, the dataset caches, and size-bucketed loading (counterpart
of fragnet_tpu/data/batcher.py).

Replacement for torch DataLoader + collate_fn: every emitted batch has the
shape of one PadSpec; molecules are packed greedily until a cap would
overflow. Batches stay numpy until a device cache or the step moves them
(graphs/batch.py); this module imports no torch at load time, so spawned
pack workers stay light.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from fragnet_tpu_torch.graphs.build import MolGraph
from fragnet_tpu_torch.graphs.hiergraph import HierGraphBatch, PadSpec, fits, pad_batch, spec_for


class BatchLoader:
    """Iterable over HierGraphBatch with static shapes.

    * ``spec`` fixed across all batches (single compilation);
    * shuffle with a numpy seed per epoch;
    * short final batches are padded with empty graph slots.
    """

    def __init__(
        self,
        graphs: Sequence[MolGraph],
        batch_size: int,
        spec: Optional[PadSpec] = None,
        shuffle: bool = False,
        seed: int = 0,
        n_tasks: int = 1,
        with_targets: bool = False,
        drop_last: bool = False,
        on_oversize: str = "skip",
        pack: bool = False,
        pack_compact: bool = False,
        compute_dtype=None,
    ):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.spec = spec or spec_for(self.graphs, batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.n_tasks = n_tasks
        self.with_targets = with_targets
        self.drop_last = drop_last
        # oversize policy: 'skip' (train loaders — molecule dropped loudly)
        # or 'error' (eval loaders — a dropped molecule would silently
        # corrupt the reported metric; VERDICT r1 weak #6)
        if on_oversize not in ("skip", "error"):
            raise ValueError(f"on_oversize={on_oversize!r} (skip|error)")
        self.on_oversize = on_oversize
        # pack=True: emit single-buffer packed batches (data/packing.py),
        # padded without dense planes (unpack_batch rebuilds them on the
        # device); the layout is built from the first batch, its model-dtype
        # floats in ``compute_dtype`` (bf16 or f32, the default);
        # pack_compact=True adds the compact encodings (packing.build_layout)
        self.pack = pack
        self.pack_compact = pack_compact
        self.compute_dtype = compute_dtype
        self.layout = None
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.graphs)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _windows(self) -> Iterator[List[MolGraph]]:
        """One epoch of greedy molecule windows (advances the shuffle
        state). Deterministic given (seed, epoch)."""
        order = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1

        _FIT_KEYS = ("n_atoms", "n_edges", "n_frags", "n_fconn",
                     "n_bg_edges", "n_fc_edges")
        caps = tuple(getattr(self.spec, k) for k in _FIT_KEYS)
        aligned = self.spec.align
        # per-axis node tiles (PadSpec.tn_of): first four _FIT_KEYS are the
        # aligned node levels atom / bond / frag / fc
        lvl_tn = [self.spec.tn_of(l) for l in ("atom", "bond", "frag", "fc")]

        def bump(pos: int, cnt: int, tn: int) -> int:
            # aligned packing: a molecule that would straddle a tn boundary
            # starts at the next tile (mirrors hiergraph._aligned_starts)
            if aligned and tn and cnt <= tn \
                    and (pos % tn) + cnt > tn:
                pos = ((pos + tn - 1) // tn) * tn
            return pos + cnt

        i = 0
        while i < len(order):
            window: List[MolGraph] = []
            totals = [0] * len(_FIT_KEYS)
            while i < len(order) and len(window) < self.batch_size:
                cand = self.graphs[order[i]]
                sizes = tuple(getattr(cand, k) for k in _FIT_KEYS)
                # incremental capacity check in ALIGNED positions (the first
                # four keys are node levels subject to tile alignment); an
                # O(B²) re-sum of the window per candidate dominated batch
                # prep before
                if window:
                    newpos = [bump(t, s, lvl_tn[j] if j < 4 else 0)
                              for j, (t, s) in enumerate(zip(totals, sizes))]
                    if any(p > c for p, c in zip(newpos, caps)):
                        break
                if not window and not fits([cand], self.spec):
                    if self.on_oversize == "error":
                        raise ValueError(
                            f"molecule exceeds the PadSpec in an eval loader "
                            f"(would silently shrink the eval set): "
                            f"{cand.smiles}; enlarge the spec or clean the "
                            f"dataset")
                    # train loader: skip it loudly
                    print(f"[batcher] molecule too large for spec, skipped: "
                          f"{cand.smiles}")
                    i += 1
                    continue
                window.append(cand)
                totals = [bump(t, s, lvl_tn[j] if j < 4 else 0)
                          for j, (t, s) in enumerate(zip(totals, sizes))]
                i += 1
            if not window:
                continue
            if self.drop_last and len(window) < self.batch_size \
                    and i >= len(order):
                break
            yield window

    def __iter__(self) -> Iterator[HierGraphBatch]:
        for window in self._windows():
            batch = pad_batch(window, self.spec, n_tasks=self.n_tasks,
                              with_targets=self.with_targets,
                              build_dense=not self.pack,
                              strict_tcsr=self.pack and self.spec.tcsr)
            if self.pack:
                from fragnet_tpu_torch.data.packing import (_DP_LEVELS,
                                                            build_layout,
                                                            dp_level_ok,
                                                            pack_batch)

                validate = self.layout is None
                if validate:
                    # levels whose dense planes unpack_batch can rebuild on
                    # the device for EVERY batch of this dataset (tile-local
                    # + collision-free; packing.dp_level_ok)
                    dp_levels = ()
                    if self.spec.align and self.spec.tcsr:
                        dp_levels = tuple(
                            l for l in _DP_LEVELS
                            if dp_level_ok(self.graphs, l,
                                           self.spec.tn_of(l[3:])))
                    self.layout = build_layout(
                        batch, self.compute_dtype or "float32",
                        compact=self.pack_compact,
                        aligned=self.spec.align, dp_levels=dp_levels)
                batch = pack_batch(batch, self.layout, validate=validate)
            yield batch

    def _iter_packed_indexed(self, n_epochs: int, worker_id: int,
                             n_workers: int):
        """(global_index, packed bytes) for every batch assigned to this
        worker over ``n_epochs`` epochs. Every worker walks the IDENTICAL
        deterministic window sequence (cheap greedy sums) and pays
        pad+pack only for its own stride — the multi-process pack path."""
        if not self.pack or self.layout is None:
            raise ValueError("packed iteration needs pack=True and a layout")
        from fragnet_tpu_torch.data.packing import pack_batch

        idx = 0
        for _ in range(n_epochs):
            for window in self._windows():
                if idx % n_workers == worker_id:
                    b = pad_batch(window, self.spec, n_tasks=self.n_tasks,
                                  with_targets=self.with_targets,
                                  build_dense=False,
                                  strict_tcsr=self.spec.tcsr)
                    yield (idx, pack_batch(b, self.layout).tobytes())
                idx += 1

    def prefetch(self, depth: int = 2) -> Iterator[HierGraphBatch]:
        """Iterate with batches produced by a background thread into a
        bounded queue, overlapping host padding/packing with the device's
        work (the role of torch DataLoader workers in the reference,
        finetune_gat2.py:240)."""
        return _threaded(lambda: iter(self), depth)

    def _host_copy(self) -> "BatchLoader":
        """A loader with the same graphs, spec, shuffle state and layout —
        what a spawned pack worker receives."""
        host = BatchLoader(
            self.graphs, self.batch_size, spec=self.spec, shuffle=self.shuffle,
            seed=self.seed, n_tasks=self.n_tasks,
            with_targets=self.with_targets, drop_last=self.drop_last,
            on_oversize=self.on_oversize, pack=True,
            pack_compact=self.pack_compact, compute_dtype=self.compute_dtype)
        host.layout = self.layout
        return host

    def stream(self, n_epochs: int, depth: int = 3, process: bool = False,
               workers: int = 1) -> Iterator[HierGraphBatch]:
        """``n_epochs`` epochs as ONE continuous background-producer stream —
        no pipeline drain at epoch boundaries (each epoch reshuffles when
        ``shuffle``). The pretraining shape: epochs are long, batches flow
        back-to-back.

        ``process=True`` (requires ``pack``) pads+packs in spawned worker
        PROCESSES, so GIL-heavy numpy packing does not serialize with the
        training loop's host dispatch. The workers import numpy-only modules
        and never touch torch or CUDA; the step moves each buffer to the
        device.

        ``workers`` > 1 shards batches round-robin over that many pack
        processes (each walks the same deterministic shuffle and packs every
        k-th batch); the parent re-orders by global batch index."""
        if not process:
            def gen():
                for _ in range(n_epochs):
                    yield from self
            yield from _threaded(gen, depth)
            return

        if not self.pack:
            raise ValueError("process streaming requires pack=True "
                             "(HierGraphBatch pickling would dominate)")
        if self.layout is None:
            next(iter(self))  # build the layout in the parent first
        import multiprocessing as mp
        import queue as _queue

        # spawn, not fork: the parent may hold CUDA state and threads, under
        # which fork() deadlocks; spawned workers re-import numpy-only code
        # and receive the loader by pickle
        ctx = mp.get_context("spawn")
        workers = max(1, int(workers))
        q = ctx.Queue(maxsize=max(depth, 2 * workers))
        host = self._host_copy()
        host._epoch = self._epoch
        procs = [ctx.Process(target=_pack_worker,
                             args=(host, q, n_epochs, w, workers), daemon=True)
                 for w in range(workers)]
        for p in procs:
            p.start()
        done_workers = 0
        try:
            pending: dict = {}
            next_idx = 0
            while done_workers < workers:
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
                # bounded wait: a dead or stuck worker surfaces as an error,
                # not as a hang of the training loop
                try:
                    item = q.get(timeout=300)
                except _queue.Empty:
                    alive = sum(p.is_alive() for p in procs)
                    raise RuntimeError(
                        f"pack workers produced nothing for 300s "
                        f"(alive={alive}/{workers})") from None
                if item is None:
                    done_workers += 1
                    continue
                if isinstance(item, str):  # worker traceback
                    raise RuntimeError(f"pack worker failed:\n{item}")
                idx, raw = item
                pending[idx] = np.frombuffer(raw, np.uint8)
            while next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1
        finally:
            # workers of a stream closed early (a consumer that stopped, a
            # cache over budget) are still producing: stop them at once
            for p in procs:
                if done_workers < workers:
                    p.terminate()
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)


def _threaded(make_iter, depth: int):
    """Iterate ``make_iter()`` in a background thread through a bounded
    queue; an exception in the thread is raised in the consumer."""
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for b in make_iter():
                q.put(b)
            q.put(done)
        except BaseException as exc:  # surfaced to the consumer below
            q.put(exc)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _pack_worker(loader: "BatchLoader", q, n_epochs: int,
                 worker_id: int = 0, n_workers: int = 1) -> None:
    """Spawned packing worker — numpy only, never touches torch. Walks the
    same deterministic shuffle as every other worker, pads+packs every
    ``n_workers``-th batch, and tags each with its global index so the
    parent can restore order."""
    try:
        for item in loader._iter_packed_indexed(n_epochs, worker_id,
                                                n_workers):
            q.put(item)
        q.put(None)
    except BaseException:
        import traceback

        q.put(traceback.format_exc())


class PackedCacheLoader:
    """Host-RAM cache of PACKED batches: pad+pack each batch ONCE (in
    parallel pack workers), then every later epoch replays the uint8 buffers
    in a reshuffled order — steady-state epochs skip the host padding and
    packing, leaving only the transfer, which the step makes from pinned
    memory (graphs/batch.py:PackedUploader). The streamed-pretrain steady
    state for datasets that exceed the device cache but fit host RAM packed.

    Batch COMPOSITION is fixed after the packing pass; only batch ORDER
    reshuffles per epoch (as DeviceCacheLoader)."""

    def __init__(self, loader: BatchLoader, seed: int = 0, workers: int = 1,
                 max_bytes: Optional[int] = None):
        if not loader.pack:
            raise ValueError("PackedCacheLoader requires pack=True")
        if loader.layout is None:
            next(iter(loader))  # build the layout (advances shuffle state)
            loader._epoch = max(0, loader._epoch - 1)
        self.loader = loader
        self.seed = seed
        self._epoch = 0
        self.bufs: List[np.ndarray] = []
        host = loader._host_copy()
        it = (host.stream(1, depth=2 * max(1, workers), process=True,
                          workers=workers)
              if workers > 1 else iter(host))
        budget = max_bytes if max_bytes is not None else (8 << 30)
        for buf in it:
            self.bufs.append(np.asarray(buf))
            if len(self.bufs) * loader.layout.total_bytes > budget:
                raise MemoryError(
                    f"packed dataset exceeds the host cache budget "
                    f"({budget / 1e9:.1f} GB) — stream instead "
                    f"(BatchLoader.stream)")

    @property
    def layout(self):
        return self.loader.layout

    def __len__(self) -> int:
        return len(self.bufs)

    def __iter__(self):
        order = np.random.default_rng(self.seed + self._epoch).permutation(
            len(self.bufs))
        self._epoch += 1
        for i in order:
            yield self.bufs[i]

    def stream(self, n_epochs: int):
        """n_epochs as one continuous iterator. The buffers are in memory
        and the step's copy does not block the host, so no prefetch thread
        is needed (the JAX package's thread overlapped its device_put)."""
        for _ in range(n_epochs):
            yield from self


class DevicePackedCacheLoader:
    """Device-resident PACKED dataset: pack every batch once (parallel
    workers), copy the uint8 buffers to ``device`` ONCE (one tensor, a row
    per batch), and replay them in a reshuffled order per epoch — zero host
    work and zero transfers in steady state; the step unpacks on the device
    with the plane builder (ops/dense_gat.py). Packed batches are ~6x
    smaller than padded ones, so this covers pretrain-scale datasets that
    DeviceCacheLoader cannot hold. Composition is fixed after packing;
    order reshuffles."""

    def __init__(self, loader: BatchLoader, seed: int = 0, workers: int = 1,
                 max_bytes: Optional[int] = None, device="cuda"):
        import torch

        host = PackedCacheLoader(loader, seed=seed, workers=workers,
                                 max_bytes=max_bytes if max_bytes is not None
                                 else (6 << 30))
        self.loader = loader
        self.seed = seed
        self._epoch = 0
        stacked = np.stack(host.bufs) if host.bufs else np.zeros(
            (0, loader.layout.total_bytes), np.uint8)
        host.bufs = []  # free the host copies as soon as they are stacked
        self.bufs = torch.from_numpy(stacked).to(device)

    @property
    def layout(self):
        return self.loader.layout

    def __len__(self) -> int:
        return int(self.bufs.shape[0])

    def __iter__(self):
        order = np.random.default_rng(self.seed + self._epoch).permutation(
            len(self))
        self._epoch += 1
        for i in order:
            yield self.bufs[int(i)]

    def stream(self, n_epochs: int):
        """n_epochs as one continuous iterator (the buffers are already on
        the device — no prefetch machinery needed)."""
        for _ in range(n_epochs):
            yield from self


class DeviceCacheLoader:
    """Device-resident dataset: materializes every batch on ``device`` ONCE
    and yields them in a shuffled order per epoch; the step's ``to_device``
    then leaves them as they are. MoleculeNet-scale finetune sets fit
    easily, so after the first epoch the input pipeline costs nothing.

    Divergence note vs the reference DataLoader(shuffle=True): batch
    COMPOSITION is fixed after the first pass; only batch ORDER reshuffles
    (as the JAX package's, whose re-pad option ``reshuffle_every`` no entry
    point sets)."""

    def __init__(self, loader: BatchLoader, seed: int = 0, device="cuda"):
        from fragnet_tpu_torch.graphs.batch import to_device

        self.seed = seed
        self._epoch = 0
        self.batches: List = [to_device(b, device) for b in loader]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        order = np.random.default_rng(self.seed + self._epoch).permutation(
            len(self.batches))
        self._epoch += 1
        for i in order:
            yield self.batches[i]


class BucketedBatchLoader:
    """Multi-bucket static-shape loader (SURVEY §7 step 7's bucketing policy).

    Molecules are sorted by message-edge count and split into ``n_buckets``
    quantile groups; each group gets its own PadSpec from its OWN size
    distribution (``spec_for(group, batch_size, **spec_kwargs)``, so with
    ``tcsr`` each bucket's batches carry their TCSR metadata and dense
    planes), so small molecules stop paying the p95-of-everything padding
    tax. Batches from different buckets interleave in a shuffled order each
    epoch — the JAX package's order, batch for batch.

    Iterates and has a length as BatchLoader (an upper bound: a bucket's
    windows may be fewer); ``specs`` lists the per-bucket PadSpecs.
    """

    def __init__(
        self,
        graphs: Sequence[MolGraph],
        batch_size: int,
        n_buckets: int = 3,
        shuffle: bool = False,
        seed: int = 0,
        n_tasks: int = 1,
        with_targets: bool = False,
        on_oversize: str = "skip",
        spec_kwargs: Optional[dict] = None,
    ):
        graphs = list(graphs)
        if not graphs:
            raise ValueError("empty dataset")
        n_buckets = max(1, min(n_buckets, len(graphs)))
        key = np.array([g.n_edges + g.n_bg_edges for g in graphs])
        order = np.argsort(key, kind="stable")
        bounds = np.linspace(0, len(graphs), n_buckets + 1).astype(int)
        self.loaders: List[BatchLoader] = []
        kw = spec_kwargs or {}
        for b in range(n_buckets):
            idx = order[bounds[b]:bounds[b + 1]]
            if len(idx) == 0:
                continue
            group = [graphs[i] for i in idx]
            spec = spec_for(group, batch_size, **kw)
            self.loaders.append(BatchLoader(
                group, batch_size, spec=spec, shuffle=shuffle,
                seed=seed + b, n_tasks=n_tasks, with_targets=with_targets,
                on_oversize=on_oversize,
            ))
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    @property
    def specs(self) -> List[PadSpec]:
        return [l.spec for l in self.loaders]

    def __len__(self) -> int:
        return sum(len(l) for l in self.loaders)

    def __iter__(self) -> Iterator[HierGraphBatch]:
        # materialize per-bucket iterators and interleave in shuffled order
        streams = [iter(l) for l in self.loaders]
        schedule = np.concatenate(
            [np.full(len(l), i) for i, l in enumerate(self.loaders)])
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 7919 * self._epoch)
            rng.shuffle(schedule)
            self._epoch += 1
        for s in schedule:
            b = next(streams[s], None)
            if b is not None:
                yield b
        # drain any stragglers (len() is an upper-bound estimate per bucket)
        for st in streams:
            for b in st:
                yield b
