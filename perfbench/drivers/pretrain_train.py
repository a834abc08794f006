"""Closed loop of geometric pretraining steps (``make_pretrain_step``)
over packed batches held on the device, as ``run_pretrain``'s HBM tier
holds them.

Traffic parameters: ``pool`` (the molecules), ``batches_per_epoch``;
the batch size is the configuration's. Every epoch holds the pool
``batch_size · batches_per_epoch / pool`` times over, so every seed
trains on the same molecules and the same sizes; the seed draws which
batch each copy goes to, the weights, the dropout stream and the order of
the batches in each epoch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.common import check, pool, weights
from perfbench.costs import edges, flops, kernels
from perfbench.reference import layout, model as ref


def _draw(rng: np.random.Generator, n_pool: int, reps: int,
          n_batches: int, batch: int) -> List[np.ndarray]:
    order = rng.permutation(np.repeat(np.arange(n_pool), reps))
    return [order[i * batch:(i + 1) * batch] for i in range(n_batches)]


def probe_and_spec(graphs, batch: int, n_batches: int, p: Dict):
    """The fixed probe (one epoch's molecules in the pool seed's order) and
    the program's PadSpec for it; the same for every run's seed."""
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    reps = batch * n_batches // len(graphs)
    idx = _draw(np.random.default_rng(p["seed"]), len(graphs), reps, 1,
                batch * n_batches)[0]
    probe = [graphs[i] for i in idx]
    spec = pool.cached_spec(
        {"probe": "pt", **p, "batch": batch, "batches": n_batches},
        lambda: spec_for(probe, batch_size=batch, tcsr=True))
    return probe, spec


class Session:
    def __init__(self, ctx):
        from fragnet_tpu_torch.data.packing import (_DP_LEVELS, build_layout,
                                                    dp_level_ok, pack_batch)
        from fragnet_tpu_torch.graphs.hiergraph import fits, pad_batch
        from fragnet_tpu_torch.model.layers import KernelPolicy
        from fragnet_tpu_torch.model.pretrain import FragNetPreTrain
        from fragnet_tpu_torch.train.optim import make_optimizer
        from fragnet_tpu_torch.train.pretrain import make_pretrain_step

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg = ctx, cfg
        m = cfg["model"]
        p = tr["pool"]
        self.pool = pool.pool("pt", p["n"], p["profile"], p["seed"],
                              ctx.workers)
        B = cfg["batch_size"]
        nb = tr["batches_per_epoch"]
        reps = B * nb // len(self.pool)
        self.probe, spec = probe_and_spec(self.pool, B, nb, p)
        self.spec = spec
        ctx.mark("pool and spec")

        # drawn again until every batch fits the spec and its pinned TCSR
        # windows (pad_batch refuses one that does not)
        rng = np.random.default_rng(ctx.sub_seed("batches"))
        dp_levels = tuple(l for l in _DP_LEVELS
                          if dp_level_ok(self.pool, l, spec.tn_of(l[3:])))
        while True:
            self.idx = _draw(rng, len(self.pool), reps, nb, B)
            if not all(fits([self.pool[i] for i in ix], spec)
                       for ix in self.idx):
                continue
            try:
                padded = [pad_batch([self.pool[i] for i in ix], spec,
                                    with_targets=True, build_dense=False,
                                    strict_tcsr=True) for ix in self.idx]
                break
            except ValueError:
                continue
        self.layout = build_layout(padded[0], "float32", compact=False,
                                   aligned=spec.align, dp_levels=dp_levels)
        bufs = [pack_batch(b, self.layout, validate=k == 0)
                for k, b in enumerate(padded)]
        del padded
        self.bufs = torch.from_numpy(np.stack(bufs)).to(ctx.device)
        del bufs
        ctx.mark("batches packed on the device")

        pol = KernelPolicy(**cfg["kernel"])
        self.model = FragNetPreTrain(
            num_layer=m["num_layer"], num_heads=m["num_heads"],
            drop_ratio=m["drop_ratio"], emb_dim=m["emb_dim"],
            atom_features=m["atom_features"],
            frag_features=m["frag_features"],
            edge_features=m["edge_features"], fedge_in=m["fedge_in"],
            fbond_edge_in=m["fbond_edge_in"], policy=pol).to(ctx.device)
        self.w0 = weights.make(weights.shapes_of(self.model),
                               ctx.sub_seed("weights"), ctx.device)
        self.model.load_state_dict(self.w0, strict=True)
        o = cfg["optimizer"]
        self.opt, _ = make_optimizer(self.model.parameters(), o["name"],
                                     lr=o["lr"])
        self._step = make_pretrain_step(self.model, self.opt, layout=self.layout,
                                        device=ctx.device)
        ctx.mark("model")

        # the seed's epochs: batch orders; the first steps take the first
        # epoch's first batches, which all differ
        self._order_rng = np.random.default_rng(ctx.sub_seed("order"))
        self._queue: List[int] = []
        n_check = tr["check_steps"]
        self.check_batches = [self._next() for _ in range(n_check)]
        self.check_seeds = [ctx.sub_seed(f"dropout{k}")
                            for k in range(n_check)]
        self.first = check.FirstSteps(
            self.model, self.opt, self._step,
            [self.bufs[i] for i in self.check_batches], self.check_seeds)
        ctx.mark("first steps")
        self.losses: List[torch.Tensor] = []
        self.done: List[int] = []
        for _ in range(tr["warmup_steps"]):
            self.step()
        ctx.mark("warm-up")
        self.items_per_step = B

    def _next(self) -> int:
        if not self._queue:
            self._queue = list(self._order_rng.permutation(len(self.idx)))
        return int(self._queue.pop(0))

    def step(self):
        i = self._next()
        self.losses.append(self._step(self.bufs[i]))
        self.done.append(i)

    def begin_window(self):
        self.losses, self.done = [], []

    def end_window(self) -> Dict[str, int]:
        ok = torch.isfinite(torch.stack(self.losses)).cpu().numpy()
        return {"attempted": len(ok), "failed": int((~ok).sum())}

    def release(self):
        del self._step, self.opt, self.model, self.bufs
        torch.cuda.empty_cache() if self.ctx.device.type == "cuda" else None

    # -- per-layer work ----------------------------------------------------
    def _counts(self, i: int) -> Dict[str, int]:
        return flops.real_counts([self.pool[j] for j in self.idx[i]])

    def model_flops(self, steps: List[int]) -> float:
        m = self.cfg["model"]
        per = {i: 3 * flops.pretrain_forward(self._counts(i),
                                             m["num_layer"], m["emb_dim"],
                                             m["num_heads"])
               for i in set(steps)}
        return float(sum(per[i] for i in steps))

    def gat_bound_ms(self, steps: List[int]) -> float:
        m = self.cfg["model"]
        tn = {ax: self.spec.tn_of(ax) for ax in layout.AXES}
        per = {i: kernels.gat_passes_step(
            self._counts(i), m["num_layer"], m["num_heads"],
            m["emb_dim"] // m["num_heads"], tn) for i in set(steps)}
        return float(sum(per[i] for i in steps))

    def describe(self, window_s: float) -> str:
        """Message edges per second over the window (the port's epoch
        count, restated per batch)."""
        per = {i: edges.message_edges([self.pool[j] for j in self.idx[i]],
                                      self.cfg["model"]["num_layer"])
               for i in set(self.done)}
        n = sum(per[i] for i in self.done)
        return f"message edges: {n} in the window, {n / window_s:.6g}/s"

    # -- correctness -------------------------------------------------------
    def reference(self):
        """The reference's first steps: (losses, first gradient, weights
        after the last step)."""
        cfg, dev = self.cfg, self.ctx.device
        rows = layout.padded_rows(self.probe, cfg["batch_size"])
        tn = layout.tiles(self.probe)
        spec_rows = {"atom": self.spec.n_atoms, "bond": self.spec.n_edges,
                     "frag": self.spec.n_frags, "fc": self.spec.n_fconn}
        if rows != spec_rows:
            raise RuntimeError(f"padded rows: reference {rows}, program "
                               f"{spec_rows}")
        batches = [ref.make_batch([self.pool[j] for j in self.idx[i]], rows,
                                  tn, dev) for i in self.check_batches]
        return check.reference_steps(
            lambda w, b: ref.pretrain_loss(w, b, cfg, True), self.w0,
            batches, self.check_seeds, cfg["optimizer"], ref.adam)

    def numbers(self) -> Dict[str, float]:
        return check.training_numbers(self.first.result(), self.reference(),
                                      self.w0)
