#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and holds every kernel of them
against its plain PyTorch version: the gat2 ESOL recipe
(configs/ft/esol.yaml, full width: 4 layers, emb 128, 4 heads, FTHead3
128/1024/1024/512, batch 16, f32, Adam lr 1e-4) on synthetic molecules
through ``run_finetune`` — first the prediction path
(``finetune.n_epochs=0``), then training (``finetune.n_epochs=3``), then
data-parallel and edge-partitioned training on torch.distributed (two
ranks sharing the card over gloo, and one rank over NCCL) — and geometric
pretraining (configs/pt/unimol.yaml, full width: 4 layers, emb
128, 4 heads, drop 0.2, Adam lr 1e-4, f32) through ``run_pretrain`` and
the packed transport. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. featurize the esol-config dataset (host);
  4. each kernel against its plain version on the card, at every level it
     serves, with tensors captured from layer 0 of a real esol-config batch
     (the backward kernels get the forward kernel's out, m, den and a
     cotangent drawn with numpy from a fixed seed): max abs and relative
     diff of every output (limit 1e-4 of the output's scale; for a
     backward output at least max|s|, see _scale_floor), the kernel's
     and the plain version's ms (CUDA events around each wrapper call,
     median of 50 after warm-up — host dispatch included), their device
     time per call (torch.profiler's CUDA activity over 50 calls, the
     wrapper's output fills included) and the bytes/operations bound.
     The fconn level is checked a second time with seeded node features
     and edge attributes (seeded_fconn_call), each output against its own
     scale; the TCSR backward's level also times the torch ops that do the
     rest of the TPU kernel's work (k2_outside_fn);
  5. the prediction path: run_finetune on cuda with every launch count set
     to 0 just before it; each forward kernel must have launched layers ×
     batches × 2 times (two levels each per layer) and no backward kernel,
     which also shows no GAT pass took the segment path (that path raises
     on CUDA tensors); then a second pass over the test batches times
     padding, copy and forward, and the profiler gives one forward's device
     busy time and top ops;
  6. the whole forward on the CPU (plain versions) and on the card
     (kernels) with the same weights and batch: predictions within 1e-3 of
     their scale, finite, of shape (G, n_tasks);
  7. the training path: run_finetune on cuda for 3 epochs with every launch
     count set to 0 just before it; every epoch's train loss and the test
     RMSE must be finite, the dense backward kernel must have launched
     layers × 2 × train steps times and each forward kernel layers × 2 × (train
     steps + epochs × val batches + test batches), counted from the
     loaders' lengths — except the TCSR backward, which runs for the frag
     level of the last layer only, (layers + 1) × train steps (see the
     phase); prints each epoch's message-edges/s;
  8. one train step (Adam) timed on the host clock and traced by the
     profiler: device busy time and top ops;
  9. one train step's loss and gradients on the CPU (plain versions) and on
     the card (kernels), same carried weights and batch, dropout off: loss
     and every parameter's gradient within 1e-3 of its scale;
 10. the plane builder (K6) against its plain version, the host builder
     and the library call (zeros + accumulating index_put_), exactly, at
     the bond (R=1), fconn (R=6) and atom (R=0) levels of one batch at the
     config's batch_size 512 (the 256 pretrain graphs, featurized in
     spawned processes beside phases 3-9, repeated to 512), timed as in
     phase 4, with the library call's time;
 11. the pretraining path: run_pretrain on cuda, uncached, 256 synthetic
     molecules at batch 64 (so that each epoch has >= 3 train steps), 3
     epochs validated every epoch; it must report the HBM packed tier, its
     train and val losses must be finite and each kernel's launches must
     equal the count derived from the loaders (pretrain_expect);
 12. the process-stream tier (no packed cache fits) for one epoch: the
     spawned workers' batches drive the same counts;
 13. one pretrain train step at batch 512 from a packed buffer on the
     card: wall time, stages each ended by a synchronize (unpack without
     planes, K6 planes, forward + loss, backward, Adam), device busy time,
     top ops and K6's share; then the TCSR forward and backward (K1, K2:
     atom and frag) and the dense forward and backward (K4, K5: bond and
     fconn) against their plain versions at this step's layer-0 inputs,
     checked and timed as in phase 4 (their levels tagged "batch 512" in
     the kernels' line);
 14. one pretrain step's loss and gradients, card (packed buffer decoded
     there, K6 planes) vs CPU (host batch, host planes), same weights (the
     run's checkpoint), dropout off: within 1e-3 of each scale;
 15. run_finetune with pretrain.use on the run's checkpoint: every encoder
     tensor of the finetune model equals the checkpoint's;
 16. the dense-attr kernels (K7 forward, K8 backward, K9 emit) against
     their plain versions, as in phase 4, with tensors captured from layer
     0 of the esol batch under the dense-attr policy
     (``finetune.kernel.attr=true finetune.kernel.fc=attr``) at the atom
     (self-loops), fconn (the first tn rows of the R = 6 planes, a strided
     view) and frag levels, plus a seeded case per level (numpy wd, ws, nf
     and w_ea), and from layer 0 of the batch-512 pretraining batch of
     phase 13 under the same policy (K6 planes; levels tagged "batch
     512"); K9 is held to equality and timed beside the library call
     (one advanced-indexing gather on indices computed beforehand);
 17. the finetune training path under the dense-attr policy: run_finetune
     on cuda for 3 epochs, every launch count set to 0 just before it;
     losses and test RMSE finite, each kernel's launches equal to the count
     derived from the loaders' batches and the planes each carries
     (expected_launches: K7 three passes per layer, K4 the bond pass, K8 and
     K9 every atom and fconn pass and the last layer's frag pass, K1 and K2
     none when every batch has its planes);
 18. one train step under the dense-attr policy: loss and every gradient,
     card (kernels) vs CPU (plain versions), within 1e-3 of each scale, and
     its wall time, device busy time and per-kernel device time beside the
     default policy's step of phase 8;
 19. the pretraining path under the dense-attr policy: run_pretrain on the
     HBM packed tier for one epoch, K6 once per train step for each plane
     level of the layout the policy reads (4 when dp_bond, dp_fc, dp_atom
     and dp_frag all pass dp_level_ok), K7-K9 as derived; one train step
     at batch 512 timed and profiled as in phase 13; then one pretrain
     step's gradients, card (K6 planes) vs CPU (host planes), within 1e-3;
 20. K3 (the edge-partitioned forward and backward) against its plain
     versions, as in phase 4, on each of two shards' layer-0 inputs at the
     bond, atom, fconn and frag levels (captured in the ranks of phase 22's
     step from the smoke's first train batch under run_finetune's EP spec,
     tn 128, te 256), plus a seeded case per level (numpy wn, nf, w_ea);
     the backward gets the forward's max as m and numpy cotangents dU, dV
     (limit 1e-4 of each output's scale, at least max|dV|);
 21. the edge-partitioned finetune path: run_finetune with dist.mode=ep
     over 2 ranks spawned on the one card (gloo) for 3 epochs; in every
     rank the losses and test RMSE are finite and equal to the other's,
     and the launches equal the count derived from its loaders (ep_expect:
     K3's forward 4 × layers per forward, its backward 3 × layers + 1 per
     train step, nothing else);
 22. one EP train step on 2 ranks (carried weights, dropout off) against
     the single-device card step on the same batch (TCSR metadata, K1/K2):
     loss, prediction, the four attention vectors and every averaged
     gradient within 1e-3 of each scale; each rank's step wall time,
     device busy time, K3 device time and the collectives' host time
     beside phase 8's single-device step;
 23. the data-parallel finetune path: dist.mode=dp over 2 ranks (gloo) for
     3 epochs, as phase 21, each rank's K1, K2, K4, K5 launches derived
     from its micro-batches (dp_expect); one DP step's averaged gradients
     against the mean of the two micro-batches' single-device card
     gradients, within 1e-3;
 24. both modes for one epoch as one rank over NCCL (the backend checked),
     launch counts derived as in phases 21 and 23.

Prints a ``{"kernels": [...]}`` JSON line (launches from the pretraining
path of phase 11 for K1-K6, of phase 19 for K7-K9 and of phase 21's rank 0
for K3, every path's — each rank's for phases 21, 23 and 24 — beside
them), and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero on any failure, without a CUDA device, or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import atexit
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

REPO = os.path.dirname(os.path.abspath(__file__))

# configs/ft/esol.yaml as a dict (the card's machine may have no PyYAML);
# tests/test_torch_model.py holds it equal to load_config of the file
ESOL_CONFIG = {
    "seed": 42,
    "exp_dir": "exps/ft/esol",
    "model_version": "gat2",
    "atom_features": 167,
    "frag_features": 167,
    "edge_features": 17,
    "fedge_in": 6,
    "fbond_edge_in": 6,
    "pretrain": {"use": False, "chk": None},
    "finetune": {
        "data": {"name": "esol", "path": None, "split": "scaffold",
                 "frag_type": "brics", "n_synthetic": 512},
        "model": {"num_layer": 4, "num_heads": 4, "drop_ratio": 0.1,
                  "emb_dim": 128, "h1": 128, "h2": 1024, "h3": 1024,
                  "h4": 512, "act": "relu", "fthead": "FTHead3"},
        "target_type": "regr",
        "batch_size": 16,
        "lr": 1.0e-4,
        "n_epochs": 100,
        "es_patience": 100,
        "use_schedular": False,
        "chkpoint_name": "ft.ckpt",
    },
}

# the smoke's overrides of ESOL_CONFIG (dotted path → value): the
# prediction path, and on top of it the training path
SMOKE_OVERRIDES = {
    "finetune.n_epochs": 0,
    "finetune.data.n_synthetic": 96,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol"),
}
TRAIN_OVERRIDES = {
    "finetune.n_epochs": 3,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol_train"),
}

# configs/pt/unimol.yaml as a dict; tests/test_torch_pretrain.py holds it
# equal to load_config of the file
PT_CONFIG = {
    "seed": 42,
    "exp_dir": "exps/pt/unimol",
    "data_type": "exp1s",
    "atom_features": 167,
    "frag_features": 167,
    "edge_features": 17,
    "fedge_in": 6,
    "fbond_edge_in": 6,
    "pretrain": {
        "model_version": "gat2",
        "data_dir": None,
        "n_synthetic": 256,
        "num_conf": 1,
        "model": {"num_layer": 4, "num_heads": 4, "drop_ratio": 0.2,
                  "emb_dim": 128},
        "batch_size": 512,
        "lr": 1.0e-4,
        "n_epochs": 100,
        "es_patience": 200,
        "val_every": 5,
        "optimizer": "adam",
        "compat_loss_overwrite": False,
        "saved_checkpoint": None,
        "chkpoint_name": "pt.ckpt",
    },
}
# the pretraining path's overrides: uncached (so the packed transport runs),
# batch 64 instead of 512 so that 256 molecules give >= 3 train steps per
# epoch, 3 epochs validated every epoch
PT_OVERRIDES = {
    "pretrain.cache": "off",
    "pretrain.batch_size": 64,
    "pretrain.n_epochs": 3,
    "pretrain.val_every": 1,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt"),
}
# on top of PT_OVERRIDES: no packed cache fits, so the spawned workers pack
# every epoch (the process-stream tier), for one epoch
STREAM_OVERRIDES = {
    "pretrain.hbm_cache_gb": 0,
    "pretrain.host_cache_gb": 0,
    "pretrain.n_epochs": 1,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt_stream"),
}

# the dense-attr kernel policy: K7-K9 carry the atom, frag and fconn passes
# (dotted keys of ESOL_CONFIG / PT_CONFIG under finetune. / pretrain.)
ATTR_KERNEL = {"kernel.attr": True, "kernel.fc": "attr"}
ATTR_TRAIN_OVERRIDES = {
    **{f"finetune.{k}": v for k, v in ATTR_KERNEL.items()},
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol_attr"),
}
# on top of PT_OVERRIDES: the pretraining path under the same policy, one
# epoch
ATTR_PT_OVERRIDES = {
    **{f"pretrain.{k}": v for k, v in ATTR_KERNEL.items()},
    "pretrain.n_epochs": 1,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt_attr"),
}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REL_LIMIT = 1e-4
FORWARD_REL_LIMIT = 1e-3
GRAD_REL_LIMIT = 1e-3


def smoke_opt(train: bool = False, attr: bool = False):
    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(ESOL_CONFIG))
    for k, v in {**SMOKE_OVERRIDES,
                 **(TRAIN_OVERRIDES if train else {}),
                 **(ATTR_TRAIN_OVERRIDES if attr else {})}.items():
        opt.set_path(k, v)
    return opt


def pt_opt(*overrides):
    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(PT_CONFIG))
    for ov in overrides:
        for k, v in ov.items():
            opt.set_path(k, v)
    return opt


def _pt_chunk(args):
    """Featurize one chunk of pretrain SMILES (a spawned pool's task)."""
    from fragnet_tpu_torch.data.datasets import PretrainData

    smiles, data_type, num_conf, seed = args
    return PretrainData(data_type=data_type, num_conf=num_conf
                        ).get_pt_dataset(smiles, seed=seed)


class PretrainGraphs:
    """``train.pretrain.load_pretrain_graphs(opt)`` for the synthetic set,
    featurized in ``workers`` spawned processes while the caller goes on
    (each molecule is featurized alone from the same seed, so the graphs
    and their order are the same); ``get()`` waits for them."""

    def __init__(self, opt, workers: int):
        import multiprocessing as mp

        from fragnet_tpu_torch.data.synthetic import synthetic_dataset

        seed = int(opt.seed)
        smiles = list(synthetic_dataset(n=int(opt.pretrain.n_synthetic),
                                        task="regression",
                                        seed=seed)["smiles"])
        step = (len(smiles) + workers - 1) // workers
        jobs = [(smiles[i:i + step], opt.data_type,
                 int(opt.pretrain.num_conf), seed)
                for i in range(0, len(smiles), step)]
        self.t0 = time.perf_counter()
        self.workers = len(jobs)
        self._pool = mp.get_context("spawn").Pool(len(jobs))
        self._res = self._pool.map_async(_pt_chunk, jobs)

    def close(self):
        """Stop the featurizing processes (after ``get`` they are gone)."""
        self._pool.terminate()
        self._pool.join()

    def get(self):
        try:
            parts = self._res.get(timeout=600)
        except BaseException:
            self._pool.terminate()
            raise
        finally:
            self._pool.close()
            self._pool.join()
        return [g for part in parts for g in part]


def _median_ms(fn, n: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, n: int = 50) -> float:
    """Device time per call: the summed time of the CUDA activity that
    torch.profiler (CUPTI) records over ``n`` calls, divided by ``n``; it
    leaves out the host's dispatch time that the event timing includes.
    0.0 when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / n


def _diff(k, p, floor: float = 0.0):
    """(max abs diff, max abs diff / max(max|plain|, floor)) over entries
    that are not the −1e30 empty-row marker; the markers must agree
    exactly."""
    import torch

    k, p = k.float(), p.float()
    marker = p <= -1e29
    if not torch.equal(k <= -1e29, marker):
        raise AssertionError("empty-row markers (m = -1e30) disagree")
    k, p = k[~marker], p[~marker]
    if not bool(torch.isfinite(k).all()):
        raise AssertionError("kernel output is not finite")
    if k.numel() == 0:
        return 0.0, 0.0
    err = float((k - p).abs().max())
    return err, err / max(float(p.abs().max()), floor, 1e-30)


def _scale_floor(name, args) -> float:
    """The scale below which a backward output is round-off: max|s| (for
    K3's backward s = −dV). The logit-gradient outputs (d_wd, d_ws, d_vc;
    d_wn, d_w_ea) are sums of p·(d_p − s), which cancel exactly where a
    row's neighbours carry equal features — as at the fconn level of the
    smoke's batch, at every layer — leaving round-off of terms of size |s|.
    0 for a forward kernel."""
    idx = {"tcsr_gat_bwd": 10, "dense_gat_bwd": 8,
           "dense_attr_bwd": 12, "tcsr_gat_ep_bwd": 10}.get(name)
    return 0.0 if idx is None else float(args[idx].abs().max())


class _Capture:
    """Records the arguments of every kernel-wrapper call of one forward
    (the wrappers are looked up through their modules at call time)."""

    def __init__(self, names):
        from fragnet_tpu_torch.ops import dense_gat, tcsr_gat

        mods = {"tcsr_gat_fwd": tcsr_gat, "dense_gat_fwd": dense_gat,
                "dense_attr_fwd": dense_gat}
        self.mods = {n: mods[n] for n in names}
        self.calls = {k: [] for k in self.mods}
        self._orig = {}

    def __enter__(self):
        for name, mod in self.mods.items():
            orig = getattr(mod, name)
            self._orig[name] = orig

            def rec(*args, _orig=orig, _name=name, **kw):
                self.calls[_name].append((args, kw))
                return _orig(*args, **kw)

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self._orig[name])


# each forward kernel's levels in the order of one layer's calls
LEVELS = {"tcsr_gat_fwd": ["atom (self-loops)", "frag"],
          "dense_gat_fwd": ["bond (R=1)", "fconn (R=6)"],
          "dense_attr_fwd": ["atom (self-loops)",
                             "fconn (rows 0..tn of the R=6 planes)", "frag"]}
# a level checked against the plain version but not timed
SEEDED = "fconn (R=6), seeded nf and attrs"


def smoke_batch(opt, datasets):
    """(spec, the test split's batch windows, the first test batch as
    numpy) — what run_finetune builds for the same datasets."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for

    train_g, val_g, test_g, n_tasks, _task = datasets
    bs = int(opt.finetune.batch_size)
    spec = spec_for(train_g + val_g + test_g, batch_size=bs, tcsr=True)
    windows = list(BatchLoader(test_g, bs, spec=spec,
                               n_tasks=n_tasks)._windows())
    return spec, windows, pad_batch(windows[0], spec, n_tasks=n_tasks)


def layer0_kernel_calls(n_layers: int, model, batch,
                        names=("tcsr_gat_fwd", "dense_gat_fwd")):
    """{kernel: [(level, args, kwargs), ...]}: the calls of each of the
    ``names`` forward wrappers in layer 0 of one forward of ``model`` (of
    ``n_layers`` layers) on ``batch``."""
    import torch

    with _Capture(names) as cap, torch.no_grad():
        model(batch)
    out = {}
    for name, calls in cap.calls.items():
        per_layer = len(LEVELS[name])
        if len(calls) != per_layer * n_layers:
            raise AssertionError(f"{name}: {len(calls)} calls in one forward")
        out[name] = [(lvl, a, kw) for lvl, (a, kw)
                     in zip(LEVELS[name], calls[:per_layer])]
    return out


def seeded_fconn_call(fconn_call, rng):
    """The fconn forward call with its node features and its attribute
    planes 1..R (at the plane-0 edges) drawn with numpy. In the smoke's
    batch each fconn row's neighbours carry equal features and only plane 1
    is nonzero, so there the backward's d_wd, d_ws and d_vc are round-off
    and the forward's rank terms r >= 1 are never read; here all of them are
    of the order of their inputs."""
    import numpy as np
    import torch

    _lvl, args, kw = fconn_call
    planes, wd, ws, nf, vc = args[:5]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    pl = planes.view(T, R + 1, tn, tn)
    attrs = torch.from_numpy(rng.standard_normal((T, R, tn, tn)).astype(
        np.float32)).to(planes.device)
    attrs = torch.where(pl[:, :1] > 0, attrs, torch.zeros_like(attrs))
    planes_s = torch.cat([pl[:, :1], attrs], dim=1).reshape(T, rows, tn)
    nf_s = torch.from_numpy(rng.standard_normal(tuple(nf.shape)).astype(
        np.float32)).to(nf.device)
    return (SEEDED, (planes_s.contiguous(), wd, ws, nf_s, vc) + tuple(args[5:]),
            kw)


def seeded_attr_call(call, rng):
    """A captured dense-attr forward call with its logit terms wd, ws, the
    node features and w_ea drawn with numpy (the adjacency, the edges and
    the windows kept): every output of K7-K9 is then of the order of its
    inputs, whatever the smoke's features make cancel."""
    import numpy as np
    import torch

    lvl, args, kw = call
    drawn = tuple(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)).to(t.device) for t in args[1:5])
    return (f"{lvl}, seeded", (args[0],) + drawn + tuple(args[5:]), kw)


def k2_outside_fn(args, rng):
    """A callable that runs, at the shapes of one TCSR backward call, the
    part of the TPU backward kernel's work (pallas_gat.py:290-309: d_a_src
    and the a_src term of d_nf) that the port leaves to autograd: the
    transpose of the prologue's w_src = nf·a_src (ops/tcsr_gat.py:
    prologue), given d_w_src = d_wn[:, H:]. Values are drawn with numpy;
    the work does not depend on them."""
    import numpy as np
    import torch

    wn, nf = args[:2]
    N, HD = nf.shape
    H = wn.shape[1] // 2

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(nf.device)

    nf3 = nf.detach().view(N, H, HD // H).clone().requires_grad_()
    a_src = draw(H, HD // H).requires_grad_()
    w_src = torch.einsum("nhd,hd->nh", nf3, a_src)
    d_w_src = draw(N, H)
    return lambda: torch.autograd.grad(w_src, (nf3, a_src), d_w_src,
                                       retain_graph=True)


def _tcsr_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, self_loops = args[:8]
    N, HD = nf.shape
    H = wn.shape[1] // 2
    D = HD // H
    n_edges = int((emask > 0).sum())
    n_tiles = meta.ew_blk.shape[0]
    # inputs read once (node arrays, the real edges' scalars, tile windows)
    # + outputs written once
    nbytes = 4 * (N * (2 * H + HD) + n_edges * (H + 3) + 2 * n_tiles
                  + N * (HD + 2 * H))
    flops = n_edges * H * (2 * D + 6) + N * HD
    return nbytes, flops


def _dense_cost(args):
    planes, wd, ws, nf, vc = args[:5]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    nnz = int((planes.view(T, R + 1, tn, tn)[:, 0] > 0).sum())
    # inputs read once: the adjacency planes, the nonzeros' R attribute
    # values (the attribute planes hold nothing else), wd, ws, nf, vc;
    # outputs written once: out, m, den. Work at the nonzeros only
    nbytes = 4 * (T * tn * tn + nnz * R + 2 * N * H + N * HD + vc.numel()
                  + N * (HD + 2 * H))
    flops = nnz * H * (2 * R + 4) + 2 * nnz * HD
    return nbytes, flops


def _tcsr_bwd_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, m, den, g, s, self_loops = args[:12]
    N, HD = nf.shape
    H = wn.shape[1] // 2
    D = HD // H
    E = src.shape[0]
    n_edges = int((emask > 0).sum())
    n_tiles = meta.ew_blk.shape[0]
    # inputs read once (node arrays, m/den/s, g, the real edges' scalars,
    # tile windows) + outputs written once (d_wn, d_nf, d_w_ea)
    nbytes = 4 * (N * (2 * H + HD) + 3 * N * H + N * HD + n_edges * (H + 3)
                  + 2 * n_tiles + N * (2 * H + HD) + E * H)
    items = n_edges + (N if self_loops else 0)
    flops = items * H * (4 * D + 10)
    return nbytes, flops


def _ep_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, rank = args[:8]
    HD = nf.shape[1]
    H = wn.shape[1] // 2
    D = HD // H
    Tg = meta.n_tiles_grid
    Ng = Tg * meta.tn
    n_edges = int((emask > 0).sum())
    # as _tcsr_cost over the shard's kept edges and its Ng grid rows: the
    # grid's node arrays, the edges' scalars and the windows read once, the
    # grid's out, m, den written once
    nbytes = 4 * (Ng * (2 * H + HD) + n_edges * (H + 3) + 2 * Tg
                  + Ng * (HD + 2 * H))
    flops = n_edges * H * (2 * D + 6) + Ng * HD
    return nbytes, flops


def _ep_bwd_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, rank, m, dU, dV = args[:11]
    HD = nf.shape[1]
    H = wn.shape[1] // 2
    D = HD // H
    Es = src.shape[0]
    Tg = meta.n_tiles_grid
    Ng = Tg * meta.tn
    n_edges = int((emask > 0).sum())
    # as _tcsr_bwd_cost over the shard's kept edges and its grid rows
    nbytes = 4 * (Ng * (2 * H + HD) + 3 * Ng * H + Ng * HD
                  + n_edges * (H + 3) + 2 * Tg + Ng * (2 * H + HD) + Es * H)
    flops = n_edges * H * (4 * D + 10)
    return nbytes, flops


def _dense_bwd_cost(args):
    planes, wd, ws, nf, vc, m, den, g, s = args[:9]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    D = HD // H
    nnz = int((planes.view(T, R + 1, tn, tn)[:, 0] > 0).sum())
    # inputs read once: the adjacency planes, the nonzeros' R attribute
    # values, wd, ws, m, den, s, nf, g, vc; outputs written once: d_wd,
    # d_ws, d_nf, d_vc. Work at the nonzeros only
    nbytes = 4 * (T * tn * tn + nnz * R + 5 * N * H + 2 * N * HD
                  + vc.numel() + 2 * N * H + N * HD + vc.numel())
    flops = nnz * H * (4 * D + 2 * R + 6)
    return nbytes, flops


def _attr_cost(args):
    adj, wd, ws, nf, w_ea, src, dst, emask, meta, self_loops = args[:10]
    T, tn, _ = adj.shape
    N, H = wd.shape
    HD = nf.shape[1]
    nnz = int((adj > 0).sum())
    n_edges = int((emask > 0).sum())
    # the adjacency planes, wd, ws, nf, the real edges' w_ea and scalars and
    # the tile windows read once; out, m, den written once
    nbytes = 4 * (T * tn * tn + 2 * N * H + N * HD + n_edges * (H + 3)
                  + 2 * T + N * (HD + 2 * H))
    flops = (T * tn * tn * H * 5 + 2 * nnz * HD
             + (2 * N * HD if self_loops else 0))
    return nbytes, flops


def _attr_bwd_cost(args):
    (adj, wd, ws, nf, w_ea, src, dst, emask, meta, m, den, g, s,
     self_loops) = args[:14]
    T, tn, _ = adj.shape
    N, H = wd.shape
    HD = nf.shape[1]
    D = HD // H
    nnz = int((adj > 0).sum())
    n_edges = int((emask > 0).sum())
    # inputs read once (adjacency, wd, ws, m, den, s, nf, g, the real
    # edges' w_ea and scalars, windows) + outputs written once (d_wd, d_ws,
    # d_wself, d_nf, the d_zpre planes)
    nbytes = 4 * (T * tn * tn + 5 * N * H + 2 * N * HD + n_edges * (H + 3)
                  + 2 * T + 3 * N * H + N * HD + T * H * tn * tn)
    flops = (T * tn * tn * H * 6 + nnz * H * (4 * D + 6)
             + (N * H * (4 * D + 10) if self_loops else 0))
    return nbytes, flops


def _emit_cost(args):
    dz, src, dst, emask, meta = args[:5]
    T, Htn, tn = dz.shape
    H = Htn // tn
    E = src.shape[0]
    n_kept = int(_emit_index(args)[0].shape[0])
    # every edge's src, dst and mask read, the counted edges' H plane values
    # read, (E, H) written; one product per counted value
    nbytes = 4 * (3 * E + 2 * T + n_kept * H + E * H)
    return nbytes, n_kept * H


def _emit_index(args):
    from fragnet_tpu_torch.ops.dense_gat import _plane_edges

    dz, src, dst, emask, meta = args[:5]
    return _plane_edges(src, dst, emask, dz.shape[0] * dz.shape[2], meta)


def emit_library_fn(args):
    """K9's yardstick: one advanced-indexing gather of the d_zpre planes at
    the counted edges' slots, on indices computed beforehand (used nowhere
    in the port). Returns (callable, edge ids) — the gather's rows are
    d_wea[ids] / emask[ids]."""
    dz = args[0]
    T, Htn, tn = dz.shape
    k, t, di, sj = _emit_index(args)
    planes = dz.view(T, Htn // tn, tn, tn)
    return (lambda: planes[t, :, di, sj]), k


def _planes_cost(args):
    src, dst, emask, ea, n_nodes, meta = args[:6]
    R = 0 if ea is None else ea.shape[1]
    n_edges = int((emask > 0).sum())
    # the planes written once + the kept edges' src, dst, mask and attrs
    # read once + the tile windows; one add per plane value
    nbytes = 4 * (n_nodes * (R + 1) * meta.tn + n_edges * (3 + R)
                  + 2 * meta.ew_blk.shape[0])
    return nbytes, n_edges * (R + 1)


def _bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


class Kernel(NamedTuple):
    module: str              # fragnet_tpu_torch.ops module of the wrapper
    counter: str             # its CudaKernel attribute (launch counter)
    plain: str               # the plain version's name in that module
    cost: Callable           # args -> (bytes, flops)
    fwd: Optional[str]       # the forward kernel this is the backward of
    source: str
    replaces: str            # the TPU kernel, file:line


# every kernel of the path, by wrapper name
KERNELS = {
    "tcsr_gat_fwd": Kernel("tcsr_gat", "KERNEL", "tcsr_gat_fwd_plain",
                           _tcsr_cost, None,
                           "fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                           "fragnet_tpu/ops/pallas_gat.py:105"),
    "tcsr_gat_bwd": Kernel("tcsr_gat", "KERNEL_BWD", "tcsr_gat_bwd_plain",
                           _tcsr_bwd_cost, "tcsr_gat_fwd",
                           "fragnet_tpu_torch/csrc/tcsr_gat_bwd.cu",
                           "fragnet_tpu/ops/pallas_gat.py:199"),
    "dense_gat_fwd": Kernel("dense_gat", "KERNEL", "dense_gat_fwd_plain",
                            _dense_cost, None,
                            "fragnet_tpu_torch/csrc/dense_gat_fwd.cu",
                            "fragnet_tpu/ops/dense_gat.py:387"),
    "dense_gat_bwd": Kernel("dense_gat", "KERNEL_BWD", "dense_gat_bwd_plain",
                            _dense_bwd_cost, "dense_gat_fwd",
                            "fragnet_tpu_torch/csrc/dense_gat_bwd.cu",
                            "fragnet_tpu/ops/dense_gat.py:419"),
    "build_dense_planes_device": Kernel(
        "dense_gat", "KERNEL_PLANES", "build_dense_planes_device_plain",
        _planes_cost, None, "fragnet_tpu_torch/csrc/dense_planes.cu",
        "fragnet_tpu/ops/dense_gat.py:105"),
    "dense_attr_fwd": Kernel("dense_gat", "KERNEL_ATTR",
                             "dense_attr_fwd_plain", _attr_cost, None,
                             "fragnet_tpu_torch/csrc/dense_attr_fwd.cu",
                             "fragnet_tpu/ops/dense_gat.py:216"),
    "dense_attr_bwd": Kernel("dense_gat", "KERNEL_ATTR_BWD",
                             "dense_attr_bwd_plain", _attr_bwd_cost,
                             "dense_attr_fwd",
                             "fragnet_tpu_torch/csrc/dense_attr_bwd.cu",
                             "fragnet_tpu/ops/dense_gat.py:276"),
    "dense_attr_emit": Kernel("dense_gat", "KERNEL_ATTR_EMIT",
                              "dense_attr_emit_plain", _emit_cost,
                              "dense_attr_fwd",
                              "fragnet_tpu_torch/csrc/dense_attr_emit.cu",
                              "fragnet_tpu/ops/dense_gat.py:359"),
    "tcsr_gat_ep_fwd": Kernel("tcsr_gat", "KERNEL_EP",
                              "tcsr_gat_ep_fwd_plain", _ep_cost, None,
                              "fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                              "fragnet_tpu/ops/pallas_gat.py:635"),
    "tcsr_gat_ep_bwd": Kernel("tcsr_gat", "KERNEL_EP_BWD",
                              "tcsr_gat_ep_bwd_plain", _ep_bwd_cost,
                              "tcsr_gat_ep_fwd",
                              "fragnet_tpu_torch/csrc/tcsr_gat_bwd.cu",
                              "fragnet_tpu/ops/pallas_gat.py:635"),
}
# the GAT kernels of the default policy, which phase 4 captures from a
# finetune forward, and the dense-attr kernels, which phase 16 captures
GAT_KERNELS = ("tcsr_gat_fwd", "tcsr_gat_bwd", "dense_gat_fwd",
               "dense_gat_bwd")
ATTR_KERNELS = ("dense_attr_fwd", "dense_attr_bwd", "dense_attr_emit")
EP_KERNELS = ("tcsr_gat_ep_fwd", "tcsr_gat_ep_bwd")
# layer 0's edge-partitioned passes, in call order
EP_LEVELS = ["bond", "atom (self-loops in the combine)", "fconn", "frag"]
EMIT = "dense_attr_emit"
PLANES = "build_dense_planes_device"
PLANE_LEVELS = {"dp_bond": "bond (R=1)", "dp_fc": "fconn (R=6)",
                "dp_atom": "atom (R=0)"}


def _counter(name):
    """(the wrapper's module, its CudaKernel with the launch count)."""
    from fragnet_tpu_torch.ops import dense_gat, tcsr_gat

    k = KERNELS[name]
    mod = {"tcsr_gat": tcsr_gat, "dense_gat": dense_gat}[k.module]
    return mod, getattr(mod, k.counter)


def _reset_launches():
    for name in KERNELS:
        _counter(name)[1].launches = 0


def _launches():
    return {name: _counter(name)[1].launches for name in KERNELS}


def bwd_kernel_args(fwd_name, args, kw, rng):
    """The backward wrapper's arguments for one captured forward call: the
    forward kernel's (out, m, den), a cotangent g of out drawn with numpy
    and s = Σ_d g·out, spliced in before the flags as the wrappers take
    them."""
    import numpy as np
    import torch

    mod, _ = _counter(fwd_name)
    out, m, den = getattr(mod, fwd_name)(*args, **kw)
    N, HD = out.shape
    H = m.shape[1]
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32)
                         ).to(out.device)
    s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
    k = {"tcsr_gat_fwd": 7, "dense_gat_fwd": 5, "dense_attr_fwd": 9}[fwd_name]
    return tuple(args[:k]) + (m, den, g, s) + tuple(args[k:])


def _planes_of(batch):
    """The dense-plane levels a (host or device) batch carries."""
    return {lvl for lvl in ("dp_bond", "dp_fc", "dp_atom", "dp_frag")
            if getattr(batch, lvl) is not None}


def expected_launches(policy, n_layers: int, batches):
    """Each GAT kernel's launches for ``batches`` = [(plane levels the
    batch carries, forwards, train steps)] under a KernelPolicy: per
    forward each layer runs the bond, fconn, atom and frag passes, each
    through the dense kernel its policy names when the batch has that
    level's planes, else through the TCSR kernel (model/layers.py:
    _gat_dispatch); per train step the backward of every layer's bond,
    fconn and atom pass and of the last layer's frag pass (each layer
    recomputes fragment features from atoms, so the earlier frag outputs
    are off the loss's path). The plane builder is counted by the caller."""
    mode = {"dp_bond": policy.bond, "dp_fc": policy.fc,
            "dp_atom": "attr" if policy.attr else "tcsr",
            "dp_frag": "attr" if policy.attr else "tcsr"}
    bwd_passes = {"dp_bond": n_layers, "dp_fc": n_layers,
                  "dp_atom": n_layers, "dp_frag": 1}
    kernels = {"planes": ("dense_gat_fwd", ("dense_gat_bwd",)),
               "attr": ("dense_attr_fwd", ("dense_attr_bwd",
                                           "dense_attr_emit")),
               "tcsr": ("tcsr_gat_fwd", ("tcsr_gat_bwd",))}
    out = {n: 0 for n in KERNELS}
    for have, n_fwd, n_steps in batches:
        for lvl, m in mode.items():
            fwd, bwds = kernels[m if lvl in have else "tcsr"]
            out[fwd] += n_layers * n_fwd
            for b in bwds:
                out[b] += bwd_passes[lvl] * n_steps
    return out


def _outputs(r):
    return r if isinstance(r, tuple) else (r,)


def check_kernels(names, calls, rng, check_scales=None):
    """Phases 4 and 16: each kernel in ``names`` against its plain version
    on the card at every captured level of ``calls`` ({kernel: [(level,
    args, kwargs)]}): max abs and relative diff of every output (limit 1e-4
    of the output's scale, for a backward output at least max|s|; the emit
    kernel, a gather, exactly), and for a level that is not a seeded case
    the wrapper's and the plain version's ms and device ms, the bound, and
    the torch ops around K2 / the library call beside K9. A seeded level
    holds each output to its own scale and is not timed. ``check_scales``
    (name, level, args, kernel outputs, plain outputs), where given, vets
    every case's data. Returns {kernel: (per-level report, worst seeded max
    abs err)}."""
    import torch

    report = {}
    for name in names:
        k = KERNELS[name]
        mod, _ = _counter(name)
        wrapper, plain = getattr(mod, name), getattr(mod, k.plain)
        limit = 0.0 if name == EMIT else REL_LIMIT
        per_level, seeded_err = [], 0.0
        for lvl, args, kw in calls[name]:
            got = _outputs(wrapper(*args, **kw))
            want = _outputs(plain(*args, **kw))
            torch.cuda.synchronize()
            if check_scales is not None:
                check_scales(name, lvl, args, got, want)
            seeded = "seeded" in lvl
            floor = 0.0 if seeded else _scale_floor(name, args)
            errs = [_diff(k_, p, floor) for k_, p in zip(got, want)]
            err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            scales = ", ".join(f"{float(p.abs().max()):.2e}" for p in want)
            if seeded:
                print(f"{name} [{lvl}]: max_abs_err={err:.3e} rel={rel:.3e} "
                      f"(worst of {len(errs)} outputs; output scales "
                      f"{scales}; limit {limit})")
                if rel > limit:
                    raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                         f"plain version: rel {rel:.3e}")
                seeded_err = max(seeded_err, err)
                continue
            ms = _median_ms(lambda: wrapper(*args, **kw))
            plain_ms = _median_ms(lambda: plain(*args, **kw))
            dev_ms = _device_ms(lambda: wrapper(*args, **kw))
            plain_dev_ms = _device_ms(lambda: plain(*args, **kw))
            nbytes, flops = k.cost(args)
            bound, by = _bound_ms(nbytes, flops)
            extra = {}
            if name == "tcsr_gat_bwd":
                extra["outside_device_ms"] = _device_ms(
                    k2_outside_fn(args, rng))
            if name == EMIT:
                lib, ids = emit_library_fn(args)
                if not torch.equal(lib() * args[3][ids, None], got[0][ids]):
                    raise AssertionError(f"{name} [{lvl}]: the library "
                                         f"gather disagrees")
                extra["library_ms"] = _median_ms(lib)
                extra["library_device_ms"] = _device_ms(lib)
            shape = "x".join(str(s) for s in args[0].shape)
            print(f"{name} [{lvl}] in0={shape}: max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (worst of {len(errs)} outputs; output "
                  f"scales {scales}; limit {limit}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} device_ms={dev_ms:.4f} "
                  f"plain_device_ms={plain_dev_ms:.4f} "
                  f"bound_ms={bound:.5f} ({by}: {nbytes} B, {flops} flop)"
                  + "".join(f" {k_}={v:.4f}" for k_, v in extra.items()))
            if rel > limit:
                raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                     f"plain version: rel {rel:.3e}")
            per_level.append(dict(level=lvl, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                  plain_device_ms=plain_dev_ms,
                                  bound_ms=bound, bound_by=by, bytes=nbytes,
                                  flops=flops, **extra))
        report[name] = (per_level, seeded_err)
    return report


def _busy(prof):
    """(device busy ms, [(kernel, ms), ...] by device time) of a profile:
    the device-side kernel and copy rows only. A CPU op's self device time
    repeats the time of the kernels it launched (a ctypes launch inside an
    autograd Function, a GEMM under addmm), and a user annotation's device
    range (``Optimizer.step``) spans kernels listed on their own, so
    summing every row counts them twice."""
    from torch.autograd import DeviceType

    busy = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    busy.sort(key=lambda kv: -kv[1])
    return sum(ms for _, ms in busy), busy

def timed_train_step(model, train_np, dev, label: str):
    """Phases 8 and 18: one finetune train step (batch copy, forward,
    backward, Adam) of a copy of ``model`` on ``train_np``: wall time
    (median of 5 after a warm-up), one step's device busy time and each
    port kernel's device time under the profiler, and the step in stages
    each ended by a synchronize. Returns {wall, busy, kernels}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import make_train_step, mse_loss
    from fragnet_tpu_torch.train.optim import make_optimizer

    step_model = copy.deepcopy(model)
    step_opt, _ = make_optimizer(step_model.parameters(), "adam", lr=1e-4)
    step = make_train_step(step_model, step_opt, "mse", dev)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(train_np)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(train_np)
        torch.cuda.synchronize()
    dev_busy, busy = _busy(prof)
    wall = statistics.median(walls[1:])
    ours = {n: sum(ms for key, ms in busy if f"{n}_kernel" in key)
            for n in KERNELS}
    print(f"train step [{label} policy] (batch copy, forward, backward, "
          f"Adam): wall {wall:.2f} ms (median of 5 after warm-up), device "
          f"busy {dev_busy:.3f} ms ({100 * dev_busy / wall:.1f}%) in "
          f"{len(busy)} kernel kinds; the port's kernels: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in ours.items())
          + "; top: " + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:10]))
    # the same step in stages, each ended by a synchronize (host clock)
    stages = {"copy": [], "forward+loss": [], "backward": [], "adam": []}
    step_model.train()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = to_device(train_np, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = mse_loss(step_model(b), b.y, b.graph_mask)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step_opt.step()
        step_opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(dt * 1e3)
    print(f"train step stages [{label} policy] (host clock to a "
          f"synchronize, median of 5): "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms"
                      for k, v in stages.items()))
    return {"wall": wall, "busy": dev_busy, "kernels": ours}


def train_grads_card_vs_cpu(model, train_np, dev):
    """Phases 9 and 18: one train step's loss and every parameter's
    gradient of ``model`` on ``train_np``, on the card (kernels) and on the
    CPU (plain versions), dropout off. Returns (loss cpu, loss card, worst
    relative diff, its name, number of parameters)."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import mse_loss

    def loss_and_grads(d):
        m_d = copy.deepcopy(model).to(d).eval()  # dropout off
        b_d = to_device(train_np, d)
        loss = mse_loss(m_d(b_d), b_d.y, b_d.graph_mask)
        loss.backward()
        return float(loss.detach()), {
            n: (None if p.grad is None else p.grad.detach().cpu())
            for n, p in m_d.named_parameters()}

    l_gpu, g_gpu = loss_and_grads(dev)
    l_cpu, g_cpu = loss_and_grads(torch.device("cpu"))
    worst, worst_name = _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu)
    return l_cpu, l_gpu, worst, worst_name, len(g_cpu)


def plane_calls(graphs, batch_size: int, dev):
    """The plane builder's calls on one packed batch of ``batch_size``
    molecules (``graphs`` repeated as needed), decoded on the card: [(level,
    args, host planes)] for the bond (R=1), fconn (R=6) and atom (R=0)
    levels, with the host builder's planes of the same batch (pad_batch)."""
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import _DP_TM, unpack_batch
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for

    rep = graphs * (-(-batch_size // len(graphs)))
    spec = spec_for(rep, batch_size=batch_size, tcsr=True)
    loader = BatchLoader(rep, batch_size, spec=spec, with_targets=True,
                         pack=True)
    buf = next(iter(loader))
    host = pad_batch(next(loader._windows()), spec, with_targets=True)
    fields = unpack_batch(torch.from_numpy(buf).to(dev), loader.layout,
                          planes=())
    out = []
    for lvl, src_f, dst_f, mask_f, ea_f, n_nodes, _tn in loader.layout.dp_specs:
        if lvl in PLANE_LEVELS:
            args = (getattr(fields, src_f), getattr(fields, dst_f),
                    getattr(fields, mask_f),
                    getattr(fields, ea_f) if ea_f else None, n_nodes,
                    getattr(fields, _DP_TM[lvl]))
            out.append((PLANE_LEVELS[lvl], args, getattr(host, lvl)))
    if sorted(o[0] for o in out) != sorted(PLANE_LEVELS.values()):
        raise AssertionError(f"batch {batch_size}: device planes for "
                             f"{[o[0] for o in out]} only")
    return out, int(host.graph_mask.sum())


def planes_library_fn(args):
    """One PyTorch call's worth of the same function (zeros, then one
    accumulating index_put_ on indices computed beforehand) — the
    yardstick, used nowhere in the port."""
    import torch

    from fragnet_tpu_torch.ops.dense_gat import _plane_edges

    src, dst, emask, ea, n_nodes, meta = args
    tn = meta.tn
    R = 0 if ea is None else ea.shape[1]
    k, t, di, sj = _plane_edges(src, dst, emask, n_nodes, meta)
    vals = torch.ones((k.shape[0], R + 1), device=src.device)
    if R:
        vals[:, 1:] = ea[k]
    r = torch.arange(R + 1, device=src.device)[None, :]
    idx = (t[:, None], r, di[:, None], sj[:, None])
    shape = (n_nodes // tn, R + 1, tn, tn)
    return lambda: torch.zeros(shape, device=src.device).index_put_(
        idx, vals, accumulate=True).view(shape[0], (R + 1) * tn, tn)


def check_planes(calls):
    """Phase 10: the plane builder against its plain version and the host
    builder (exact), timed as phase 4 times the GAT kernels, with the
    library call's time. Returns the per-level report."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.ops import dense_gat

    k6 = dense_gat.build_dense_planes_device
    plain = dense_gat.build_dense_planes_device_plain
    per_level = []
    for lvl, args, host in calls:
        got, want = k6(*args), plain(*args)
        lib = planes_library_fn(args)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()),
                  float(np.abs(got.cpu().numpy() - host).max()),
                  float((lib() - got).abs().max()))
        ms = _median_ms(lambda: k6(*args))
        plain_ms = _median_ms(lambda: plain(*args))
        lib_ms = _median_ms(lib)
        dev_ms = _device_ms(lambda: k6(*args))
        plain_dev_ms = _device_ms(lambda: plain(*args))
        lib_dev_ms = _device_ms(lib)
        nbytes, flops = _planes_cost(args)
        bound, by = _bound_ms(nbytes, flops)
        print(f"{PLANES} [{lvl}] planes={'x'.join(map(str, got.shape))} "
              f"kept edges={int((args[2] > 0).sum())}: max_abs_err={err:.3e} "
              f"(vs plain, host builder and library call; limit 0) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"device_ms={dev_ms:.4f} plain_device_ms={plain_dev_ms:.4f} "
              f"library_device_ms={lib_dev_ms:.4f} bound_ms={bound:.5f} "
              f"({by}: {nbytes} B, {flops} flop)")
        if err != 0.0:
            raise AssertionError(f"{PLANES} [{lvl}] is not exact: {err}")
        per_level.append(dict(level=lvl, max_abs_err=err, rel_err=0.0, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                              library_device_ms=lib_dev_ms, bound_ms=bound,
                              bound_by=by, bytes=nbytes, flops=flops,
                              on_path=lvl != PLANE_LEVELS["dp_atom"]))
    return per_level


def pretrain_expect(popt, pgraphs, n_epochs: int, n_validations: int):
    """Each kernel's launches on ``run_pretrain``'s packed path under the
    run's kernel policy, derived from the loaders: the train steps are the
    first (shuffled) epoch's windows, replayed each epoch by the packed
    caches, and the process stream's epochs have the same count here (one
    epoch, from epoch 0's shuffle). A decoded train batch carries device
    planes for the levels of the layout's dp_specs that the policy reads,
    a validation batch its host planes (both checked here); every batch
    runs its passes as ``expected_launches`` counts them (the pretrain head
    reads x_atoms, the pooled x_frags of the last layer and the bond
    features e_edge, so the backward is that of finetuning). K6 runs only
    in train steps, once per plane level of the decoded batch: the
    validation batches come with host planes. Returns (counts, train steps
    per epoch, validation batches, the decoded batches' plane levels)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import plane_levels
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import split_graphs

    seed, bs = int(popt.seed), int(popt.pretrain.batch_size)
    L = int(popt.pretrain.model.num_layer)
    policy = resolve_kernel_policy(popt.pretrain)
    train_g, val_g = split_graphs(pgraphs, seed)
    spec = spec_for(pgraphs, batch_size=bs, tcsr=True)
    probe = BatchLoader(train_g, bs, spec=spec, with_targets=True, pack=True)
    next(iter(probe))
    levels = [d[0] for d in probe.layout.dp_specs
              if d[0] in plane_levels(policy)]
    if policy == KernelPolicy() and levels != ["dp_bond", "dp_fc"]:
        raise AssertionError(f"device planes for {levels} only")
    n_train = len(list(BatchLoader(train_g, bs, spec=spec, shuffle=True,
                                   seed=seed)._windows()))
    val_w = list(BatchLoader(val_g, bs, spec=spec)._windows())
    val_have = []
    for w in val_w:
        have = _planes_of(pad_batch(w, spec, with_targets=True))
        if not {"dp_bond", "dp_fc"} <= have:
            raise AssertionError("a validation batch has no host planes")
        val_have.append(have)
    steps = n_epochs * n_train
    expect = expected_launches(
        policy, L, [(set(levels), steps, steps)]
        + [(h, n_validations, 0) for h in val_have])
    expect[PLANES] = len(levels) * steps
    return expect, n_train, len(val_w), levels


def drive_pretrain(popt, pgraphs, expect, tier: str):
    """Run run_pretrain on the card with every launch count set to 0 just
    before it; its printed tier, finite losses and each kernel's launches
    against ``expect``. Returns (launches, checkpoint path)."""
    import contextlib
    import io

    import numpy as np

    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.pretrain import run_pretrain

    n_epochs = int(popt.pretrain.n_epochs)
    text = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        best, ckpt = run_pretrain(popt, device="cuda", graphs=pgraphs)
    run_s = time.perf_counter() - t0
    launches = _launches()
    print(text.getvalue().rstrip())
    scal = read_scalars(popt.exp_dir)
    losses = [r["value"] for r in scal if r["tag"] == "train/loss"][-n_epochs:]
    vals = [r["value"] for r in scal if r["tag"] == "val/loss"][-n_epochs:]
    eps = [r["value"] for r in scal
           if r["tag"] == "train/edges_per_sec"][-n_epochs:]
    print(f"pretraining path [{tier}]: {n_epochs} epochs, run {run_s:.2f} s, "
          f"train losses {[round(x, 5) for x in losses]}, val losses "
          f"{[round(x, 5) for x in vals]}, best {best:.5f}")
    print("train message-edges/s per epoch: "
          + ", ".join(f"{x / 1e6:.4f}M" for x in eps))
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches.items()))
    if f"packed {tier}" not in text.getvalue():
        raise AssertionError(f"run_pretrain did not report the {tier} tier")
    if len(losses) != n_epochs or len(vals) != n_epochs \
            or not np.isfinite(losses + vals).all():
        raise AssertionError(f"pretraining is not finite: train {losses}, "
                             f"val {vals}")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the pretraining "
                                 f"path [{tier}], expected {expect[n]}")
    return launches, ckpt


def pretrain_big_batch(pgraphs, dev):
    """(packed buffer on ``dev``, its layout): one batch at the pretrain
    config's batch_size 512 of the pretrain graphs, repeated to fill it."""
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    big_bs = int(PT_CONFIG["pretrain"]["batch_size"])
    rep = pgraphs * (-(-big_bs // len(pgraphs)))
    big = BatchLoader(rep, big_bs, spec=spec_for(rep, big_bs, tcsr=True),
                      with_targets=True, pack=True)
    return torch.from_numpy(next(iter(big))).to(dev), big.layout


# the kernels phase 13 also holds against their plain versions and times
# at the batch-512 pretraining shapes
BIG_KERNELS = ("tcsr_gat_fwd", "tcsr_gat_bwd", "dense_gat_fwd",
               "dense_gat_bwd")


def pretrain_kernel_calls(popt, model, buf, layout, rng):
    """K1's, K2's, K4's and K5's inputs at the batch-512 pretraining
    shapes: {kernel: [(level, args, kwargs)]} from layer 0 of one forward of
    the pretrain ``model`` on the packed ``buf`` decoded on its device (K6
    planes) — the TCSR forward's atom and frag calls and the dense
    forward's bond and fconn calls, and the backward kernels' arguments
    built from them as phase 4 builds them. Levels are tagged "batch
    512"."""
    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)

    batch = add_planes(unpack_batch(buf, layout, planes=()), layout,
                       plane_levels(model.policy))
    was = model.training
    model.eval()
    calls = layer0_kernel_calls(int(popt.pretrain.model.num_layer), model,
                                batch)
    model.train(was)
    out = {}
    for name in BIG_KERNELS:
        fwd = KERNELS[name].fwd
        out[name] = [(f"{lvl}, batch 512",
                      a if fwd is None else bwd_kernel_args(fwd, a, kw, rng),
                      kw if fwd is None else {})
                     for lvl, a, kw in calls[fwd or name]]
    return out


def pretrain_step_profile(popt, calls_buf, dev, names, label: str):
    """One pretrain train step at batch 512 from the packed buffer
    ``calls_buf`` on the card under ``popt``'s kernel policy: wall time
    (median of 5 after a warm-up) and one step's device busy time, top ops,
    the plane builder's share and the device time of the kernels ``names``,
    printed. Returns (model, optimizer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.optim import make_optimizer
    from fragnet_tpu_torch.train.pretrain import (build_pretrain_model,
                                                  make_pretrain_step)

    buf, layout = calls_buf
    model = build_pretrain_model(
        popt, policy=resolve_kernel_policy(popt.pretrain),
        generator=torch.Generator().manual_seed(0)).to(dev)
    opt, _ = make_optimizer(model.parameters(), "adam", lr=1e-4)
    step = make_pretrain_step(model, opt, layout=layout, device=dev)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(buf)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(buf)
        torch.cuda.synchronize()
    dev_busy, busy = _busy(prof)
    k6_ms = sum(ms for key, ms in busy if "dense_planes_kernel" in key)
    ours = {n: sum(ms for key, ms in busy if f"{n}_kernel" in key)
            for n in names}
    print(f"pretrain step at batch 512 [{label} policy] (packed buffer on "
          f"the card: unpack, planes, forward, backward, Adam): wall "
          f"{wall:.2f} ms (median of 5 after warm-up), device busy "
          f"{dev_busy:.3f} ms ({100 * dev_busy / wall:.1f}%) in {len(busy)} "
          f"kernel kinds; plane builder {k6_ms:.3f} ms "
          f"({100 * k6_ms / max(dev_busy, 1e-9):.1f}% of "
          f"busy); " + ", ".join(f"{n} {ms:.3f}" for n, ms in ours.items())
          + "; top: " + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:10]))
    return model, opt


def timed_pretrain_step(popt, calls_buf, dev):
    """Phase 13: one pretrain train step at batch 512 from a packed buffer
    on the card — pretrain_step_profile, then the step in stages each
    ended by a synchronize; then K1, K2, K4 and K5 against their plain
    versions at this step's layer-0 inputs, timed as in phase 4. Returns
    their per-level reports ({kernel: (levels, 0.0)})."""
    import torch

    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)
    from fragnet_tpu_torch.train.pretrain import pretrain_loss

    buf, layout = calls_buf
    model, opt = pretrain_step_profile(popt, calls_buf, dev, GAT_KERNELS,
                                       "default")
    levels = plane_levels(model.policy)
    stages = {"unpack (no planes)": [], "K6 planes": [], "forward+loss": [],
              "backward": [], "adam": []}
    model.train()
    for _ in range(5):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        b = unpack_batch(buf, layout, planes=())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        b = add_planes(b, layout, levels)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss = pretrain_loss(model(b), b)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, z in zip(stages, t, t[1:]):
            stages[k].append((z - a) * 1e3)
    print("pretrain step stages (host clock to a synchronize, median of 5): "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms"
                      for k, v in stages.items()))
    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    calls = pretrain_kernel_calls(popt, model, buf, layout, rng)
    report = check_kernels(BIG_KERNELS, calls, rng)
    print(f"K1, K2, K4 and K5 at batch 512 (capture, check against plain, "
          f"timing): "
          f"{time.perf_counter() - t0:.1f} s of phase 13")
    return report


def pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev):
    """Phases 14 and 19: one pretrain step's loss and gradients under the
    run's kernel policy — on the card from the packed buffer (decoded
    there, K6 planes), on the CPU from the unpacked host batch with host
    planes; the same weights (the pretraining run's checkpoint), dropout
    off."""
    import copy as _copy

    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import plane_levels, unpack_batch
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.train.checkpoint import load_params
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import (build_pretrain_model,
                                                  pretrain_loss, split_graphs)

    bs = int(popt.pretrain.batch_size)
    train_g, _ = split_graphs(pgraphs, int(popt.seed))
    spec = spec_for(pgraphs, batch_size=bs, tcsr=True)
    loader = BatchLoader(train_g, bs, spec=spec, with_targets=True, pack=True)
    buf = next(iter(loader))
    host = pad_batch(next(loader._windows()), spec, with_targets=True)
    model = load_params(build_pretrain_model(
        popt, policy=resolve_kernel_policy(popt.pretrain)), ckpt).eval()

    def loss_and_grads(d, packed):
        m = _copy.deepcopy(model).to(d)
        if packed:
            b = unpack_batch(torch.from_numpy(buf).to(d), loader.layout,
                             plane_levels(m.policy))
        else:
            b = to_device(host, d)
        loss = pretrain_loss(m(b), b)
        loss.backward()
        return float(loss.detach()), {
            n: (None if p.grad is None else p.grad.detach().cpu())
            for n, p in m.named_parameters()}

    l_gpu, g_gpu = loss_and_grads(dev, packed=True)
    l_cpu, g_cpu = loss_and_grads(torch.device("cpu"), packed=False)
    return _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu)


def _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu):
    """(worst relative diff, its name): the loss against its own value,
    each gradient against its own scale — a gradient at round-off level (≤
    1e-6 of the model's largest) against that level."""
    scale = max(float(g.abs().max()) for g in g_cpu.values() if g is not None)
    worst, worst_name = abs(l_gpu - l_cpu) / abs(l_cpu), "loss"
    for n, gc in g_cpu.items():
        gg = g_gpu[n]
        if (gc is None) != (gg is None):
            raise AssertionError(f"{n}: gradient on one device only")
        if gc is None:
            continue
        rel = float((gg - gc).abs().max()) / max(float(gc.abs().max()),
                                                 1e-6 * scale)
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


def pretrain_phases(dev, pending, datasets):
    """Phases 10-15: the pretraining path. ``pending`` is the PretrainGraphs
    featurizing the config's synthetic set. Returns (the plane builder's
    per-level report, each kernel's launches on the pretraining path, the
    graphs, the BIG_KERNELS' per-level reports at batch 512)."""
    import torch

    from fragnet_tpu_torch.train.finetune import run_finetune

    popt = pt_opt(PT_OVERRIDES)
    pgraphs = pending.get()
    print(f"pretrain featurization: ready {time.perf_counter() - pending.t0:.2f}"
          f" s after its start, beside phases 3-9 ({len(pgraphs)} graphs, "
          f"{pending.workers} processes)")

    # ---- 10. the plane builder at batch 512 -------------------------------
    t0 = time.perf_counter()
    big_bs = int(PT_CONFIG["pretrain"]["batch_size"])
    calls, n_mols = plane_calls(pgraphs, big_bs, dev)
    print(f"plane builder check at batch {big_bs} ({n_mols} molecules):")
    k6_report = check_planes(calls)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # ---- 11. the pretraining path: HBM packed tier ------------------------
    t0 = time.perf_counter()
    n_epochs = int(popt.pretrain.n_epochs)
    expect, n_train, n_val, _ = pretrain_expect(popt, pgraphs, n_epochs,
                                                n_epochs)
    print(f"pretraining path: {n_train} train steps/epoch, {n_val} val "
          f"batches/epoch at batch {popt.pretrain.batch_size}")
    launches, ckpt = drive_pretrain(popt, pgraphs, expect, "HBM")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- 12. the process-stream tier, one epoch ---------------------------
    t0 = time.perf_counter()
    sopt = pt_opt(PT_OVERRIDES, STREAM_OVERRIDES)
    s_expect = pretrain_expect(sopt, pgraphs, 1, 1)[0]
    drive_pretrain(sopt, pgraphs, s_expect, "process stream")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # ---- 13. one train step at batch 512 from a packed buffer -------------
    t0 = time.perf_counter()
    big_report = timed_pretrain_step(popt, pretrain_big_batch(pgraphs, dev),
                                     dev)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # ---- 14. one pretrain step's gradients: card vs CPU -------------------
    t0 = time.perf_counter()
    worst, worst_name = pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev)
    print(f"pretrain step cpu vs gpu (packed + K6 planes on the card, host "
          f"planes on the CPU): worst relative diff {worst:.3e} "
          f"({worst_name}) (limit {GRAD_REL_LIMIT}); phase 14: "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU pretrain gradients disagree")

    # ---- 15. the encoder transfer into finetuning -------------------------
    t0 = time.perf_counter()
    fopt = smoke_opt()
    for k, v in {"pretrain.use": True, "pretrain.chk": ckpt,
                 "exp_dir": os.path.join(REPO, "exps",
                                         "chip_smoke_transfer")}.items():
        fopt.set_path(k, v)
    _rmse, ft_model = run_finetune(fopt, quiet=True, datasets=datasets,
                                   device="cuda")
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    enc = {k: v for k, v in ft_model.state_dict().items()
           if k.startswith("pretrain.")}
    bad = [k for k, v in enc.items() if not torch.equal(v.cpu(), sd[k])]
    print(f"transfer: {len(enc)} encoder tensors of the finetune model equal "
          f"the pretrain checkpoint's: {not bad}; phase 15: "
          f"{time.perf_counter() - t0:.1f} s")
    if bad or not enc:
        raise AssertionError(f"encoder transfer differs at {bad[:5]}")
    return k6_report, launches, pgraphs, big_report


def _attr_calls(fwd, rng):
    """{kernel: [(level, args, kwargs)]} for K7, K8 and K9 from K7's calls
    ``fwd``: the backward's arguments as phase 4 builds them (the forward
    kernel's out, m, den and a seeded cotangent) and the emit's (K8's
    d_zpre planes)."""
    from fragnet_tpu_torch.ops import dense_gat

    if fwd[1][1][0].is_contiguous():
        raise AssertionError("the fconn adjacency is not the strided view "
                             "of the R=6 planes")
    bwd = [(lvl, bwd_kernel_args("dense_attr_fwd", a, kw, rng), {})
           for lvl, a, kw in fwd]
    emit = [(lvl, (dense_gat.dense_attr_bwd(*a)[4],) + tuple(a[5:9]), {})
            for lvl, a, _ in bwd]
    return {"dense_attr_fwd": fwd, "dense_attr_bwd": bwd, EMIT: emit}


def attr_kernel_calls(n_tasks, batch, rng):
    """Phase 16's inputs at the finetune batch: {kernel: [(level, args,
    kwargs)]} for K7, K8 and K9 — layer 0's dense-attr calls of one forward
    of the esol-config model under the dense-attr policy on ``batch``
    (atom, fconn, frag) and a seeded case per level (_attr_calls)."""
    import torch

    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model

    aopt = smoke_opt(attr=True)
    model = build_model(aopt, n_classes=n_tasks,
                        policy=resolve_kernel_policy(aopt.finetune),
                        generator=torch.Generator().manual_seed(0))
    model = model.to(batch.x_atoms.device).eval()
    fwd = layer0_kernel_calls(int(aopt.finetune.model.num_layer), model,
                              batch,
                              names=("dense_attr_fwd",))["dense_attr_fwd"]
    return _attr_calls(fwd + [seeded_attr_call(c, rng) for c in fwd], rng)


def pretrain_attr_kernel_calls(calls_buf, dev, rng):
    """Phase 16's inputs at the batch-512 pretraining shapes: K7's, K8's and
    K9's arguments (_attr_calls) from layer 0's dense-attr calls (atom,
    fconn, frag) of one forward of the pretrain model under the dense-attr
    policy (phase 19's config) on the batch-512 packed buffer ``calls_buf``
    (pretrain_big_batch) decoded on the card with K6 planes at every level
    the policy reads. Levels are tagged "batch 512"."""
    import torch

    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import build_pretrain_model

    popt = pt_opt(PT_OVERRIDES, ATTR_PT_OVERRIDES)
    model = build_pretrain_model(
        popt, policy=resolve_kernel_policy(popt.pretrain),
        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    buf, layout = calls_buf
    batch = add_planes(unpack_batch(buf, layout, planes=()), layout,
                       plane_levels(model.policy))
    fwd = layer0_kernel_calls(int(popt.pretrain.model.num_layer), model,
                              batch,
                              names=("dense_attr_fwd",))["dense_attr_fwd"]
    return _attr_calls([(f"{lvl}, batch 512", a, kw) for lvl, a, kw in fwd],
                       rng)


def finetune_expect(fopt, datasets, spec, test_windows):
    """Each kernel's launches on ``run_finetune``'s path for ``fopt`` (its
    kernel policy and epochs; 0 epochs is the prediction path), derived
    from the loaders: under finetune.cache=auto the loaders are cached on
    the device, so every epoch runs the train batches of the first
    (shuffled) pass and the val batches, and the test batches run once;
    each batch's passes are counted by ``expected_launches`` from the host
    planes it carries (no plane builder). Returns (counts, train batches,
    val batches, batches without atom, frag or fconn planes)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    ft = fopt.finetune
    n_epochs, seed = int(ft.n_epochs), int(fopt.seed)
    bs, L = int(ft.batch_size), int(ft.model.num_layer)
    train_g, val_g, _test_g, n_tasks, _task = datasets
    first = list(BatchLoader(train_g, bs, spec=spec, shuffle=True, seed=seed,
                             n_tasks=n_tasks)._windows())
    val_w = list(BatchLoader(val_g, bs, spec=spec, n_tasks=n_tasks)._windows())
    batches = []
    for ws, n_fwd, n_steps in ((first, n_epochs, n_epochs),
                               (val_w, n_epochs, 0), (test_windows, 1, 0)):
        for w in ws:
            batches.append((_planes_of(pad_batch(w, spec, n_tasks=n_tasks)),
                            n_fwd, n_steps))
    lacking = sum(1 for have, _, _ in batches
                  if not {"dp_atom", "dp_frag", "dp_fc"} <= have)
    return (expected_launches(resolve_kernel_policy(ft), L, batches),
            len(first), len(val_w), lacking)


def finetune_attr_path(datasets, spec, test_windows):
    """Phase 17: run_finetune on cuda for 3 epochs under the dense-attr
    policy, every launch count set to 0 just before it; each kernel's
    launches against the count derived from the loaders' batches (the
    cached train batches of the first pass, replayed each epoch, the val
    batches each epoch, the test batches once) and the planes each batch
    carries (finetune_expect). Returns (launches, the trained model)."""
    import numpy as np

    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import run_finetune

    aopt = smoke_opt(train=True, attr=True)
    n_epochs = int(aopt.finetune.n_epochs)
    expect, n_train, n_val, lacking = finetune_expect(aopt, datasets, spec,
                                                      test_windows)
    print(f"dense-attr finetune path: "
          f"{resolve_kernel_policy(aopt.finetune)}; {n_train} train, "
          f"{n_val} val, {len(test_windows)} test batches, {lacking} "
          f"without atom, frag or fconn planes")
    if any(expect[n] == 0 for n in ATTR_KERNELS):
        raise AssertionError(f"no dense-attr launch expected: {expect}")
    _reset_launches()
    t0 = time.perf_counter()
    rmse, model = run_finetune(aopt, datasets=datasets, device="cuda")
    run_s = time.perf_counter() - t0
    launches = _launches()
    scal = read_scalars(aopt.exp_dir)
    losses = [r["value"] for r in scal if r["tag"] == "train/loss"][-n_epochs:]
    eps = [r["value"] for r in scal
           if r["tag"] == "train/edges_per_sec"][-n_epochs:]
    print(f"dense-attr training path: test rmse {rmse:.5f}, train losses "
          f"{[round(x, 5) for x in losses]}, run {run_s:.2f} s; train "
          f"message-edges/s per epoch: "
          + ", ".join(f"{x / 1e6:.4f}M" for x in eps))
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches.items()))
    if len(losses) != n_epochs or not np.isfinite(losses).all() \
            or not np.isfinite(rmse):
        raise AssertionError(f"dense-attr training is not finite: losses "
                             f"{losses}, test rmse {rmse}")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the dense-attr "
                                 f"training path, expected {expect[n]}")
    return launches, model


def attr_phases(dev, datasets, spec, windows, batch, train_np, step_default,
                pgraphs, rng):
    """Phases 16-19: the dense-attr kernel policy. Returns (K7-K9's kernel
    report, with the batch-512 levels marked off the kernels' line sums,
    launches on the finetune path, launches on the pretraining path)."""
    # ---- 16. K7, K8, K9 against their plain versions ----------------------
    t0 = time.perf_counter()
    calls = attr_kernel_calls(datasets[3], batch, rng)
    big_buf = pretrain_big_batch(pgraphs, dev)
    big = pretrain_attr_kernel_calls(big_buf, dev, rng)
    for name in ATTR_KERNELS:
        calls[name] += big[name]
    report = check_kernels(ATTR_KERNELS, calls, rng)
    for per_level, _err in report.values():
        for p in per_level:
            # the batch-512 levels stand beside the finetune layer's in the
            # kernel's line; its ms and bound stay the finetune layer's
            p["on_path"] = "batch 512" not in p["level"]
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # ---- 17. the finetune training path under the dense-attr policy -------
    t0 = time.perf_counter()
    launches_ft, model = finetune_attr_path(datasets, spec, windows)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # ---- 18. one dense-attr train step: time, and gradients card vs CPU ---
    t0 = time.perf_counter()
    step_attr = timed_train_step(model, train_np, dev, "dense-attr")
    print(f"train step, dense-attr vs default policy: wall "
          f"{step_attr['wall']:.2f} / {step_default['wall']:.2f} ms, device "
          f"busy {step_attr['busy']:.3f} / {step_default['busy']:.3f} ms; "
          "per kernel (ms, dense-attr / default): "
          + ", ".join(f"{n} {step_attr['kernels'][n]:.3f} / "
                      f"{step_default['kernels'][n]:.3f}" for n in KERNELS))
    l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
        model, train_np, dev)
    print(f"dense-attr train step cpu vs gpu: loss {l_cpu:.6f} / "
          f"{l_gpu:.6f}; worst relative diff {worst:.3e} ({worst_name}) "
          f"over {n_par} parameters (limit {GRAD_REL_LIMIT}); phase 18: "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU dense-attr gradients disagree")

    # ---- 19. the pretraining path under the dense-attr policy -------------
    t0 = time.perf_counter()
    popt = pt_opt(PT_OVERRIDES, ATTR_PT_OVERRIDES)
    expect, n_train, n_val, levels = pretrain_expect(popt, pgraphs, 1, 1)
    print(f"dense-attr pretraining path: {n_train} train steps, {n_val} val "
          f"batches at batch {popt.pretrain.batch_size}; device planes per "
          f"train step: {levels} (K6 {len(levels)} launches per step)")
    if any(expect[n] == 0 for n in ATTR_KERNELS):
        raise AssertionError(f"no dense-attr launch expected: {expect}")
    launches_pt, ckpt = drive_pretrain(popt, pgraphs, expect, "HBM")
    pretrain_step_profile(popt, big_buf, dev, GAT_KERNELS + ATTR_KERNELS,
                          "dense-attr")
    worst, worst_name = pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev)
    print(f"dense-attr pretrain step cpu vs gpu (packed + K6 planes on the "
          f"card, host planes on the CPU): worst relative diff {worst:.3e} "
          f"({worst_name}) (limit {GRAD_REL_LIMIT}); phase 19: "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU dense-attr pretrain gradients "
                             "disagree")
    return report, launches_ft, launches_pt



EP_SHARDS = 2
DIST_TIMEOUTS = {"dist.timeout_s": 120, "dist.join_timeout_s": 600}


def dist_opt(mode: str, n_ranks: int, n_epochs: int):
    """The smoke's training config under ``dist.mode=mode`` over
    ``n_ranks`` ranks for ``n_epochs`` epochs, in its own exp_dir."""
    opt = smoke_opt(train=True)
    for k, v in {"dist.mode": mode, "dist.n_devices": n_ranks,
                 "finetune.n_epochs": n_epochs, **DIST_TIMEOUTS,
                 "exp_dir": os.path.join(REPO, "exps",
                                         f"chip_smoke_{mode}{n_ranks}")
                 }.items():
        opt.set_path(k, v)
    return opt


def ep_spec(datasets, bs: int, n_ranks: int, tn: int = 128, te: int = 256):
    """run_finetune's spec under dist.mode=ep on the card."""
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    train_g, val_g, test_g, _, _ = datasets
    return spec_for(train_g + val_g + test_g, batch_size=bs,
                    multiple=max(tn, te) * n_ranks)


def ep_expect(opt, datasets, n_ranks: int):
    """Each kernel's launches in every rank of run_finetune under
    dist.mode=ep, derived from its loaders: the train loader's shuffle
    advances two epochs in the width probe (pin_ep_widths) and one for the
    init batch, so training runs epochs 3.. of it; every rank runs every
    batch. K3's forward runs all four levels of every layer per forward,
    its backward every layer's bond, atom and fconn pass and the last
    layer's frag pass per train step (the earlier frag outputs are off the
    loss's path); nothing else launches."""
    from fragnet_tpu_torch.data.batcher import BatchLoader

    ft = opt.finetune
    bs, L, seed = int(ft.batch_size), int(ft.model.num_layer), int(opt.seed)
    train_g, val_g, test_g, n_tasks, _ = datasets
    spec = ep_spec(datasets, bs, n_ranks)
    tl = BatchLoader(train_g, bs, spec=spec, shuffle=True, seed=seed)
    for _ in range(3):
        list(tl._windows())
    steps = sum(len(list(tl._windows())) for _ in range(int(ft.n_epochs)))
    fwds = (steps + int(ft.n_epochs) * len(list(BatchLoader(
        val_g, bs, spec=spec)._windows()))
        + len(list(BatchLoader(test_g, bs, spec=spec)._windows())))
    out = {n: 0 for n in KERNELS}
    out["tcsr_gat_ep_fwd"] = 4 * L * fwds
    out["tcsr_gat_ep_bwd"] = (3 * L + 1) * steps
    return out, steps


def dp_expect(opt, datasets, spec, n_ranks: int):
    """Each rank's kernel launches in run_finetune under dist.mode=dp,
    derived from its DPBatchLoaders (the init batch takes the train
    loader's first shuffle; no cache, so every epoch re-windows): every
    micro-batch counted by ``expected_launches`` from the planes it
    carries. Returns ([counts per rank], train steps)."""
    from fragnet_tpu_torch.dist.data_parallel import (DPBatchLoader,
                                                      stack_for_dp)

    ft = opt.finetune
    bs, L, seed = int(ft.batch_size), int(ft.model.num_layer), int(opt.seed)
    n_epochs = int(ft.n_epochs)
    train_g, val_g, test_g, n_tasks, _ = datasets
    tl = DPBatchLoader(train_g, bs, n_ranks, spec, shuffle=True, seed=seed)
    tl.windows()
    train_w = [w for _ in range(n_epochs) for w in tl.windows()]
    val_w = DPBatchLoader(val_g, bs, n_ranks, spec).windows()
    test_w = DPBatchLoader(test_g, bs, n_ranks, spec).windows()
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    policy = resolve_kernel_policy(ft)
    out = []
    for r in range(n_ranks):
        def planes(w):
            return _planes_of(stack_for_dp(w, n_ranks, spec, r,
                                           n_tasks=n_tasks))
        batches = ([(planes(w), 1, 1) for w in train_w]
                   + [(planes(w), n_epochs, 0) for w in val_w]
                   + [(planes(w), 1, 0) for w in test_w])
        out.append(expected_launches(policy, L, batches))
    return out, len(train_w)


def _rank_launches(report):
    """A rank report's launches (by launcher symbol) by KERNELS name."""
    return {n: report["launches"].get(_counter(n)[1].symbol, 0)
            for n in KERNELS}


def drive_dist(opt, datasets, expects, label: str, backend: str):
    """run_finetune under opt's dist.mode on the card, every count in this
    process set to 0 just before it: each rank's losses and test RMSE
    finite and equal across the ranks, its launches equal to ``expects``
    [rank], its backend ``backend``. Several ranks run in spawned
    processes, so this one launches nothing; one runs here. Returns [each
    rank's launches]."""
    import numpy as np

    from fragnet_tpu_torch.train.finetune import run_finetune

    reports = []
    _reset_launches()
    t0 = time.perf_counter()
    rmse, _model = run_finetune(opt, datasets=datasets, device="cuda",
                                rank_reports=reports)
    run_s = time.perf_counter() - t0
    out = []
    for r in reports:
        got = _rank_launches(r)
        exp = expects[r["rank"]]
        print(f"{label} rank {r['rank']} ({r['backend']}, {r['device']}): "
              f"test rmse {r['value']:.6f}, train losses "
              f"{[round(x, 6) for x in r['train_loss']]}, val "
              f"{[round(x, 6) for x in r['val_score']]}; kernels: "
              + " ".join(f"{n}={c} (expected {exp[n]})"
                         for n, c in got.items() if c or exp[n]))
        vals = r["train_loss"] + r["val_score"] + [r["value"]]
        if not np.isfinite(vals).all() or len(r["train_loss"]) != int(
                opt.finetune.n_epochs):
            raise AssertionError(f"{label} rank {r['rank']} is not finite: "
                                 f"{vals}")
        for n, c in got.items():
            if c != exp[n]:
                raise AssertionError(f"{label} rank {r['rank']}: {n} launched "
                                     f"{c} times, expected {exp[n]}")
        out.append(got)
    first = reports[0]
    for r in reports[1:]:
        if (r["value"], r["train_loss"], r["val_score"]) != (
                first["value"], first["train_loss"], first["val_score"]):
            raise AssertionError(f"{label}: ranks disagree")
    if rmse != first["value"] or first["backend"] != backend or (
            len(reports) > 1 and any(_launches().values())):
        raise AssertionError(f"{label}: backend {first['backend']}, or the "
                             f"launching process ran kernels or returned "
                             f"another value")
    print(f"{label}: {len(reports)} ranks over {first['backend']}, run "
          f"{run_s:.2f} s (spawn and rank start-up included)")
    return out


def seeded_ep_graph(rng, n_nodes: int, n_edges: int, tn: int, te: int):
    """A seeded graph at one level's EP shapes (the caller's node and edge
    slots) whose kept edges reach both shards: 3/4 of the slots real edges
    sorted by destination over every tile, sources within half a tile of
    their destination, a tenth of them masked; the rest padding. Shard 1
    then starts about two thirds into the nodes, so its grid offset t0 is
    above 0 and K3's offset arithmetic carries real edges. Returns src,
    dst and mask as numpy arrays, and the EPTileMeta."""
    import numpy as np

    from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta

    n_real = 3 * n_edges // 4
    src = np.zeros(n_edges, np.int32)
    dst = np.zeros(n_edges, np.int32)
    mask = np.zeros(n_edges, np.float32)
    dst[:n_real] = np.sort(rng.integers(0, n_nodes, n_real))
    src[:n_real] = np.clip(dst[:n_real] + rng.integers(-tn // 2, tn // 2 + 1,
                                                        n_real),
                           0, n_nodes - 1)
    mask[:n_real] = rng.random(n_real) > 0.1
    meta = build_ep_tile_meta(src, dst, mask, n_nodes, EP_SHARDS, tn=tn,
                              te=te)
    es = n_edges // EP_SHARDS
    if meta is None or not all(mask[r * es:(r + 1) * es].any()
                               for r in range(EP_SHARDS)) or not (
            meta.t0[1:] > 0).all():
        raise AssertionError(f"the seeded EP graph ({n_nodes} nodes, "
                             f"{n_edges} edges) does not reach every shard "
                             f"at a grid offset above 0")
    return src, dst, mask, meta


def ep_kernel_calls(captured, rng):
    """Phase 20's inputs: {kernel: [(level, args, kwargs)]} — each rank's
    layer-0 K3 forward calls (bond, atom, fconn, frag) captured in phase
    22's ranks (the smoke's batch packs real edges first, so shard 1 holds
    only padding there); per level, a seeded case for each shard at the
    level's shapes on a seeded graph whose kept edges reach both shards,
    with shard 1's grid at t0 > 0 (seeded_ep_graph); and the backward's
    arguments: the forward's max (0 on empty rows) as m, numpy cotangents
    dU, dV."""
    import dataclasses

    import numpy as np
    import torch

    from fragnet_tpu_torch.ops import tcsr_gat

    def draw(*shape, dev):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    fwd = []
    for rank, calls in enumerate(captured):
        for lvl, (args, kw) in zip(EP_LEVELS, calls):
            pad = "" if bool((args[5] > 0).any()) else ", padding only"
            fwd.append((f"{lvl}, shard {rank}{pad}", tuple(args), kw))
    for lvl, (args, kw) in zip(EP_LEVELS, captured[0]):
        wn, nf, w_ea, src_c, _d, _m, meta_c = args[:7]
        dev = nf.device
        src, dst, mask, meta = seeded_ep_graph(
            rng, nf.shape[0], EP_SHARDS * src_c.shape[0], meta_c.tn,
            meta_c.te)
        meta = dataclasses.replace(meta, **{
            f: torch.from_numpy(getattr(meta, f)).to(dev)
            for f in ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")})
        wn_s, nf_s = draw(*wn.shape, dev=dev), draw(*nf.shape, dev=dev)
        es = src_c.shape[0]
        for r in range(EP_SHARDS):
            sl = slice(r * es, (r + 1) * es)
            fwd.append((
                f"{lvl}, seeded, shard {r} (t0 {int(meta.t0[r, 0])}, grid "
                f"{meta.n_tiles_grid} tiles)",
                (wn_s, nf_s, draw(es, w_ea.shape[1], dev=dev),
                 *(torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
                   for a in (src, dst, mask)), meta, r) + tuple(args[8:]),
                kw))
    bwd = []
    for lvl, a, kw in fwd:
        out, m, _den = tcsr_gat.tcsr_gat_ep_fwd(*a, **kw)
        m = torch.where(m <= -1e29, torch.zeros_like(m), m)
        bwd.append((lvl, tuple(a[:8]) + (m, draw(*out.shape, dev=out.device),
                                         draw(*m.shape, dev=m.device))
                    + tuple(a[8:]), kw))
    return {"tcsr_gat_ep_fwd": fwd, "tcsr_gat_ep_bwd": bwd}


def check_ep_scales(name, lvl, args, got, want):
    """Phase 20's hold on its cases' data: a shard that keeps no edge must
    give the empty result exactly, and every output of every other case
    must have a nonzero scale (beside the m = −1e30 empty-row marker), so
    that no comparison there is 0 against 0."""
    import torch

    if not bool((args[5] > 0).any()):
        if not all(torch.equal(k_, p) for k_, p in zip(got, want)):
            raise AssertionError(f"{name} [{lvl}]: a shard with no kept edge "
                                 f"does not give the empty result")
        return
    for i, p in enumerate(want):
        live = p[p > -1e29]
        if live.numel() == 0 or float(live.abs().max()) == 0.0:
            raise AssertionError(f"{name} [{lvl}]: output {i} is all zero, so "
                                 f"its comparison shows nothing")


def ep_dp_phases(dev, datasets, spec, train_np, step_default, rng):
    """Phases 20-24: edge-partitioned and data-parallel finetuning on
    torch.distributed. Returns (K3's kernel report, {path: [launches per
    rank]})."""
    import dataclasses

    import torch

    from fragnet_tpu_torch.dist import checks
    from fragnet_tpu_torch.dist.data_parallel import (DPBatchLoader,
                                                      stack_for_dp)
    from fragnet_tpu_torch.dist.launch import run_ranks
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.ops.tcsr import build_tile_meta
    from fragnet_tpu_torch.train.loop import mse_loss

    topt = smoke_opt(train=True)
    train_g, _val_g, _test_g, n_tasks, _ = datasets
    bs = int(topt.finetune.batch_size)
    S = EP_SHARDS
    kw, sd = smoke_weights(datasets)
    plain_np, ep_np, espec = ep_train_batch(datasets)
    runs = {}

    # ---- 20 + 22. one EP train step on 2 ranks (layer 0's K3 inputs) ------
    t0 = time.perf_counter()
    res = ep_step_ranks(kw, sd, ep_np)
    step_s = time.perf_counter() - t0
    print(f"phase 22's EP step on {S} ranks (spawn included), which captures "
          f"phase 20's inputs: {step_s:.1f} s")
    t0 = time.perf_counter()
    report = check_kernels(EP_KERNELS, ep_kernel_calls(
        [r["calls"] for r in res], rng), rng, check_scales=check_ep_scales)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # ---- 21. the EP finetune path, 2 ranks on one card over gloo ---------
    t0 = time.perf_counter()
    eopt = dist_opt("ep", S, int(topt.finetune.n_epochs))
    expect, steps = ep_expect(eopt, datasets, S)
    print(f"EP finetune path: {S} ranks, {steps} train steps, "
          f"spec {espec.n_atoms}/{espec.n_edges}/{espec.n_bg_edges} atom/"
          f"bond/bond-graph edge slots")
    runs["finetune_ep"] = drive_dist(eopt, datasets, [expect] * S,
                                     "EP finetune", "gloo")
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")

    # ---- 22. EP gradients vs the single-device card step -------------------
    t0 = time.perf_counter()
    ref_np = dataclasses.replace(plain_np, **{
        lvl: build_tile_meta(s_, d_, m_, n_, tn=128, te=256) for lvl, (
            s_, d_, m_, n_) in {
            "tm_atom": (plain_np.edge_src, plain_np.edge_dst,
                        plain_np.edge_mask, espec.n_atoms),
            "tm_bond": (plain_np.bg_src, plain_np.bg_dst, plain_np.bg_mask,
                        espec.n_edges),
            "tm_frag": (plain_np.frag_src, plain_np.frag_dst,
                        plain_np.fconn_mask, espec.n_frags),
            "tm_fc": (plain_np.fc_src, plain_np.fc_dst, plain_np.fc_mask,
                      espec.n_fconn)}.items()})
    model = build_model_cpu(topt, n_tasks).to(dev).eval()
    b = to_device(ref_np, dev)
    pred, attn = model(b, return_attentions=True)
    loss_t = mse_loss(pred, b.y, b.graph_mask)
    loss_t.backward()
    loss = float(loss_t.detach())
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for n, p in model.named_parameters()}
    worst, worst_name = 0.0, ""
    for r in res:
        pairs = [("pred", r["pred"], pred.detach().cpu())] + [
            (f"attn {k}", r["attn"][k], getattr(attn, k).cpu())
            for k in r["attn"]] + [
            (n, torch.zeros_like(g) if r["grads"][n] is None
             else r["grads"][n], g) for n, g in grads.items()]
        for name, got, want in pairs:
            rel = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        if abs(r["loss"] - loss) > GRAD_REL_LIMIT * loss:
            raise AssertionError(f"EP loss {r['loss']} vs {loss}")
    print(f"EP step vs single-device card step (same batch and weights, "
          f"dropout off): loss {res[0]['loss']:.6f} / {loss:.6f}; "
          f"worst relative diff {worst:.3e} ({worst_name}) over the "
          f"prediction, 4 attention vectors and {len(grads)} gradients "
          f"(limit {GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("EP and single-device gradients disagree")
    for r in res:
        print(f"EP train step rank (2 ranks, gloo, one card): wall "
              f"{r['wall_ms']:.2f} ms (median of 5), device busy "
              f"{r['busy_ms']:.3f} ms, K3 device {r['k3_device_ms']:.3f} ms, "
              f"collectives (host) {r['collectives_ms']:.2f} ms; "
              f"single-device step (phase 8): wall "
              f"{step_default['wall']:.2f} ms, device busy "
              f"{step_default['busy']:.3f} ms")
    print(f"phase 22: {step_s + time.perf_counter() - t0:.1f} s")

    # ---- 23. the DP finetune path, 2 ranks over gloo, and its gradients ----
    t0 = time.perf_counter()
    dopt = dist_opt("dp", S, int(topt.finetune.n_epochs))
    expects, steps = dp_expect(dopt, datasets, spec, S)
    print(f"DP finetune path: {S} ranks, {steps} train steps")
    runs["finetune_dp"] = drive_dist(dopt, datasets, expects, "DP finetune",
                                     "gloo")
    kw0 = dict(kw, drop_ratio=0.0)
    dres = run_ranks(checks.dp_step_rank, S,
                     (kw0, sd, train_g, spec, bs, 1e-4, "cuda"),
                     device="cuda", timeout_s=120, join_timeout_s=600,
                     workdir=os.path.join(REPO, "exps"))
    win = DPBatchLoader(train_g, bs, S, spec).windows()[0]
    mean = {}
    for r in range(S):
        m_r = build_model_cpu(topt, n_tasks).to(dev)
        m_r.load_state_dict(sd)
        m_r.eval()
        b_r = to_device(stack_for_dp(win, S, spec, r, n_tasks=n_tasks), dev)
        mse_loss(m_r(b_r), b_r.y, b_r.graph_mask).backward()
        for n, p in m_r.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            mean[n] = mean.get(n, 0) + g.cpu() / S
    worst, worst_name = 0.0, ""
    for r in dres:
        for n, want in mean.items():
            got = r["grads"][n]
            got = torch.zeros_like(want) if got is None else got
            rel = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, n
    print(f"DP step's averaged gradients vs the mean of the micro-batches' "
          f"single-device card gradients: worst relative diff {worst:.3e} "
          f"({worst_name}) over {len(mean)} parameters (limit "
          f"{GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("DP gradients disagree with the mean")
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")

    # ---- 24. NCCL at world size 1 ------------------------------------------
    t0 = time.perf_counter()
    e1 = dist_opt("ep", 1, 1)
    runs["finetune_ep_nccl"] = drive_dist(e1, datasets,
                                          [ep_expect(e1, datasets, 1)[0]],
                                          "EP finetune, 1 rank", "nccl")
    d1 = dist_opt("dp", 1, 1)
    runs["finetune_dp_nccl"] = drive_dist(
        d1, datasets, dp_expect(d1, datasets, spec, 1)[0],
        "DP finetune, 1 rank", "nccl")
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return report, runs


def smoke_weights(datasets):
    """(FragNetFineTune's arguments for the smoke's esol model, its seeded
    weights on the CPU)."""
    from fragnet_tpu_torch.train.finetune import model_kwargs

    opt = smoke_opt(train=True)
    model = build_model_cpu(opt, datasets[3])
    return (model_kwargs(opt, datasets[3]),
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def ep_train_batch(datasets):
    """The smoke's first train window padded under run_finetune's EP spec:
    (without kernel metadata, with 2-shard EPTileMeta at tn 128, te 256,
    the spec)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.dist.edge_partition import with_ep_tile_meta
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch

    opt = smoke_opt(train=True)
    train_g, n_tasks = datasets[0], datasets[3]
    bs, seed = int(opt.finetune.batch_size), int(opt.seed)
    espec = ep_spec(datasets, bs, EP_SHARDS)
    window = next(BatchLoader(train_g, bs, spec=espec, shuffle=True,
                              seed=seed)._windows())
    plain_np = pad_batch(window, espec, n_tasks=n_tasks)
    ep_np, ok = with_ep_tile_meta(plain_np, EP_SHARDS, tn=128, te=256)
    if not ok:
        raise AssertionError("the smoke's train batch has no EP tile meta")
    return plain_np, ep_np, espec


def ep_step_ranks(kw, sd, ep_np):
    """One EP train step of the esol model on ``ep_np`` in EP_SHARDS ranks
    spawned on the card (dist/checks.py:ep_card_step_rank): each rank's
    result, layer 0's K3 forward calls included."""
    from fragnet_tpu_torch.dist import checks
    from fragnet_tpu_torch.dist.launch import run_ranks

    return run_ranks(checks.ep_card_step_rank, EP_SHARDS, (kw, sd, ep_np),
                     device="cuda", timeout_s=120, join_timeout_s=600,
                     workdir=os.path.join(REPO, "exps"))


def build_model_cpu(opt, n_tasks):
    """The smoke's esol model, seeded, on the CPU."""
    import torch

    from fragnet_tpu_torch.train.finetune import build_model

    return build_model(opt, n_classes=n_tasks,
                       generator=torch.Generator().manual_seed(0))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fragnet_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(fragnet_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    # ---- 2. build ---------------------------------------------------------
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.ops import _cuda
    from fragnet_tpu_torch.train.finetune import (build_model,
                                                  load_datasets,
                                                  run_finetune)
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    logs = _cuda.build_all([_counter(n)[1] for n in KERNELS], force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(logs)} sources, nvcc in parallel); per source: "
          + ", ".join(f"{src} {sec:.1f} s"
                      for src, sec in _cuda.BUILD_SECONDS.items()))
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # ---- 3. data ----------------------------------------------------------
    # the pretraining set featurizes in spawned processes meanwhile
    pending = PretrainGraphs(pt_opt(PT_OVERRIDES),
                             workers=max(1, (os.cpu_count() or 2) - 1))
    atexit.register(pending.close)  # a failing phase leaves none running
    opt = smoke_opt()
    t0 = time.perf_counter()
    datasets = load_datasets(opt)
    train_g, val_g, test_g, n_tasks, _task = datasets
    print(f"featurization: {time.perf_counter() - t0:.2f} s "
          f"({len(train_g)}/{len(val_g)}/{len(test_g)} graphs)")
    bs = int(opt.finetune.batch_size)
    spec, windows, batch_np = smoke_batch(opt, datasets)
    dev = torch.device("cuda")
    batch = to_device(batch_np, dev)
    model = build_model(opt, n_classes=n_tasks,
                        generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    t_phase = time.perf_counter()
    # ---- 4. kernel vs plain, at the shapes of a real batch ----------------
    calls = layer0_kernel_calls(int(opt.finetune.model.num_layer), model,
                                batch)
    rng = np.random.default_rng(0)
    calls["dense_gat_fwd"].append(
        seeded_fconn_call(calls["dense_gat_fwd"][1], rng))
    for name in GAT_KERNELS:
        k = KERNELS[name]
        if k.fwd is not None:
            calls[name] = [(lvl, bwd_kernel_args(k.fwd, a, kw, rng), {})
                           for lvl, a, kw in calls[k.fwd]]
    report = check_kernels(GAT_KERNELS, calls, rng)

    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 5. the prediction path -------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    rmse, ft_model = run_finetune(opt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = _launches()
    expect = finetune_expect(opt, datasets, spec, windows)[0]
    print(f"prediction path: test rmse {rmse:.5f} eval {eval_s:.2f} s "
          f"({len(windows)} test batches)")
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches.items()))
    if not np.isfinite(rmse):
        raise AssertionError(f"test rmse is not finite: {rmse}")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the prediction "
                                 f"path, expected {expect[n]}")

    # where the eval's time goes: a second pass over the test batches, each
    # stage timed to a synchronize, then the forward's device time under
    # the profiler
    t_pad = t_copy = t_fwd = 0.0
    for w in windows:
        t0 = time.perf_counter()
        b = pad_batch(w, spec, n_tasks=n_tasks)
        t1 = time.perf_counter()
        tb = to_device(b, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            ft_model(tb)
        torch.cuda.synchronize()
        t_pad, t_copy = t_pad + t1 - t0, t_copy + t2 - t1
        t_fwd += time.perf_counter() - t2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            ft_model(tb)
        torch.cuda.synchronize()
    dev_busy, busy = _busy(prof)
    print(f"eval breakdown ({len(windows)} batches): pad_batch "
          f"{t_pad * 1e3:.2f} ms, to_device {t_copy * 1e3:.2f} ms, forward "
          f"{t_fwd * 1e3:.2f} ms; one forward's device busy time "
          f"{dev_busy:.3f} ms in {len(busy)} kernel kinds, top: "
          + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:5]))

    print(f"phase 5: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 6. whole forward: CPU (plain versions) vs card (kernels) ---------
    cpu_model = copy.deepcopy(ft_model).cpu().eval()
    with torch.no_grad():
        pred_gpu = ft_model(to_device(batch_np, dev)).cpu()
        pred_cpu = cpu_model(to_device(batch_np, "cpu"))
    if tuple(pred_gpu.shape) != (bs, n_tasks):
        raise AssertionError(f"prediction shape {tuple(pred_gpu.shape)}")
    fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
    print(f"forward cpu vs gpu: max_abs_err={fwd_err:.3e} rel={fwd_rel:.3e} "
          f"(limit {FORWARD_REL_LIMIT})")
    if fwd_rel > FORWARD_REL_LIMIT:
        raise AssertionError("card and CPU predictions disagree")

    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 7. the training path ---------------------------------------------
    topt = smoke_opt(train=True)
    n_epochs = int(topt.finetune.n_epochs)
    seed = int(topt.seed)
    train_loader = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                               seed=seed, n_tasks=n_tasks)
    expect, n_train, n_val, _ = finetune_expect(topt, datasets, spec, windows)
    for _ in range(n_epochs):  # the run's shuffled epochs pack as counted
        if len(list(train_loader._windows())) != n_train:
            raise AssertionError("a train epoch packs more batches than "
                                 "the loader's length")
    _reset_launches()
    t0 = time.perf_counter()
    rmse_t, tr_model = run_finetune(topt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_t = _launches()
    scal = read_scalars(topt.exp_dir)
    losses = [r["value"] for r in scal if r["tag"] == "train/loss"][-n_epochs:]
    eps = [r["value"] for r in scal
           if r["tag"] == "train/edges_per_sec"][-n_epochs:]
    print(f"training path: {n_epochs} epochs x {n_train} train batches, "
          f"{n_val} val, {len(windows)} test; test rmse {rmse_t:.5f}, "
          f"train losses {[round(x, 5) for x in losses]}, run {train_s:.2f} s")
    print("train message-edges/s per epoch: "
          + ", ".join(f"{x / 1e6:.4f}M" for x in eps))
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches_t.items()))
    if len(losses) != n_epochs or not np.isfinite(losses).all() \
            or not np.isfinite(rmse_t):
        raise AssertionError(f"training is not finite: losses {losses}, "
                             f"test rmse {rmse_t}")
    for n, c in launches_t.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the training "
                                 f"path, expected {expect[n]}")

    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 8. one train step: host time and device busy time ----------------
    train_np = pad_batch(next(iter(train_loader._windows())), spec,
                         n_tasks=n_tasks)
    step_default = timed_train_step(tr_model, train_np, dev, "default")

    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 9. one train step's gradients: CPU vs card -----------------------
    l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
        tr_model, train_np, dev)
    print(f"train step cpu vs gpu: loss {l_cpu:.6f} / {l_gpu:.6f}; worst "
          f"relative diff {worst:.3e} ({worst_name}) over {n_par} "
          f"parameters (limit {GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU gradients disagree")

    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---- 10.-15. the pretraining path -------------------------------------
    k6_report, launches_pt, pgraphs, big_report = pretrain_phases(
        dev, pending, datasets)
    report[PLANES] = (k6_report, 0.0)
    for name, (levels, _err) in big_report.items():
        # the batch-512 levels stand beside the finetune layer's in the
        # kernel's line; its ms and bound stay the finetune layer's
        report[name][0].extend(dict(p, on_path=False) for p in levels)

    # ---- 16.-19. the dense-attr kernel policy ------------------------------
    attr_report, launches_fa, launches_pa = attr_phases(
        dev, datasets, spec, windows, batch, train_np, step_default, pgraphs,
        rng)
    report.update(attr_report)

    # ---- 20.-24. edge-partitioned and data-parallel finetuning -------------
    ep_report, dist_runs = ep_dp_phases(dev, datasets, spec, train_np,
                                        step_default, rng)
    report.update(ep_report)

    paths = {"finetune_train": launches_t, "pretrain": launches_pt,
             "finetune_attr_train": launches_fa, "pretrain_attr": launches_pa}
    for run, per_rank in dist_runs.items():
        for r, counts in enumerate(per_rank):
            paths[f"{run}_rank{r}"] = counts
    out = []
    for name, (per_level, seeded_err) in report.items():
        # a GAT kernel: one layer's levels of one finetune batch; the plane
        # builder: its two levels of one batch-512 pretrain step
        on_path = [p for p in per_level if p.get("on_path", True)]
        tot_bytes = sum(p["bytes"] for p in on_path)
        tot_flops = sum(p["flops"] for p in on_path)
        _, by = _bound_ms(tot_bytes, tot_flops)
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name].source,
            "replaces": KERNELS[name].replaces,
            "launches": (launches_pa if name in ATTR_KERNELS
                         else dist_runs["finetune_ep"][0] if name in EP_KERNELS
                         else launches_pt)[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": max([seeded_err]
                               + [p["max_abs_err"] for p in per_level]),
            "ms": sum(p["ms"] for p in on_path),
            "plain_ms": sum(p["plain_ms"] for p in on_path),
            "bound_ms": sum(p["bound_ms"] for p in on_path),
            "bound_by": by,
            "library_ms": (sum(p["library_ms"] for p in on_path)
                           if name in (PLANES, EMIT) else None),
            "levels": per_level,
        })
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
