#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and holds every kernel of them
against its plain PyTorch version: the gat2 ESOL recipe
(configs/ft/esol.yaml, full width: 4 layers, emb 128, 4 heads, FTHead3
128/1024/1024/512, batch 16, f32, Adam lr 1e-4) on synthetic molecules
through ``run_finetune`` — first the prediction path
(``finetune.n_epochs=0``), then training (``finetune.n_epochs=3``) — and
geometric pretraining (configs/pt/unimol.yaml, full width: 4 layers, emb
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
     top ops and K6's share;
 14. one pretrain step's loss and gradients, card (packed buffer decoded
     there, K6 planes) vs CPU (host batch, host planes), same weights (the
     run's checkpoint), dropout off: within 1e-3 of each scale;
 15. run_finetune with pretrain.use on the run's checkpoint: every encoder
     tensor of the finetune model equals the checkpoint's.

Prints a ``{"kernels": [...]}`` JSON line (launches from the pretraining
path of phase 11, and the finetune training path's beside them), and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero on any
failure, without a CUDA device, or when run outside a checkout of the
repository.
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REL_LIMIT = 1e-4
FORWARD_REL_LIMIT = 1e-3
GRAD_REL_LIMIT = 1e-3


def smoke_opt(train: bool = False):
    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(ESOL_CONFIG))
    for k, v in {**SMOKE_OVERRIDES,
                 **(TRAIN_OVERRIDES if train else {})}.items():
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
    """The scale below which a backward output is round-off: max|s|. The
    logit-gradient outputs (d_wd, d_ws, d_vc; d_wn, d_w_ea) are sums of
    p·(d_p − s), which cancel exactly where a row's neighbours carry equal
    features — as at the fconn level of the smoke's batch, at every layer
    — leaving round-off of terms of size |s|. 0 for a forward kernel."""
    if KERNELS[name].fwd is None:
        return 0.0
    return float(args[10 if name == "tcsr_gat_bwd" else 8].abs().max())


class _Capture:
    """Records the arguments of every kernel-wrapper call of one forward
    (the wrappers are looked up through their modules at call time)."""

    def __init__(self):
        from fragnet_tpu_torch.ops import dense_gat, tcsr_gat

        self.mods = {"tcsr_gat_fwd": tcsr_gat, "dense_gat_fwd": dense_gat}
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


LEVELS = {"tcsr_gat_fwd": ["atom (self-loops)", "frag"],
          "dense_gat_fwd": ["bond (R=1)", "fconn (R=6)"]}
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


def layer0_kernel_calls(opt, model, batch):
    """{kernel: [(level, args, kwargs), ...]}: each kernel wrapper's calls in
    layer 0 of one forward of ``model`` on ``batch``."""
    import torch

    with _Capture() as cap, torch.no_grad():
        model(batch)
    n_layers = int(opt.finetune.model.num_layer)
    out = {}
    for name, calls in cap.calls.items():
        if len(calls) != 2 * n_layers:
            raise AssertionError(f"{name}: {len(calls)} calls in one forward")
        out[name] = [(lvl, a, kw) for lvl, (a, kw)
                     in zip(LEVELS[name], calls[:2])]
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
    nbytes = 4 * (planes.numel() + 2 * N * H + N * HD + vc.numel()
                  + N * (HD + 2 * H))
    flops = T * tn * tn * H * (2 * R + 4) + 2 * nnz * HD
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


def _dense_bwd_cost(args):
    planes, wd, ws, nf, vc, m, den, g, s = args[:9]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    D = HD // H
    nnz = int((planes.view(T, R + 1, tn, tn)[:, 0] > 0).sum())
    nbytes = 4 * (planes.numel() + 5 * N * H + 2 * N * HD + vc.numel()
                  + 2 * N * H + N * HD + vc.numel())
    flops = T * tn * tn * H * (2 * R + 6) + nnz * H * (4 * D + 2 * R + 6)
    return nbytes, flops


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
}
# the GAT kernels, which phase 4 captures from a finetune forward
GAT_KERNELS = ("tcsr_gat_fwd", "tcsr_gat_bwd", "dense_gat_fwd",
               "dense_gat_bwd")
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
    k = 7 if fwd_name == "tcsr_gat_fwd" else 5
    return tuple(args[:k]) + (m, den, g, s) + tuple(args[k:])


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
    """Each kernel's launches on ``run_pretrain``'s packed path, derived
    from the loaders: the train steps are the first (shuffled) epoch's
    windows, replayed each epoch by the packed caches, and the process
    stream's epochs have the same count here (one epoch, from epoch 0's
    shuffle); every step and every validation batch runs 4 GAT passes per
    layer — bond and fconn through the dense kernel (the decoded batches'
    device planes, the validation batches' host planes, both checked
    here), atom and frag through the TCSR kernel. K6 runs only in train
    steps, once per plane level the policy reads (dp_bond, dp_fc): the
    validation batches come with host planes. Backward: every layer's
    bond, fconn and atom pass and the last layer's frag pass — the pretrain
    head reads x_atoms, the pooled x_frags of the last layer and the bond
    features e_edge, and each layer recomputes fragment features from
    atoms, so the earlier frag passes are off the loss's path."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import plane_levels
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.train.pretrain import split_graphs

    seed, bs = int(popt.seed), int(popt.pretrain.batch_size)
    L = int(popt.pretrain.model.num_layer)
    train_g, val_g = split_graphs(pgraphs, seed)
    spec = spec_for(pgraphs, batch_size=bs, tcsr=True)
    probe = BatchLoader(train_g, bs, spec=spec, with_targets=True, pack=True)
    next(iter(probe))
    levels = [d[0] for d in probe.layout.dp_specs
              if d[0] in plane_levels(KernelPolicy())]
    if levels != ["dp_bond", "dp_fc"]:
        raise AssertionError(f"device planes for {levels} only")
    n_train = len(list(BatchLoader(train_g, bs, spec=spec, shuffle=True,
                                   seed=seed)._windows()))
    val_w = list(BatchLoader(val_g, bs, spec=spec)._windows())
    for w in val_w:
        hb = pad_batch(w, spec, with_targets=True)
        if hb.dp_bond is None or hb.dp_fc is None:
            raise AssertionError("a validation batch has no host planes")
    steps = n_epochs * n_train
    fwd = L * 2 * (steps + n_validations * len(val_w))
    return {"tcsr_gat_fwd": fwd, "dense_gat_fwd": fwd,
            "tcsr_gat_bwd": (L + 1) * steps, "dense_gat_bwd": 2 * L * steps,
            PLANES: len(levels) * steps}, n_train, len(val_w)


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


def timed_pretrain_step(popt, calls_buf, dev):
    """Phase 13: one pretrain train step at batch 512 from a packed buffer
    on the card — wall time (median of 5 after a warm-up), its stages each
    ended by a synchronize, and one step's device busy time and top ops
    with the plane builder's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)
    from fragnet_tpu_torch.train.optim import make_optimizer
    from fragnet_tpu_torch.train.pretrain import (build_pretrain_model,
                                                  make_pretrain_step,
                                                  pretrain_loss)

    buf, layout = calls_buf
    model = build_pretrain_model(
        popt, generator=torch.Generator().manual_seed(0)).to(dev)
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
            for n in GAT_KERNELS}
    print(f"pretrain step at batch 512 (packed buffer on the card: unpack, "
          f"planes, forward, backward, Adam): wall {wall:.2f} ms (median of "
          f"5 after warm-up), device busy {dev_busy:.3f} ms "
          f"({100 * dev_busy / wall:.1f}%) in {len(busy)} kernel kinds; "
          f"plane builder {k6_ms:.3f} ms "
          f"({100 * k6_ms / max(dev_busy, 1e-9):.1f}% of "
          f"busy); " + ", ".join(f"{n} {ms:.3f}" for n, ms in ours.items())
          + "; top: " + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:10]))
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


def pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev):
    """Phase 14: one pretrain step's loss and gradients — on the card from
    the packed buffer (decoded there, K6 planes), on the CPU from the
    unpacked host batch with host planes; the same weights (the pretraining
    run's checkpoint), dropout off."""
    import copy as _copy

    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import plane_levels, unpack_batch
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.train.checkpoint import load_params
    from fragnet_tpu_torch.train.pretrain import (build_pretrain_model,
                                                  pretrain_loss, split_graphs)

    bs = int(popt.pretrain.batch_size)
    train_g, _ = split_graphs(pgraphs, int(popt.seed))
    spec = spec_for(pgraphs, batch_size=bs, tcsr=True)
    loader = BatchLoader(train_g, bs, spec=spec, with_targets=True, pack=True)
    buf = next(iter(loader))
    host = pad_batch(next(loader._windows()), spec, with_targets=True)
    model = load_params(build_pretrain_model(popt), ckpt).eval()

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
    per-level report, each kernel's launches on the pretraining path)."""
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
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
    expect, n_train, n_val = pretrain_expect(popt, pgraphs, n_epochs,
                                             n_epochs)
    print(f"pretraining path: {n_train} train steps/epoch, {n_val} val "
          f"batches/epoch at batch {popt.pretrain.batch_size}")
    launches, ckpt = drive_pretrain(popt, pgraphs, expect, "HBM")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- 12. the process-stream tier, one epoch ---------------------------
    t0 = time.perf_counter()
    sopt = pt_opt(PT_OVERRIDES, STREAM_OVERRIDES)
    s_expect, _, _ = pretrain_expect(sopt, pgraphs, 1, 1)
    drive_pretrain(sopt, pgraphs, s_expect, "process stream")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # ---- 13. one train step at batch 512 from a packed buffer -------------
    t0 = time.perf_counter()
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    rep = pgraphs * (-(-big_bs // len(pgraphs)))
    big = BatchLoader(rep, big_bs, spec=spec_for(rep, big_bs, tcsr=True),
                      with_targets=True, pack=True)
    dbuf = torch.from_numpy(next(iter(big))).to(dev)
    timed_pretrain_step(popt, (dbuf, big.layout), dev)
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
    return k6_report, launches



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
    from fragnet_tpu_torch.train.loop import make_train_step, mse_loss
    from fragnet_tpu_torch.train.optim import make_optimizer
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    logs = _cuda.build_all([_counter(n)[1] for n in KERNELS], force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(logs)} sources, nvcc in parallel)")
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
    n_layers = int(opt.finetune.model.num_layer)
    spec, windows, batch_np = smoke_batch(opt, datasets)
    dev = torch.device("cuda")
    batch = to_device(batch_np, dev)
    model = build_model(opt, n_classes=n_tasks,
                        generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    t_phase = time.perf_counter()
    # ---- 4. kernel vs plain, at the shapes of a real batch ----------------
    calls = layer0_kernel_calls(opt, model, batch)
    rng = np.random.default_rng(0)
    calls["dense_gat_fwd"].append(
        seeded_fconn_call(calls["dense_gat_fwd"][1], rng))
    for name in GAT_KERNELS:
        k = KERNELS[name]
        if k.fwd is not None:
            calls[name] = [(lvl, bwd_kernel_args(k.fwd, a, kw, rng), {})
                           for lvl, a, kw in calls[k.fwd]]
    report = {}
    for name in GAT_KERNELS:
        k = KERNELS[name]
        mod, _ = _counter(name)
        wrapper, plain = getattr(mod, name), getattr(mod, k.plain)
        per_level, seeded_err = [], 0.0
        for lvl, args, kw in calls[name]:
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            # the seeded case holds each output to its own scale
            floor = 0.0 if lvl == SEEDED else _scale_floor(name, args)
            errs = [_diff(k, p, floor) for k, p in zip(got, want)]
            err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            scales = ", ".join(f"{float(p.abs().max()):.2e}" for p in want)
            if lvl == SEEDED:
                print(f"{name} [{lvl}]: max_abs_err={err:.3e} rel={rel:.3e} "
                      f"(worst of {len(errs)} outputs; output scales "
                      f"{scales})")
                if rel > REL_LIMIT:
                    raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                         f"plain version: rel {rel:.3e}")
                seeded_err = err
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
            shape = "x".join(str(s) for s in args[0].shape)
            print(f"{name} [{lvl}] in0={shape}: max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (worst of {len(errs)} outputs; output "
                  f"scales {scales}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_device_ms={plain_dev_ms:.4f} "
                  f"bound_ms={bound:.5f} ({by}: {nbytes} B, {flops} flop)"
                  + "".join(f" {k_}={v:.4f}" for k_, v in extra.items()))
            if rel > REL_LIMIT:
                raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                     f"plain version: rel {rel:.3e}")
            per_level.append(dict(level=lvl, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                  plain_device_ms=plain_dev_ms,
                                  bound_ms=bound, bound_by=by, bytes=nbytes,
                                  flops=flops, **extra))
        report[name] = (per_level, seeded_err)

    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 5. the prediction path -------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    rmse, ft_model = run_finetune(opt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = _launches()
    expect = {n: (0 if k.fwd or n == PLANES else n_layers * len(windows) * 2)
              for n, k in KERNELS.items()}
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
    n_train = len(train_loader)
    n_val = len(BatchLoader(val_g, bs, spec=spec, n_tasks=n_tasks))
    for _ in range(n_epochs):  # the run's shuffled epochs pack as counted
        if len(list(train_loader._windows())) != n_train:
            raise AssertionError("a train epoch packs more batches than "
                                 "the loader's length")
    # finetune.cache=auto caches the loaders on the device: every epoch runs
    # the cached batches of the first pass, n_train of them (checked above),
    # and the val and test loaders' as many as their windows
    steps = n_epochs * n_train
    fwd_calls = n_layers * 2 * (steps + n_epochs * n_val + len(windows))
    # backward: every layer's bond, fconn and atom pass, but the frag pass
    # of the last layer only — each layer recomputes fragment features from
    # atoms (gat2.py overwrites x_frags), so the earlier layers' frag
    # outputs are off the loss's path and autograd never calls their
    # backward (nor does JAX's, with its symbolic zero cotangents)
    # no plane builder: the finetune batches carry host-built planes
    expect = {"tcsr_gat_fwd": fwd_calls, "dense_gat_fwd": fwd_calls,
              "tcsr_gat_bwd": (n_layers + 1) * steps,
              "dense_gat_bwd": n_layers * 2 * steps, PLANES: 0}
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
    step_model = copy.deepcopy(tr_model)
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
    print(f"train step (batch copy, forward, backward, Adam): wall "
          f"{wall:.2f} ms (median of 5 after warm-up), device busy "
          f"{dev_busy:.3f} ms ({100 * dev_busy / wall:.1f}%) in {len(busy)} "
          f"kernel kinds; the port's kernels: "
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
    print("train step stages (host clock to a synchronize, median of 5): "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms"
                      for k, v in stages.items()))

    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 9. one train step's gradients: CPU vs card -----------------------
    def loss_and_grads(d):
        m_d = copy.deepcopy(tr_model).to(d).eval()  # dropout off
        b_d = to_device(train_np, d)
        loss = mse_loss(m_d(b_d), b_d.y, b_d.graph_mask)
        loss.backward()
        return float(loss.detach()), {
            n: (None if p.grad is None else p.grad.detach().cpu())
            for n, p in m_d.named_parameters()}

    l_gpu, g_gpu = loss_and_grads(dev)
    l_cpu, g_cpu = loss_and_grads(torch.device("cpu"))
    worst, worst_name = _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu)
    print(f"train step cpu vs gpu: loss {l_cpu:.6f} / {l_gpu:.6f}; worst "
          f"relative diff {worst:.3e} ({worst_name}) over {len(g_cpu)} "
          f"parameters (limit {GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU gradients disagree")

    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---- 10.-15. the pretraining path -------------------------------------
    k6_report, launches_pt = pretrain_phases(dev, pending, datasets)
    report[PLANES] = (k6_report, 0.0)

    out = []
    for name, (per_level, seeded_err) in report.items():
        # a GAT kernel: one layer's two levels of one finetune batch; the
        # plane builder: its two levels of one batch-512 pretrain step
        on_path = [p for p in per_level if p.get("on_path", True)]
        tot_bytes = sum(p["bytes"] for p in on_path)
        tot_flops = sum(p["flops"] for p in on_path)
        _, by = _bound_ms(tot_bytes, tot_flops)
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name].source,
            "replaces": KERNELS[name].replaces,
            "launches": launches_pt[name],
            "launches_by_path": {"finetune_train": launches_t[name],
                                 "pretrain": launches_pt[name]},
            "max_abs_err": max([seeded_err]
                               + [p["max_abs_err"] for p in per_level]),
            "ms": sum(p["ms"] for p in on_path),
            "plain_ms": sum(p["plain_ms"] for p in on_path),
            "bound_ms": sum(p["bound_ms"] for p in on_path),
            "bound_by": by,
            "library_ms": (sum(p["library_ms"] for p in on_path)
                           if name == PLANES else None),
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
