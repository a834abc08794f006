#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's prediction path — the gat2 ESOL recipe
(configs/ft/esol.yaml, full width: 4 layers, emb 128, 4 heads, FTHead3
128/1024/1024/512, batch 16) with ``finetune.n_epochs=0`` on synthetic
molecules — through ``run_finetune`` on the card, and holds every kernel of
that path against its plain PyTorch version. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. featurize the esol-config dataset (host);
  4. each kernel against its plain version on the card, at every level it
     serves, with tensors captured from a real esol-config batch: max abs
     and relative diff (limit 1e-4 of the output's scale), the kernel's and
     the plain version's ms (CUDA events around each call, median of 50
     after warm-up — host dispatch included), their device time per call
     (torch.profiler's CUDA activity over 50 calls) and the bytes/operations
     bound;
  5. the main path: run_finetune on cuda with every launch count set to 0
     just before it; each kernel must have launched layers × batches × 2
     times (two levels each per layer), which also shows no GAT pass took
     the segment path (that path raises on CUDA tensors); then a second
     pass over the test batches times padding, copy and forward, and the
     profiler gives one forward's device busy time and top ops;
  6. the whole forward on the CPU (plain versions) and on the card
     (kernels) with the same weights and batch: predictions within 1e-3 of
     their scale, finite, of shape (G, n_tasks).

Prints a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, without a
CUDA device, or when run outside a checkout of the repository.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

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

# the smoke's overrides of ESOL_CONFIG (dotted path → value)
SMOKE_OVERRIDES = {
    "finetune.n_epochs": 0,
    "finetune.data.n_synthetic": 96,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol"),
}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REL_LIMIT = 1e-4
FORWARD_REL_LIMIT = 1e-3


def smoke_opt():
    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(ESOL_CONFIG))
    for k, v in SMOKE_OVERRIDES.items():
        opt.set_path(k, v)
    return opt


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


def _diff(k, p):
    """(max abs diff, max abs diff / max|plain|) over entries that are not
    the −1e30 empty-row marker; the markers must agree exactly."""
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
    return err, err / max(float(p.abs().max()), 1e-30)


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


def _bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def main() -> int:
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
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.ops import _cuda, dense_gat, tcsr_gat
    from fragnet_tpu_torch.train.finetune import (build_model,
                                                  load_datasets,
                                                  run_finetune)

    kernels = {"tcsr_gat_fwd": tcsr_gat, "dense_gat_fwd": dense_gat}
    t0 = time.perf_counter()
    logs = _cuda.build_all([m.KERNEL for m in kernels.values()], force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(logs)} sources, nvcc in parallel)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # ---- 3. data ----------------------------------------------------------
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

    # ---- 4. kernel vs plain, at the shapes of a real batch ----------------
    calls = layer0_kernel_calls(opt, model, batch)
    plain = {"tcsr_gat_fwd": tcsr_gat.tcsr_gat_fwd_plain,
             "dense_gat_fwd": dense_gat.dense_gat_fwd_plain}
    cost = {"tcsr_gat_fwd": _tcsr_cost, "dense_gat_fwd": _dense_cost}
    report = {}
    for name, mod in kernels.items():
        per_level = []
        for lvl, args, kw in calls[name]:
            wrapper = getattr(mod, name)
            got = wrapper(*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            errs = [_diff(k, p) for k, p in zip(got, want)]
            err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            ms = _median_ms(lambda: wrapper(*args, **kw))
            plain_ms = _median_ms(lambda: plain[name](*args, **kw))
            dev_ms = _device_ms(lambda: wrapper(*args, **kw))
            plain_dev_ms = _device_ms(lambda: plain[name](*args, **kw))
            nbytes, flops = cost[name](args)
            bound, by = _bound_ms(nbytes, flops)
            shape = "x".join(str(s) for s in args[0].shape)
            print(f"{name} [{lvl}] in0={shape}: max_abs_err={err:.3e} "
                  f"rel={rel:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_device_ms={plain_dev_ms:.4f} "
                  f"bound_ms={bound:.5f} ({by}: {nbytes} B, {flops} flop)")
            if rel > REL_LIMIT:
                raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                     f"plain version: rel {rel:.3e}")
            per_level.append(dict(level=lvl, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                  plain_device_ms=plain_dev_ms,
                                  bound_ms=bound, bound_by=by, bytes=nbytes,
                                  flops=flops))
        report[name] = per_level

    # ---- 5. the main path -------------------------------------------------
    for mod in kernels.values():
        mod.KERNEL.launches = 0
    t0 = time.perf_counter()
    rmse, ft_model = run_finetune(opt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {n: m.KERNEL.launches for n, m in kernels.items()}
    n_layers = int(opt.finetune.model.num_layer)
    expect = n_layers * len(windows) * 2
    print(f"main path: test rmse {rmse:.5f} eval {eval_s:.2f} s "
          f"({len(windows)} test batches)")
    print("kernels: " + " ".join(f"{n}={c}" for n, c in launches.items())
          + f" (expected {expect} each)")
    if not (rmse == rmse and abs(rmse) < float("inf")):
        raise AssertionError(f"test rmse is not finite: {rmse}")
    for n, c in launches.items():
        if c != expect:
            raise AssertionError(f"{n} launched {c} times on the main path, "
                                 f"expected {expect}")

    # where the eval's time goes: a second pass over the test batches, each
    # stage timed to a synchronize, then the forward's device time under
    # the profiler
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from torch.profiler import ProfilerActivity, profile

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
    busy = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy.sort(key=lambda kv: -kv[1])
    dev_busy = sum(ms for _, ms in busy)
    print(f"eval breakdown ({len(windows)} batches): pad_batch "
          f"{t_pad * 1e3:.2f} ms, to_device {t_copy * 1e3:.2f} ms, forward "
          f"{t_fwd * 1e3:.2f} ms; one forward's device busy time "
          f"{dev_busy:.3f} ms in {sum(1 for _ in busy)} op kinds, top: "
          + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:5]))

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

    sources = {"tcsr_gat_fwd": ("fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                                "fragnet_tpu/ops/pallas_gat.py:105"),
               "dense_gat_fwd": ("fragnet_tpu_torch/csrc/dense_gat_fwd.cu",
                                 "fragnet_tpu/ops/dense_gat.py:387")}
    out = []
    for name, per_level in report.items():
        tot_bytes = sum(p["bytes"] for p in per_level)
        tot_flops = sum(p["flops"] for p in per_level)
        _, by = _bound_ms(tot_bytes, tot_flops)
        out.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(p["max_abs_err"] for p in per_level),
            # one layer's two levels of one batch
            "ms": sum(p["ms"] for p in per_level),
            "plain_ms": sum(p["plain_ms"] for p in per_level),
            "bound_ms": sum(p["bound_ms"] for p in per_level),
            "bound_by": by, "library_ms": None,
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
