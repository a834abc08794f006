#!/usr/bin/env python3
"""Device time of the GAT logit terms' kernels (csrc/gat_logits.cu) at the
batch-4096 pretraining step's shapes, beside the plain f64 einsums.

    python3 scripts/logit_terms_ab.py [--calls 20]

The row counts (SHAPES) are the padded capacities of the batch-4096
pretraining step on the UniMol-shaped pool (the PadSpec that perfbench's
``pt-unimol-b4096`` cell packs to), one call a level as the model makes it
(H 4, D 32): bond (prologue: bonds × bond-graph edges, Da 32), atom
(prologue: atoms × bonds, Da 128), fconn (node_logits: connections) and frag
(prologue: fragments × connections, Da 128). For each level: the forward's
and the backward's device ms a call (torch.profiler's CUDA time over
``--calls`` calls, every kernel the call launches and its fills), the same
for the f64 einsums with autograd (the CPU path, run on the card: copies,
cuBLAS f64 GEMMs and casts), the bytes the kernels must move and their
bound at 3.35 TB/s, and the largest ulp gap between the two in the forward
(wn, w_ea) and in the backward (d_a, d_nf, d_ea). Prints a line a level and
a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12


# {level: (node rows, edge rows or 0, Da)}: the padded capacities of the
# batch-4096 pretraining step (PadSpec n_edges, n_bg_edges, n_atoms,
# n_fconn, n_frags of the pt-unimol-b4096 cell's pool, read on the H100)
SHAPES = {"bond": (667904, 3969792, 32),
          "atom": (328960, 667904, 128),
          "fconn": (79616, 0, 32),
          "frag": (43264, 79616, 128)}


def max_ulps(got, want):
    """The largest |got - want| in f32 ulps of ``want``, over pairs."""
    import torch

    gap = 0.0
    for k, p in zip(got, want):
        if k is None or p.numel() == 0:
            continue
        _, e = torch.frexp(p.double())
        ulp = torch.ldexp(torch.ones_like(p, dtype=torch.float64), e - 24)
        gap = max(gap, float(((k.double() - p.double()).abs() / ulp).max()))
    return gap


def device_ms(fn, calls):
    """(device ms a call, {row: ms a call}): the device-side kernel, copy
    and fill rows of torch.profiler over ``calls`` calls, as chip_smoke.py's
    _busy sums them (a CPU op's device time repeats its kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {e.key: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0}
    return sum(rows.values()), rows


def main():
    import numpy as np
    import torch

    from fragnet_tpu_torch.ops import gat_logits

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; {torch.cuda.get_device_name(0)}")
    H, D = 4, 32
    rng = np.random.default_rng(0)
    out = {}
    for level, (N, E, Da) in SHAPES.items():
        f = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        a = f(H, 2 * D + Da).requires_grad_(True)
        nf = f(N, H, D).requires_grad_(True)
        ea = f(E, Da).requires_grad_(True) if E else None
        d_wn, d_wea = f(N, 2 * H), (f(E, H) if E else None)
        outs = [d_wn] + ([d_wea] if E else [])

        def fwd(plain):
            fn = gat_logits.gat_logits_plain if plain \
                else gat_logits.logit_terms
            with torch.no_grad():
                return fn(nf, ea, a, Da)

        def step(plain):
            fn = gat_logits.gat_logits_plain if plain \
                else gat_logits.logit_terms
            wn, w_ea = fn(nf, ea, a, Da)
            ys = [wn] + ([w_ea] if E else [])
            return torch.autograd.grad(
                ys, [t for t in (a, nf, ea) if t is not None], outs)

        r = {"rows": [N, E], "Da": Da}
        for name, plain in (("kernel", False), ("plain", True)):
            r[f"{name}_fwd_ms"], _ = device_ms(lambda: fwd(plain), args.calls)
            r[f"{name}_fwd_bwd_ms"], rows = device_ms(lambda: step(plain),
                                                      args.calls)
            r[f"{name}_bwd_ms"] = r[f"{name}_fwd_bwd_ms"] - r[f"{name}_fwd_ms"]
            r[f"{name}_rows"] = dict(sorted(rows.items(),
                                            key=lambda kv: -kv[1])[:6])
        fwd_bytes = 4 * (N * H * D + E * Da + N * 2 * H + E * H)
        bwd_bytes = 4 * (2 * N * H * D + 2 * E * Da + N * 2 * H + E * H)
        r["fwd_bound_ms"] = fwd_bytes / HBM_BYTES_PER_S * 1e3
        r["bwd_bound_ms"] = bwd_bytes / HBM_BYTES_PER_S * 1e3
        r["fwd_bytes"], r["bwd_bytes"] = fwd_bytes, bwd_bytes
        r["fwd_max_ulps"] = max_ulps(fwd(False), fwd(True))
        r["bwd_max_ulps"] = max_ulps(step(False), step(True))
        out[level] = r
        print(f"{level}: rows {N} x {E} (Da {Da}): kernel fwd "
              f"{r['kernel_fwd_ms']:.4f} bwd {r['kernel_bwd_ms']:.4f} ms; "
              f"plain fwd {r['plain_fwd_ms']:.4f} bwd {r['plain_bwd_ms']:.4f}"
              f" ms; bound {r['fwd_bound_ms']:.4f} / {r['bwd_bound_ms']:.4f}"
              f" ms; gap fwd {r['fwd_max_ulps']:.1f} / bwd "
              f"{r['bwd_max_ulps']:.1f} ulp", flush=True)
    print(json.dumps({"card": card.strip(), "levels": out}))


if __name__ == "__main__":
    main()
