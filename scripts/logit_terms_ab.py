#!/usr/bin/env python3
"""Device time of a GAT pass's logit terms on one card, forward and
backward, in four forms: f32 products (torch's einsum / mm in f32), and
f64 products (each term summed in f64 and rounded once) by einsum and mm
(the port's form, ops/tcsr_gat.py:prologue), as one matmul against a
block-diagonal attention matrix, and as an elementwise product and a
sum.

    python3 scripts/logit_terms_ab.py [--reps 50]

The terms are those of ops/tcsr_gat.py:prologue: wn = [nf·a_dst | nf·a_src]
per head (N, 2H) and w_ea = ea·a_ea (E, H). Shapes: H 4, D 32, Da 128 (the
esol and unimol widths), at the row counts of one finetune batch's atom
level (N 1024, E 2048) and of a batch-512 pretraining batch's bond level
(N 16384, E 32768). Each form runs forward and backward of Σ (wn·gn) +
Σ (w_ea·ge) for seeded cotangents, timed with CUDA events (median of
``reps`` after a warm-up) and under torch.profiler (the device time and
the device kernels of one call), with each form's largest distance from
the f64 einsum form's values (relative to their scale). Prints one line
per form and shape, and a JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

H, D, DA = 4, 32, 128
SHAPES = {"finetune atom": (1024, 2048), "batch-512 bond": (16384, 32768)}


def f32_terms(nf, ea, a):
    a_dst, a_ea, a_src = a[:, :D], a[:, D:D + DA], a[:, D + DA:]
    import torch
    wn = torch.cat([torch.einsum("nhd,hd->nh", nf, a_dst),
                    torch.einsum("nhd,hd->nh", nf, a_src)], dim=-1)
    return wn, ea @ a_ea.T


def f64_einsum_terms(nf, ea, a):
    import torch
    a_nodes = torch.stack([a[:, :D], a[:, D + DA:]])
    wn = torch.einsum("nhd,khd->nkh", nf.double(), a_nodes.double())
    w_ea = ea.double() @ a[:, D:D + DA].double().T
    return wn.reshape(nf.shape[0], 2 * H).float(), w_ea.float()


def f64_blockdiag_terms(nf, ea, a):
    import torch
    N = nf.shape[0]
    eye = torch.eye(H, dtype=torch.float64, device=nf.device)
    a64 = a.double()
    # (H·D, 2H): column k·H + h holds a_k[h] in rows h·D .. h·D + D - 1
    cols = [(a64[:, :D][:, :, None] * eye[:, None, :]).reshape(H * D, H),
            (a64[:, D + DA:][:, :, None] * eye[:, None, :]).reshape(H * D, H)]
    wn = nf.reshape(N, H * D).double() @ torch.cat(cols, dim=1)
    w_ea = ea.double() @ a64[:, D:D + DA].T
    return wn.float(), w_ea.float()


def f64_elementwise_terms(nf, ea, a):
    import torch
    nf64, a64 = nf.double(), a.double()
    wn = torch.cat([(nf64 * a64[:, :D]).sum(-1),
                    (nf64 * a64[:, D + DA:]).sum(-1)], dim=-1)
    w_ea = ea.double() @ a64[:, D:D + DA].T
    return wn.float(), w_ea.float()


FORMS = {"f32": f32_terms, "f64 einsum": f64_einsum_terms,
         "f64 block-diagonal": f64_blockdiag_terms,
         "f64 elementwise": f64_elementwise_terms}


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("logit_terms_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = []
    for label, (N, E) in SHAPES.items():
        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)

        nf, ea, a = draw(N, H, D), draw(E, DA), draw(H, 2 * D + DA)
        gn, ge = draw(N, 2 * H), draw(E, H)
        ref = [t.double() for t in f64_einsum_terms(nf, ea, a)]
        for name, fn in FORMS.items():
            xs = [t.clone().requires_grad_() for t in (nf, ea, a)]

            def step():
                wn, w_ea = fn(*xs)
                torch.autograd.grad((wn * gn).sum() + (w_ea * ge).sum(), xs)

            vals = fn(nf, ea, a)
            err = max(float((v.double() - r).abs().max()
                            / r.abs().max()) for v, r in zip(vals, ref))
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            times = []
            for _ in range(args.reps):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                step()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
            dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
            kernels = sum(e.count for e in rows)
            rec = dict(shape=label, form=name, ms=statistics.median(times),
                       device_ms=dev_ms, device_kernels=kernels,
                       max_rel_vs_f64=err)
            out.append(rec)
            print(f"{label} (N {N}, E {E}) {name}: ms {rec['ms']:.4f}, "
                  f"device ms {dev_ms:.4f} in {kernels} kernels, max "
                  f"|value - f64 einsum| / scale {err:.2e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
