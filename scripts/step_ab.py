#!/usr/bin/env python3
"""A/B the finetune train step (batch copy, forward, backward, Adam) of
this checkout against another checkout, on chip_smoke.py's esol train
batch, under the default and the dense-attr kernel policies, on one card.

    python3 scripts/step_ab.py BASE_ROOT [--rounds 2] [--steps 20]

BASE_ROOT is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into exps/parent). This checkout featurizes
the esol set once and pickles the train batch of chip_smoke.py's phase 8
under exps/step_ab/. Each turn is a fresh process that imports one
checkout's fragnet_tpu_torch, builds its kernels (once per checkout),
builds the model from seed 0 under each policy (a step that does not run
its policy's kernels raises), runs 3 warm-up steps,
times ``--steps`` steps each ended by a synchronize (host clock; the
median is the step's wall) and profiles one more (device busy time, as
chip_smoke.py counts it, and the launches of device kernels). The turns
run base, change, change, base, ``rounds`` times.

Then, in this checkout, the dense backward's s = sum_d g*out
(ops/dense_gat.py:head_dot, summed in the kernel's order) against the
plain two-op sum, at the (g, out) shapes one train step gives it: the
device kernels and device time each launches per call, and its host time
per call. Prints one line per turn and per comparison, and a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "exps", "step_ab")
POLICIES = ("default", "dense-attr")


def featurize(path: str) -> None:
    """Pickle {"train_np", "n_tasks"}: chip_smoke.py's phase 8 batch."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.train.finetune import load_datasets

    opt = cs.smoke_opt()
    datasets = load_datasets(opt)
    train_g, _val, _test, n_tasks, _task = datasets
    spec, _windows, _batch = cs.smoke_batch(opt, datasets)
    topt = cs.smoke_opt(train=True)
    loader = BatchLoader(train_g, int(opt.finetune.batch_size), spec=spec,
                         shuffle=True, seed=int(topt.seed), n_tasks=n_tasks)
    train_np = pad_batch(next(iter(loader._windows())), spec,
                         n_tasks=n_tasks)
    with open(path, "wb") as f:
        pickle.dump({"train_np": train_np, "n_tasks": n_tasks}, f)


def turn(root: str, path: str, steps: int) -> dict:
    """One checkout's step under each policy: {policy: {wall_ms, runs,
    busy_ms, kernels}}. ``root``'s package is imported first on the
    path; chip_smoke.py of this checkout supplies the configs and the
    profile's reading."""
    import importlib.util

    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    # this checkout's chip_smoke.py, over root's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import fragnet_tpu_torch
    from fragnet_tpu_torch.ops import _cuda, dense_gat, tcsr_gat  # noqa: F401
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model
    from fragnet_tpu_torch.train.loop import make_train_step
    from fragnet_tpu_torch.train.optim import make_optimizer

    if not os.path.abspath(fragnet_tpu_torch.__file__).startswith(
            os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {fragnet_tpu_torch.__file__}, not "
                           f"the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all(_cuda.REGISTRY)
    with open(path, "rb") as f:
        data = pickle.load(f)
    train_np = data["train_np"]
    res = {}
    for policy in POLICIES:
        opt = cs.smoke_opt(train=True, attr=policy == "dense-attr")
        model = build_model(opt, n_classes=data["n_tasks"],
                            policy=resolve_kernel_policy(opt.finetune),
                            generator=torch.Generator().manual_seed(0))
        model = model.to("cuda")
        optim, _ = make_optimizer(model.parameters(), "adam", lr=1e-4)
        step = make_train_step(model, optim, "mse", "cuda")
        for _ in range(3):
            step(train_np)
        walls = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(train_np)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(train_np)
            torch.cuda.synchronize()
        busy, rows = cs._busy(prof)
        if (policy == "dense-attr") != any("dense_attr_fwd_kernel" in k
                                           for k, _ in rows):
            raise RuntimeError(f"the {policy} step did not run the kernels "
                               f"of its policy")
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0)
        res[policy] = {"wall_ms": statistics.median(walls),
                       "runs": [round(w, 3) for w in walls],
                       "busy_ms": busy, "device_ops": launches}
    return res


def head_dot_cost(path: str, calls: int = 200) -> list:
    """For each (g, out, H) one train step under the default policy gives
    DenseGatFn's backward: device ops and device ms per call and host ms
    per call of head_dot and of the plain sum (g*out).sum(-1)."""
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from fragnet_tpu_torch.ops import dense_gat
    from fragnet_tpu_torch.train.finetune import build_model
    from fragnet_tpu_torch.train.loop import make_train_step
    from fragnet_tpu_torch.train.optim import make_optimizer

    with open(path, "rb") as f:
        data = pickle.load(f)
    seen = []
    orig = dense_gat.head_dot

    def spy(g, out, H):
        seen.append((tuple(g.shape), H))
        return orig(g, out, H)

    opt = cs.smoke_opt(train=True)
    model = build_model(opt, n_classes=data["n_tasks"],
                        generator=torch.Generator().manual_seed(0)).cuda()
    optim, _ = make_optimizer(model.parameters(), "adam", lr=1e-4)
    dense_gat.head_dot = spy
    try:
        make_train_step(model, optim, "mse", "cuda")(data["train_np"])
    finally:
        dense_gat.head_dot = orig
    torch.cuda.synchronize()
    rng = torch.Generator(device="cuda").manual_seed(0)
    fns = {"head_dot": lambda g, o, H: orig(g, o, H),
           "plain": lambda g, o, H: (g.view(g.shape[0], H, -1)
                                     * o.view(g.shape[0], H, -1)).sum(-1)}
    report = []
    for shape, H in sorted(set(seen)):
        g = torch.randn(shape, device="cuda", generator=rng)
        o = torch.randn(shape, device="cuda", generator=rng)
        row = {"shape": list(shape), "H": H,
               "per_step": sum(1 for s in seen if s == (shape, H))}
        for name, fn in fns.items():
            for _ in range(10):
                fn(g, o, H)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(g, o, H)
                torch.cuda.synchronize()
            busy, _rows = cs._busy(prof)
            ops = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and e.self_device_time_total > 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(g, o, H)
            host = (time.perf_counter() - t0) * 1e3 / calls
            torch.cuda.synchronize()
            row[name] = {"device_ops": ops, "device_ms": busy,
                         "host_ms": host}
        report.append(row)
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base_root", nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "PICKLE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(*args.turn, args.steps)))
        return 0
    if args.base_root is None:
        ap.error("BASE_ROOT is required")

    import torch

    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "train_batch.pkl")
    t0 = time.perf_counter()
    featurize(path)
    print(f"featurization: {time.perf_counter() - t0:.1f} s")
    roots = {"base": os.path.abspath(args.base_root), "change": REPO}
    runs = {w: {p: [] for p in POLICIES} for w in roots}
    busy = {w: {p: [] for p in POLICIES} for w in roots}
    for _ in range(args.rounds):
        for which in ("base", "change", "change", "base"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 roots[which], path, "--steps", str(args.steps)],
                capture_output=True, text=True, cwd=roots[which])
            if out.returncode != 0:
                print(out.stdout[-4000:], out.stderr[-4000:],
                      file=sys.stderr)
                raise RuntimeError(f"{which} turn failed")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"{which}: " + "; ".join(
                f"{p} wall {r['wall_ms']:.2f} ms, busy {r['busy_ms']:.3f} ms"
                f", {r['device_ops']} device ops" for p, r in res.items()))
            for p, r in res.items():
                runs[which][p].extend(r["runs"])
                busy[which][p].append(r["busy_ms"])
    summary = {p: {w: {"wall_ms": statistics.median(runs[w][p]),
                       "busy_ms": statistics.median(busy[w][p])}
                   for w in roots} for p in POLICIES}
    for p, s in summary.items():
        print(f"{p} step: base wall {s['base']['wall_ms']:.2f} ms, busy "
              f"{s['base']['busy_ms']:.3f} ms; change wall "
              f"{s['change']['wall_ms']:.2f} ms, busy "
              f"{s['change']['busy_ms']:.3f} ms (median over "
              f"{len(runs['base'][p])} steps each)")
    hd = head_dot_cost(path)
    for row in hd:
        print(f"s at g {row['shape']} H={row['H']} ({row['per_step']} per "
              f"step): " + "; ".join(
                  f"{n} {row[n]['device_ops']} device ops, "
                  f"{row[n]['device_ms']:.4f} device ms, "
                  f"{row[n]['host_ms']:.4f} host ms"
                  for n in ("head_dot", "plain")))
    print(json.dumps({"step_ab": summary, "head_dot": hd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
