#!/usr/bin/env python3
"""A/B device time of the port's CUDA kernels: this checkout's sources
against another version's, on chip_smoke.py's esol batch, in one process on
one card.

    python3 scripts/kernel_ab.py BASE_CSRC_DIR [--rounds 5]

BASE_CSRC_DIR holds the other version's ``*.cu`` and sits in that
version's package, whose ``ops/`` holds its wrappers (for example the
parent commit's ``fragnet_tpu_torch``, unpacked with ``git archive HEAD
fragnet_tpu_torch | tar -x -C exps/parent``, and BASE_CSRC_DIR
``exps/parent/fragnet_tpu_torch/csrc``). Each version runs through its own
wrapper (the base's ``ops/<module>.py`` loaded under another name, its
kernels built from BASE_CSRC_DIR), so a version's C interface and the work
its wrapper does around the kernel (output fills) go with it, and a turn's
device time holds both. For every kernel of chip_smoke.KERNELS whose source
differs between the two,
each level's inputs are timed in turns (base, change, change, base) ×
rounds, each turn the device time of 50 calls (torch.profiler, as in
chip_smoke.py): for a GAT kernel its layer-0 inputs of the esol batch (for
a backward kernel, built as chip_smoke.py builds them; for the dense-attr
kernels K7-K9 the atom, fconn and frag inputs of phase 16, under the
dense-attr policy; for K3's forward and backward each shard's bond, atom,
fconn and frag inputs of phase 20, captured in two spawned ranks of one
edge-partitioned train step), for the plane builder its bond, fconn and
atom inputs of chip_smoke.py's batch-512 pretrain batch. The TCSR forward
and backward (K1, K2) and the dense forward and backward (K4, K5) are also
timed at that batch's layer-0 inputs (atom and frag; bond and fconn),
captured as phase 13 captures them, and the dense-attr kernels (K7-K9) at
its atom, fconn and frag inputs under the dense-attr policy, captured as
phase 16 captures them (levels tagged "batch 512"). A kernel whose
launcher the base does not export (K3 against a version before it) is
skipped. Both versions are also held
against the plain version (limit 1e-4 of scale; the plane builder and the
emit kernel exactly). Prints one line per
level and a JSON line of the medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def capture_calls(names):
    """{kernel: [(level, args, kwargs)]} for the kernels ``names``: their
    inputs at the levels chip_smoke.py holds them at (see the module's
    docstring), on the card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.finetune import build_model, load_datasets

    calls = {}
    gat = set(cs.GAT_KERNELS) | set(cs.ATTR_KERNELS) | set(cs.EP_KERNELS)
    if names & gat:
        opt = cs.smoke_opt()
        datasets = load_datasets(opt)
        _spec, _windows, batch_np = cs.smoke_batch(opt, datasets)
        batch = to_device(batch_np, "cuda")
        rng = np.random.default_rng(0)
    if names & set(cs.GAT_KERNELS):
        model = build_model(opt, n_classes=datasets[3],
                            generator=torch.Generator().manual_seed(0))
        model = model.to("cuda").eval()
        calls = cs.layer0_kernel_calls(int(opt.finetune.model.num_layer),
                                       model, batch)
        for name in cs.GAT_KERNELS:
            k = cs.KERNELS[name]
            if k.fwd is not None:
                calls[name] = [(lvl, cs.bwd_kernel_args(k.fwd, a, kw, rng),
                                {}) for lvl, a, kw in calls[k.fwd]]
    if names & set(cs.ATTR_KERNELS):
        calls.update({n: [c for c in cl if "seeded" not in c[0]] for n, cl
                      in cs.attr_kernel_calls(datasets[3], batch,
                                              rng).items()})
    if names & set(cs.EP_KERNELS):
        kw, sd = cs.smoke_weights(datasets)
        res = cs.ep_step_ranks(kw, sd, cs.ep_train_batch(datasets)[1])
        calls.update({n: [c for c in cl if "seeded" not in c[0]] for n, cl
                      in cs.ep_kernel_calls([r["calls"] for r in res],
                                            rng).items()})
    big = names & set(cs.BIG_KERNELS)
    big_attr = names & set(cs.ATTR_KERNELS)
    if cs.PLANES in names or big or big_attr:
        popt = cs.pt_opt(cs.PT_OVERRIDES)
        graphs = cs.PretrainGraphs(popt, workers=os.cpu_count() or 1).get()
    if cs.PLANES in names:
        big_bs = int(cs.PT_CONFIG["pretrain"]["batch_size"])
        calls[cs.PLANES] = [(lvl, a, {}) for lvl, a, _host in
                            cs.plane_calls(graphs, big_bs, "cuda")[0]]
    if big:
        from fragnet_tpu_torch.train.pretrain import build_pretrain_model

        pmodel = build_pretrain_model(
            popt, generator=torch.Generator().manual_seed(0)).to("cuda")
        for name, cl in cs.pretrain_kernel_calls(
                popt, pmodel, *cs.pretrain_big_batch(graphs, "cuda"),
                np.random.default_rng(13)).items():
            if name in big:
                calls[name] = calls[name] + cl
    if big_attr:
        for name, cl in cs.pretrain_attr_kernel_calls(
                cs.pretrain_big_batch(graphs, "cuda"), "cuda",
                np.random.default_rng(16)).items():
            if name in big_attr:
                calls[name] = calls[name] + cl

    return calls


def base_module(module, base_csrc):
    """The base version's wrapper module ``ops/<module>.py`` (beside
    ``base_csrc``), loaded under another name, with every kernel it defines
    built from ``base_csrc`` and kept out of the port's registry."""
    from fragnet_tpu_torch.ops import _cuda

    path = os.path.join(os.path.dirname(os.path.abspath(base_csrc)), "ops",
                        f"{module}.py")
    spec = importlib.util.spec_from_file_location(f"base_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    n_reg = len(_cuda.REGISTRY)
    spec.loader.exec_module(mod)
    del _cuda.REGISTRY[n_reg:]
    for attr, k in list(vars(mod).items()):
        if isinstance(k, _cuda.CudaKernel):
            setattr(mod, attr, _cuda.CudaKernel(k.source, k.symbol,
                                                k.argtypes, csrc=base_csrc))
    return mod


def output_errors(fn, want, floor):
    """Each output of ``fn()`` against ``want``: its error relative to its
    scale (chip_smoke._diff)."""
    import chip_smoke as cs

    return [cs._diff(k, p, floor)[1] for k, p in zip(cs._outputs(fn()), want)]


def time_turns(versions, rounds):
    """{version: [device ms per turn]}: each of ``versions`` ({name:
    callable}) timed (50 calls, chip_smoke._device_ms) in turns: the
    versions in order, then in reverse (for two: base, change, change,
    base), ``rounds`` times."""
    import chip_smoke as cs

    order = list(versions) + list(versions)[::-1]
    times = {v: [] for v in versions}
    for _ in range(rounds):
        for which in order:
            times[which].append(cs._device_ms(versions[which]))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base_csrc")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fragnet_tpu_torch.ops import _cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    pairs, bases = {}, {}
    for name in cs.KERNELS:
        _mod, change = cs._counter(name)
        base_path = os.path.join(args.base_csrc, change.source)
        if not os.path.exists(base_path):
            print(f"{name}: no {change.source} in the base, skipped")
            continue
        with open(change.path, "rb") as f, open(base_path, "rb") as g:
            ours, theirs = f.read(), g.read()
        if ours == theirs:
            print(f"{name}: same source, skipped")
            continue
        if f'"C" int {change.symbol}('.encode() not in theirs:
            print(f"{name}: the base exports no {change.symbol}, skipped")
            continue
        module = cs.KERNELS[name].module
        if module not in bases:
            bases[module] = base_module(module, args.base_csrc)
        pairs[name] = {"base": getattr(bases[module], name),
                       "change": getattr(_mod, name)}
    if not pairs:
        return 0
    changed = [cs._counter(n)[1] for n in pairs]
    symbols = {k.symbol for k in changed}
    _cuda.build_all([k for m in bases.values() for k in vars(m).values()
                     if isinstance(k, _cuda.CudaKernel)
                     and k.symbol in symbols] + changed, force=True)

    calls = capture_calls(set(pairs))

    summary = []
    for name, wrappers in pairs.items():
        mod, _ = cs._counter(name)
        plain = getattr(mod, cs.KERNELS[name].plain)
        for lvl, a, kw in calls[name]:
            want = cs._outputs(plain(*a, **kw))
            limit = 0.0 if name in (cs.PLANES, cs.EMIT) else cs.REL_LIMIT
            fns = {which: (lambda w=w: w(*a, **kw))
                   for which, w in wrappers.items()}
            for which, fn in fns.items():
                rel = max(output_errors(fn, want, cs._scale_floor(name, a)))
                if rel > limit:
                    raise AssertionError(f"{name} [{lvl}] {which}: "
                                         f"rel {rel:.3e}")
            times = time_turns(fns, args.rounds)
            med = {k: statistics.median(v) for k, v in times.items()}
            wins = sum(c < b for b, c in zip(times["base"], times["change"]))
            print(f"{name} [{lvl}]: base {med['base']:.4f} ms, change "
                  f"{med['change']:.4f} ms (change faster in {wins}/"
                  f"{len(times['base'])} pairs); base runs "
                  f"{[round(x, 4) for x in times['base']]}, change runs "
                  f"{[round(x, 4) for x in times['change']]}")
            summary.append({"kernel": name, "level": lvl,
                            "base_ms": med["base"],
                            "change_ms": med["change"], "wins": wins,
                            "pairs": len(times["base"])})
    print(json.dumps({"kernel_ab": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
