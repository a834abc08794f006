#!/usr/bin/env python3
"""A/B device time of the port's CUDA kernels: this checkout's sources
against another version's, on chip_smoke.py's esol batch, in one process on
one card.

    python3 scripts/kernel_ab.py BASE_CSRC_DIR [--rounds 5]

BASE_CSRC_DIR holds the other version's ``*.cu`` (for example the parent
commit's ``fragnet_tpu_torch/csrc``, unpacked with ``git archive``). For
every kernel of chip_smoke.KERNELS whose source differs between the two,
each level's inputs are timed in turns (base, change, change, base) ×
rounds, each turn the device time of 50 calls (torch.profiler, as in
chip_smoke.py): for a GAT kernel its layer-0 inputs of the esol batch (for
a backward kernel, built as chip_smoke.py builds them; for the dense-attr
kernels K7-K9 the atom, fconn and frag inputs of phase 16, under the
dense-attr policy; for K3's forward and backward each shard's bond, atom,
fconn and frag inputs of phase 20, captured in two spawned ranks of one
edge-partitioned train step), for the plane builder its bond, fconn and
atom inputs of chip_smoke.py's batch-512 pretrain batch. A kernel whose
launcher the base does not export (K3 against a version before it) is
skipped. Both versions are also held
against the plain version (limit 1e-4 of scale; the plane builder and the
emit kernel exactly). Prints one line per
level and a JSON line of the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base_csrc")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.ops import _cuda
    from fragnet_tpu_torch.train.finetune import build_model, load_datasets

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    pairs = {}
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
        base = _cuda.CudaKernel(change.source, change.symbol,
                                change.argtypes, csrc=args.base_csrc)
        pairs[name] = {"base": base, "change": change}
    if not pairs:
        return 0
    _cuda.build_all([k for p in pairs.values() for k in p.values()],
                    force=True)

    calls = {}
    gat = set(cs.GAT_KERNELS) | set(cs.ATTR_KERNELS) | set(cs.EP_KERNELS)
    if set(pairs) & gat:
        opt = cs.smoke_opt()
        datasets = load_datasets(opt)
        _spec, _windows, batch_np = cs.smoke_batch(opt, datasets)
        batch = to_device(batch_np, "cuda")
        rng = np.random.default_rng(0)
    if set(pairs) & set(cs.GAT_KERNELS):
        model = build_model(opt, n_classes=datasets[3],
                            generator=torch.Generator().manual_seed(0))
        model = model.to("cuda").eval()
        calls = cs.layer0_kernel_calls(opt, model, batch)
        for name in cs.GAT_KERNELS:
            k = cs.KERNELS[name]
            if k.fwd is not None:
                calls[name] = [(lvl, cs.bwd_kernel_args(k.fwd, a, kw, rng),
                                {}) for lvl, a, kw in calls[k.fwd]]
    if set(pairs) & set(cs.ATTR_KERNELS):
        calls.update({n: [c for c in cl if "seeded" not in c[0]] for n, cl
                      in cs.attr_kernel_calls(datasets[3], batch,
                                              rng).items()})
    if set(pairs) & set(cs.EP_KERNELS):
        kw, sd = cs.smoke_weights(datasets)
        res = cs.ep_step_ranks(kw, sd, cs.ep_train_batch(datasets)[1])
        calls.update({n: [c for c in cl if "seeded" not in c[0]] for n, cl
                      in cs.ep_kernel_calls([r["calls"] for r in res],
                                            rng).items()})
    if cs.PLANES in pairs:
        graphs = cs.PretrainGraphs(cs.pt_opt(cs.PT_OVERRIDES),
                                   workers=os.cpu_count() or 1).get()
        big_bs = int(cs.PT_CONFIG["pretrain"]["batch_size"])
        calls[cs.PLANES] = [(lvl, a, {}) for lvl, a, _host in
                            cs.plane_calls(graphs, big_bs, "cuda")[0]]

    summary = []
    for name, kern in pairs.items():
        mod, _ = cs._counter(name)
        attr = cs.KERNELS[name].counter
        wrapper = getattr(mod, name)
        plain = getattr(mod, cs.KERNELS[name].plain)
        for lvl, a, kw in calls[name]:
            want = cs._outputs(plain(*a, **kw))
            times = {"base": [], "change": []}
            try:
                for which in ("base", "change"):
                    setattr(mod, attr, kern[which])
                    floor = cs._scale_floor(name, a)
                    rel = max(cs._diff(k, p, floor)[1]
                              for k, p in zip(cs._outputs(wrapper(*a, **kw)),
                                              want))
                    limit = (0.0 if name in (cs.PLANES, cs.EMIT)
                             else cs.REL_LIMIT)
                    if rel > limit:
                        raise AssertionError(f"{name} [{lvl}] {which}: "
                                             f"rel {rel:.3e}")
                for _ in range(args.rounds):
                    for which in ("base", "change", "change", "base"):
                        setattr(mod, attr, kern[which])
                        times[which].append(
                            cs._device_ms(lambda: wrapper(*a, **kw)))
            finally:
                setattr(mod, attr, kern["change"])
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
