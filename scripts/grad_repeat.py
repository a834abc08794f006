#!/usr/bin/env python3
"""Do one finetune train step's gradients repeat bit for bit on the card?

    python3 scripts/grad_repeat.py [--repeats 5] [--policy dense-attr]

Builds chip_smoke.py's esol model (seeded weights, dropout off) under the
default kernel policy or, with ``--policy dense-attr``, under the
dense-attr policy (K7-K9 carry the atom, frag and fconn passes), and its
first train batch, and computes the loss's gradient ``--repeats`` times on
the card from the same weights and batch, in one process: first as the
port runs (PyTorch's default algorithms), then with
``torch.use_deterministic_algorithms(True)``, which makes PyTorch's own
scatter-adds (``index_add_``, the backward of indexing) sum in a fixed
order (an op that has no deterministic version on the card warns, and its
name is printed). Prints, for each mode, how many parameters' gradients
are not the same bits in every repeat, the worst spread between repeats
relative to the gradient's scale, and the names of the parameters that
vary. Where the
deterministic mode repeats exactly, what varies in the default mode comes
from PyTorch's atomics, not from the port's kernels.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grads(model, batch, dev):
    """{parameter name: gradient on the CPU} of the mse loss of one forward
    of a copy of ``model`` on ``batch`` (dropout off)."""
    from fragnet_tpu_torch.train.loop import mse_loss

    m = copy.deepcopy(model).to(dev).eval()
    loss = mse_loss(m(batch), batch.y, batch.graph_mask)
    loss.backward()
    return {n: p.grad.detach().cpu() for n, p in m.named_parameters()
            if p.grad is not None}


def spread(runs):
    """(names of the parameters whose gradients differ between runs, worst
    max|run - first run| / max|first run| over all parameters)."""
    varying, worst = [], 0.0
    for name, first in runs[0].items():
        for other in runs[1:]:
            if not bool((other[name] == first).all()):
                varying.append(name)
                scale = max(float(first.abs().max()), 1e-30)
                worst = max(worst, float((other[name] - first).abs().max())
                            / scale)
                break
    return varying, worst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--policy", choices=("default", "dense-attr"),
                    default="default")
    args = ap.parse_args()
    # cuBLAS needs a fixed workspace for deterministic products
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    if not torch.cuda.is_available():
        print("grad_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model, load_datasets

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = cs.smoke_opt(train=True, attr=args.policy == "dense-attr")
    datasets = load_datasets(opt)
    train_g, _val, _test, n_tasks, _task = datasets
    spec, _windows, _b = cs.smoke_batch(opt, datasets)
    loader = BatchLoader(train_g, int(opt.finetune.batch_size), spec=spec,
                         shuffle=True, seed=int(opt.seed), n_tasks=n_tasks)
    dev = torch.device("cuda")
    batch = to_device(pad_batch(next(iter(loader._windows())), spec,
                                n_tasks=n_tasks), dev)
    policy = resolve_kernel_policy(opt.finetune)
    model = build_model(opt, n_classes=n_tasks, policy=policy,
                        generator=torch.Generator().manual_seed(0))
    print(f"policy {args.policy}: {policy}")

    report = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [grads(model, batch, dev) for _ in range(args.repeats)]
        nondet = sorted({str(w.message).split(".")[0] for w in caught
                         if "deterministic" in str(w.message)})
        varying, worst = spread(runs)
        report[mode] = {"parameters": len(runs[0]), "varying": len(varying),
                        "worst_rel_spread": worst, "names": varying,
                        "nondeterministic_ops": nondet}
        print(f"{mode}: {len(varying)} of {len(runs[0])} parameters' "
              f"gradients differ between {args.repeats} repeats (worst "
              f"spread {worst:.3e} of scale): {varying}; ops without a "
              f"deterministic version: {nondet}")
    torch.use_deterministic_algorithms(False)
    print(json.dumps({"grad_repeat": report, "policy": args.policy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
