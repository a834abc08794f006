#!/usr/bin/env python3
"""Where K5's time goes: device time of the dense GAT backward kernel
(fragnet_tpu_torch/csrc/dense_gat_bwd.cu) against copies of it with one
part taken out, at the levels scripts/kernel_ab.py times it (layer 0 of
chip_smoke.py's esol batch, bond and fconn, and of its batch-512
pretraining step), in one process on one card.

    python3 scripts/k5_ablation.py [--rounds 3]

Each variant is the checkout's source with a few exact text replacements
(each must match once, so a changed kernel fails here loudly rather than
timing something else), written under exps/k5_ablation/<variant>/ and
built as the port builds its kernels:

  full        the kernel as it is
  no_cluster  no thread block cluster: each row-slice block writes its own
              d_vc partial over the tile's row (d_vc wrong)
  atomic      no cluster: each row-slice block adds its partial to d_vc
              with atomicAdd (d_vc not zero-filled here, so wrong; the
              cost of the atomic design less its zero fill)
  no_dvc      no d_vc at all: neither the per-nonzero head shuffles into
              the d_vc accumulators nor the block and cluster sums (d_vc
              wrong)
  row_only    the column-role blocks exit at once (d_ws, d_nf wrong)
  col_only    the row-role blocks exit at once (d_wd, d_vc wrong)

The variants are timed in turns (in order, then in reverse) x rounds,
each turn the device time of 50 calls (chip_smoke._device_ms). The
outputs a variant does not take out must still agree with the plain
version (1e-4 of scale), or the script fails. Prints one line per level
and a JSON line of the medians and of each output's error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "exps", "k5_ablation")

_CLUSTER = """    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int q = tid; q < (R + 1) * H; q += kThreads) {
        float sum = 0.f;
        for (int b = 0; b < n_slices; ++b)
          sum += cluster.map_shared_rank(part, b)[q];
        d_vc[(size_t)t * (R + 1) * H + q] = sum;
      }
    }
    cluster.sync();  // the others' shared memory lives until it is read
"""
_ONE_ATTR = "  cfg.numAttrs = 1;\n"
_NO_ATTR = "  cfg.numAttrs = 0;\n"
_HEAD_LOOP = """          const float eav = lane < R ? ea[u] : 1.f;
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int c = h * D;  // the head's first column
            const float dzh = __shfl_sync(
                kFull, NV == 1 || c < 128 ? dz[0] : dz[NV - 1], (c & 127) >> 2);
            vacc[h] += dzh * eav;
          }
"""
_REDUCE_HEAD = "    // the block's partial in a fixed order, then the cluster's in rank order\n"
_ROLE = "  const bool col_role = blockIdx.x >= n_slices;\n"

# variant: (the outputs it leaves unwritten or wrong, its replacements)
VARIANTS = {
    "full": ((), []),
    "no_cluster": (("d_vc",), [
        (_CLUSTER, "    for (int q = tid; q < (R + 1) * H; q += kThreads)\n"
                   "      d_vc[(size_t)t * (R + 1) * H + q] = part[q];\n"),
        (_ONE_ATTR, _NO_ATTR)]),
    "atomic": (("d_vc",), [
        (_CLUSTER, "    for (int q = tid; q < (R + 1) * H; q += kThreads)\n"
                   "      atomicAdd(&d_vc[(size_t)t * (R + 1) * H + q], "
                   "part[q]);\n"),
        (_ONE_ATTR, _NO_ATTR)]),
    "no_dvc": (("d_vc",), [
        (_HEAD_LOOP, ""),
        (_REDUCE_HEAD, "    return;\n" + _REDUCE_HEAD),
        (_ONE_ATTR, _NO_ATTR)]),
    "row_only": (("d_ws", "d_nf"),
                 [(_ROLE, _ROLE + "  if (col_role) return;\n")]),
    "col_only": (("d_wd", "d_vc"),
                 [(_ROLE, _ROLE + "  if (!col_role) return;\n")]),
}
OUTPUTS = ("d_wd", "d_ws", "d_nf", "d_vc")


def write_variants(source: str) -> dict:
    """{variant: directory holding its dense_gat_bwd.cu}, each the source
    with its replacements, each of which must match exactly once."""
    dirs = {}
    for name, (_drops, edits) in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: a replacement matches "
                                 f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "dense_gat_bwd.cu"), "w") as f:
            f.write(text)
        dirs[name] = d
    return dirs


def swapped(mod, attr, kernel, fn):
    """``fn`` as a callable that runs with ``kernel`` in place of the
    module attribute ``attr`` (the module's own put back after each
    call)."""
    def run():
        keep = getattr(mod, attr)
        setattr(mod, attr, kernel)
        try:
            return fn()
        finally:
            setattr(mod, attr, keep)

    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k5_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from kernel_ab import capture_calls, output_errors, time_turns

    from fragnet_tpu_torch.ops import _cuda, dense_gat

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ours = dense_gat.KERNEL_BWD
    with open(ours.path) as f:
        dirs = write_variants(f.read())
    versions = {name: _cuda.CudaKernel(ours.source, ours.symbol,
                                       ours.argtypes, csrc=d)
                for name, d in dirs.items()}
    _cuda.build_all(list(versions.values()), force=True)

    name = "dense_gat_bwd"
    attr = cs.KERNELS[name].counter
    summary = []
    for lvl, a, kw in capture_calls({name})[name]:
        fn = lambda: dense_gat.dense_gat_bwd(*a, **kw)  # noqa: E731
        want = cs._outputs(dense_gat.dense_gat_bwd_plain(*a, **kw))
        floor = cs._scale_floor(name, a)
        fns = {v: swapped(dense_gat, attr, k, fn)
               for v, k in versions.items()}
        errs = {v: output_errors(f, want, floor) for v, f in fns.items()}
        for v, e in errs.items():  # what a variant keeps must still agree
            kept = {o: x for o, x in zip(OUTPUTS, e)
                    if o not in VARIANTS[v][0]}
            if not all(x <= cs.REL_LIMIT for x in kept.values()):
                raise AssertionError(f"{v} [{lvl}]: {kept}")
        times = time_turns(fns, args.rounds)
        med = {v: statistics.median(t) for v, t in times.items()}
        print(f"dense_gat_bwd [{lvl}]: " + "; ".join(
            f"{v} {med[v]:.4f} ms" for v in versions)
            + " (each variant's other outputs within "
            f"{cs.REL_LIMIT:g} of scale of the plain version)")
        summary.append({"level": lvl, "ms": med,
                        "runs": {v: [round(x, 4) for x in t]
                                 for v, t in times.items()},
                        "rel": {v: dict(zip(OUTPUTS, e))
                                for v, e in errs.items()}})
    print(json.dumps({"k5_ablation": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
