#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell
at its own size, on several seeds in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--fault half_batch|unchanged_state|altered_answer] [--control]

For each seed it builds the cell as a run does and prints one JSON line:
the program's numbers (the lower readings), with ``--control`` the
control's (the reference computed with TF32 on, the precision below the
configuration's float32, against the reference with TF32 off: the upper
readings), and with ``--fault`` the numbers of the program with that fault
planted underneath. Training cells need no window (their numbers come
from the first steps); a screening cell runs a window of ``--seconds``.
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import run  # noqa: E402  (sets the run's environment)


@contextlib.contextmanager
def tf32():
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def readings(workload, seed, seconds, control, fault, device=None,
             workers=None, parts=None):
    import numpy as np
    import torch

    from perfbench.common import check, faults

    man = run.manifest()
    cell, config, traffic = parts or run.cell_parts(man, workload)
    device = device or torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.build_kernels(device)
    ctx = run.Context(workload, config, traffic, seed, device,
                      workers or max(1, min(7, (os.cpu_count() or 2) - 1)))
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    planted = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    out = {"seed": seed, "fault": fault}
    t0 = time.perf_counter()
    with planted:
        session = driver.Session(ctx)
        training = hasattr(session, "first")
        if not training:
            run.timed_window(session, seconds, device)
            session.end_window()
    session.release()
    ref = session.reference()
    if training:
        out["program"] = check.training_numbers(session.first.result(), ref,
                                                session.w0)
    else:
        out["program"] = session.gaps(session.window_out, session.done, ref)
    if control:
        with tf32():
            ctrl = session.reference()
        if training:
            out["control"] = check.training_numbers(ctrl, ref, session.w0)
        else:
            out["control"] = session.gaps(ctrl, np.arange(len(ctrl)), ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("unchanged_state", "half_batch",
                                        "altered_answer"))
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds,
                                  args.control, args.fault)), flush=True)


if __name__ == "__main__":
    main()
