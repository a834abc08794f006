"""Start the ranks of a distributed run without ``torchrun``.

``run_ranks(fn, n_ranks, args)`` runs ``fn(*args)`` in every rank of a new
process group and returns each rank's result, in rank order. One rank runs
in the calling process; more are spawned (start method ``spawn``: a child
imports torch and this package, never the caller's other state), so a
script that calls it needs the ``if __name__ == "__main__"`` guard. The
group meets through a file in a fresh directory under ``workdir``, which
keeps concurrent runs (test workers) apart and needs no port. Every
collective fails after ``timeout_s`` and the whole run after
``join_timeout_s``, so a rank that dies or disagrees cannot hang the
caller.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Sequence, Union

import torch


def _rank_main(rank: int, fn: Callable, n_ranks: int, init_method: str,
               device: str, timeout_s: float, args: Sequence,
               out_dir: str) -> None:
    import torch.distributed as dist

    from fragnet_tpu_torch.dist.data_parallel import initialize_distributed

    initialize_distributed(rank, n_ranks, init_method, device, timeout_s)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n_ranks: int, args: Sequence = (),
              device: Union[str, torch.device] = "cuda",
              timeout_s: float = 300.0, join_timeout_s: float = 3600.0,
              workdir: str = ".") -> List[Any]:
    """``[fn(*args) of rank 0, ..., of rank n_ranks - 1]``, each run inside
    the process group (``fn`` and ``args`` must pickle; a rank's result is
    passed back with torch.save). Raises if a rank fails or the run
    outlasts ``join_timeout_s``."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="ranks-", dir=workdir)
    init = "file://" + os.path.abspath(os.path.join(out_dir, "pg"))
    dev = str(torch.device(device))
    try:
        if n_ranks == 1:
            _rank_main(0, fn, 1, init, dev, timeout_s, args, out_dir)
        else:
            ctx = mp.start_processes(
                _rank_main, args=(fn, n_ranks, init, dev, timeout_s, args,
                                  out_dir),
                nprocs=n_ranks, join=False, start_method="spawn")
            deadline = time.monotonic() + join_timeout_s
            try:
                while not ctx.join(timeout=5):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{n_ranks} ranks did not finish within "
                            f"{join_timeout_s} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                        p.join(10)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
