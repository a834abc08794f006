"""Observability: scalar-history logging + on-demand profiler traces
(counterpart of fragnet_tpu/obs.py).

The reference logs train/val scalars to TensorBoard
(train/finetune/finetune_gat2.py:86,272-273). Here:

* ``ScalarLogger`` — always writes append-only JSONL
  (``<exp_dir>/scalars.jsonl``, one ``{"step", "tag", "value", "wall"}``
  record per point), and mirrors to TensorBoard when
  ``torch.utils.tensorboard`` imports.
* ``profile_trace`` — context manager that records ``torch.profiler``
  activity (CPU, and CUDA when a card is present) around the enclosed block
  and writes a Chrome trace (``<out_dir>/trace.json``, viewable in
  ui.perfetto.dev). Enabled from the CLI with ``finetune.profile=true``
  (trace lands in ``<exp_dir>/profile``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch


class ScalarLogger:
    """JSONL scalar history with optional TensorBoard mirroring."""

    def __init__(self, exp_dir: str, use_tensorboard: bool = True):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, "scalars.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._tb = None
        if use_tensorboard:
            try:  # pragma: no cover - env dependent
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(exp_dir, "tb"))
            except ImportError:
                self._tb = None

    def log(self, tag: str, value: float, step: int) -> None:
        rec = {"step": int(step), "tag": tag, "value": float(value),
               "wall": round(time.time() - self._t0, 3)}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(exp_dir: str):
    """Load the scalar history back as a list of records."""
    path = os.path.join(exp_dir, "scalars.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace around the enclosed block, written to
    ``<out_dir>/trace.json``; no-op when out_dir is falsy."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
