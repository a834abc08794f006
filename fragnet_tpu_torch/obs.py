"""Observability: scalar-history logging, on-demand profiler traces and
spans inside the step (counterpart of fragnet_tpu/obs.py).

The reference logs train/val scalars to TensorBoard
(train/finetune/finetune_gat2.py:86,272-273). Here:

* ``ScalarLogger`` — always writes append-only JSONL
  (``<exp_dir>/scalars.jsonl``, one ``{"step", "tag", "value", "wall"}``
  record per point), and mirrors to TensorBoard when
  ``torch.utils.tensorboard`` imports.
* ``profile_trace`` — context manager that records ``torch.profiler``
  activity (CPU, and CUDA when a card is present) around the enclosed block
  and writes a Chrome trace (``<out_dir>/trace.json``, viewable in
  ui.perfetto.dev) and the block's span table (``<out_dir>/spans.json``,
  ``span_table``). Enabled from the CLI with ``finetune.profile=true`` /
  ``pretrain.profile=true`` (both land in ``<exp_dir>/profile``).
* ``span(name)`` — a context manager around one stage of a step (the
  ``fragnet.*`` vocabulary: ``fragnet.step`` and ``fragnet.predict`` are
  the roots, one per step or predict call; data upload and decode, the
  model's parts, each GAT level and its backward, loss, backward and
  optimizer below them). While no ``torch.profiler`` records, it is one
  shared no-op. While one records, it opens a record function of that
  name, so the span is in the profiler's timeline, and keeps in a bounded
  buffer (``MAX_SPANS``, oldest dropped) the name, the span it opened in,
  the step id of its root, its host start and end by ``time.time_ns()``
  (the clock of the profiler's events) and, once CUDA is initialized, a
  pair of timing events on the current stream. There is one stack of
  open spans for every thread: the thread that calls ``loss.backward()``
  waits while autograd's device thread runs the backward, whose spans
  then open in the innermost open span.
* ``count(name, value)`` — a counter beside the spans: while a profiler
  records, adds the host number ``value`` to the counter ``name`` of the
  innermost open span (nothing where no span is open); else nothing. It
  never reads the device: the caller counts what it already holds on the
  host.
* ``current()`` — the innermost open span's name (None when off); an
  autograd Function keeps it from its forward to name its backward's span.
* ``span_table(t0_ns, t1_ns)`` — the buffered spans whose host interval
  lies in ``[t0_ns, t1_ns]``, summed by name: calls, host and device ms,
  each with its self ms (less the time its child spans cover), the
  counters kept with them, and the same per step (over the number of root
  spans).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

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
    ``<out_dir>/trace.json``, with the block's ``span_table`` in
    ``<out_dir>/spans.json``; no-op when out_dir is falsy."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield
    t1 = time.time_ns()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump(span_table(t0, t1), f, indent=1)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

ROOTS = ("fragnet.step", "fragnet.predict")
MAX_SPANS = 1 << 16


class _Span:
    """One span: name, parent span, step id, host stamps (ns), on CUDA its
    start and end events, and the counters kept with it."""

    __slots__ = ("rec", "name", "parent", "step", "t0", "t1", "ev0", "ev1",
                 "counts", "_rf")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name
        self.t1 = self.ev0 = self.ev1 = None
        self.counts: Dict[str, float] = {}

    def __enter__(self):
        self.rec.open(self)
        # a function-scope record function: torch.profiler.record_function's
        # user scope also gets a device-side annotation interval from the
        # CUDA profiler, which a trace reader would take for device work
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.t0 = time.time_ns()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self.t1 = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        self.rec.close(self)
        return False


class SpanRecorder:
    """The open spans' stack and the closed spans' bounded buffer."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.spans: collections.deque = collections.deque(maxlen=max_spans)
        self.stack: List[_Span] = []
        self.steps = 0
        self._lock = threading.Lock()

    def open(self, sp: _Span) -> None:
        with self._lock:
            sp.parent = self.stack[-1] if self.stack else None
            if sp.name in ROOTS:
                self.steps += 1
                sp.step = self.steps
            else:
                sp.step = sp.parent.step if sp.parent is not None else None
            self.stack.append(sp)

    def close(self, sp: _Span) -> None:
        with self._lock:
            self.stack.remove(sp)
            self.spans.append(sp)

    def count(self, name: str, value) -> None:
        with self._lock:
            if self.stack:
                c = self.stack[-1].counts
                c[name] = c.get(name, 0) + value


_RECORDER = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: Optional[str]):
    """A span named ``name`` around the enclosed block while a
    ``torch.profiler`` records, else (and for ``name`` None, a backward
    whose forward ran untraced) the shared no-op."""
    if name is None or not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(_RECORDER, name)


def spanned(name: str):
    """Decorator: every call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def spanned_backward(fn):
    """Decorator for an autograd Function's ``backward``: it runs in the
    span ``<name>.bwd``, ``<name>`` being the span its forward ran in,
    which the forward keeps as ``ctx.span = current()``."""
    @functools.wraps(fn)
    def inner(ctx, *grads):
        name = getattr(ctx, "span", None)
        with span(name and name + ".bwd"):
            return fn(ctx, *grads)
    return inner


def count(name: str, value) -> None:
    """Add ``value`` (a host number) to the counter ``name`` of the
    innermost open span while a ``torch.profiler`` records; else, and
    where no span is open, nothing."""
    if torch.autograd._profiler_enabled():
        _RECORDER.count(name, value)


def current() -> Optional[str]:
    """The innermost open span's name, or None."""
    stack = _RECORDER.stack
    return stack[-1].name if stack else None


def span_records(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None
                 ) -> List[Dict]:
    """The buffered spans whose host interval lies in ``[t0_ns, t1_ns]``,
    in closing order: name, parent (an index into the list, or None where
    the parent is not in it), step id, host start and end (ns), host ms,
    device ms (None without CUDA events) and the counters kept with it.
    Waits for the device."""
    sel = [s for s in list(_RECORDER.spans)
           if (t0_ns is None or s.t0 >= t0_ns)
           and (t1_ns is None or s.t1 <= t1_ns)]
    if any(s.ev1 is not None for s in sel):
        torch.cuda.synchronize()
    at = {id(s): i for i, s in enumerate(sel)}
    return [{"name": s.name,
             "parent": at.get(id(s.parent)) if s.parent is not None
             else None,
             "step": s.step, "t0_ns": s.t0, "t1_ns": s.t1,
             "host_ms": (s.t1 - s.t0) * 1e-6,
             "device_ms": s.ev0.elapsed_time(s.ev1)
             if s.ev1 is not None else None,
             "counts": dict(s.counts)}
            for s in sel]


def span_table(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None
               ) -> Dict:
    """``span_records`` summed by name: ``{"steps": root spans, "spans":
    {name: row}}``; a row holds the parents' names, calls, host_ms,
    host_self_ms, device_ms and device_self_ms (None where a call has no
    device facet), ``counts`` (each counter summed over the calls), and
    ``per_step``, each of them over ``steps``."""
    recs = span_records(t0_ns, t1_ns)
    child_host = [0.0] * len(recs)
    child_dev = [0.0] * len(recs)
    for r in recs:
        p = r["parent"]
        if p is not None:
            child_host[p] += r["host_ms"]
            if r["device_ms"] is not None:
                child_dev[p] += r["device_ms"]
    rows: Dict[str, Dict] = {}
    for i, r in enumerate(recs):
        row = rows.setdefault(r["name"], {
            "parents": set(), "calls": 0, "host_ms": 0.0,
            "host_self_ms": 0.0, "device_ms": 0.0, "device_self_ms": 0.0,
            "counts": {}})
        for k, v in r["counts"].items():
            row["counts"][k] = row["counts"].get(k, 0) + v
        p = r["parent"]
        row["parents"].add(recs[p]["name"] if p is not None else None)
        row["calls"] += 1
        row["host_ms"] += r["host_ms"]
        row["host_self_ms"] += r["host_ms"] - child_host[i]
        if r["device_ms"] is None or row["device_ms"] is None:
            row["device_ms"] = row["device_self_ms"] = None
        else:
            row["device_ms"] += r["device_ms"]
            row["device_self_ms"] += r["device_ms"] - child_dev[i]
    steps = sum(r["name"] in ROOTS for r in recs)
    keys = ("calls", "host_ms", "host_self_ms", "device_ms",
            "device_self_ms")
    for row in rows.values():
        row["parents"] = sorted(row["parents"], key=lambda n: n or "")
        row["per_step"] = {k: (row[k] / steps if steps and row[k] is not None
                               else None) for k in keys}
        row["per_step"]["counts"] = {k: (v / steps if steps else None)
                                     for k, v in row["counts"].items()}
    return {"steps": steps, "spans": rows}
