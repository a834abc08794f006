"""The device's side of a traced window, read from ``torch.profiler``'s
activity records: every kernel, copy and fill that ran on the card, as
intervals, and the host operations beside them."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Interval = Tuple[str, float, float]   # (name, start s, end s)


def events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host operation intervals), in seconds on the
    profiler's clock."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        t0 = ev.start_ns() * 1e-9
        t1 = t0 + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            dev.append((ev.name(), t0, t1))
        elif ev.device_type() == DeviceType.CPU:
            host.append((ev.name(), t0, t1))
    return dev, host


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The intervals merged where they overlap, in order."""
    out: List[Tuple[float, float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_seconds(intervals: List[Interval]) -> float:
    """Seconds in which at least one device operation ran."""
    return float(sum(b - a for a, b in union(intervals)))


def by_name(intervals: List[Interval]) -> List[Tuple[str, float]]:
    """Device seconds summed by operation name, largest first."""
    tot: dict = {}
    for n, a, b in intervals:
        tot[n] = tot.get(n, 0.0) + (b - a)
    return sorted(tot.items(), key=lambda kv: -kv[1])


def idle_gaps(dev: List[Interval], host: List[Interval], k: int = 10
              ) -> List[Tuple[str, float]]:
    """The ``k`` longest gaps between device work, each named by the
    innermost host operation running at its middle."""
    merged = union(dev)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    if host:
        hs = np.array([h[1] for h in host])
        he = np.array([h[2] for h in host])
    out = []
    for a, b in gaps[:k]:
        mid, name = 0.5 * (a + b), "no host operation"
        if host:
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(cover):
                name = host[int(cover[np.argmax(hs[cover])])][0]
        out.append((name, b - a))
    return out


@dataclasses.dataclass
class Traced:
    device: List[Interval]
    host: List[Interval]
    window_s: float
    busy_s: float
    steps: List[int]                 # the batch each traced step ran
    host_step_ms: List[float]        # host time inside each step call
