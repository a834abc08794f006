"""Shared by the readers of the program's spans (``fragnet_tpu_torch/
obs.py``: ``span``, ``span_table``): the span table over the traced
window, a stage's device milliseconds per step, and the device's idle
time inside the program's step calls. A program that keeps no spans, or
keeps them without CUDA events, gives None."""

from perfbench.common import trace

# the program's root spans: one per step or predict call
ROOTS = ("fragnet.step", "fragnet.predict")
# slack around the window's host interval, in ns
PAD_NS = 1_000_000


def window_table(r):
    """``obs.span_table`` over the traced window's host interval (the
    first to the last host operation the profiler recorded), or None."""
    t = r.traced
    if t is None or not t.host:
        return None
    from fragnet_tpu_torch import obs

    table = getattr(obs, "span_table", None)
    if table is None:
        return None
    t0 = min(a for _, a, _ in t.host)
    t1 = max(b for _, _, b in t.host)
    return table(int(t0 * 1e9) - PAD_NS, int(t1 * 1e9) + PAD_NS)


def device_ms_per_step(tab, *names):
    """The device ms of the spans ``names``, summed, over the table's root
    spans; None without roots, where a name has no span, or where a span
    has no device facet."""
    if tab is None or not tab["steps"]:
        return None
    total = 0.0
    for n in names:
        row = tab["spans"].get(n)
        if row is None or row["device_ms"] is None:
            return None
        total += row["device_ms"]
    return total / tab["steps"]


def read_stage(r, *names):
    return device_ms_per_step(window_table(r), *names)


def idle_within(dev, roots, host_names=()):
    """Seconds in which the device ran nothing inside the intervals
    ``roots`` ((start, end) s): the gaps between the union of the device
    intervals ``dev``, each cut to every root interval. A device interval
    that bears the name of a host operation (``host_names``) is the CUDA
    profiler's annotation of a user-scope record function's range, not
    device work, and is left out."""
    names = set(host_names)
    merged = trace.union([d for d in dev if d[0] not in names])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    total = 0.0
    for a, b in roots:
        for g0, g1 in gaps:
            total += max(0.0, min(b, g1) - max(a, g0))
    return total
