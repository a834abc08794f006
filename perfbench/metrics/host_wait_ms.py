"""Device idle ms per step inside the program's step calls: the gaps
between the traced window's device intervals that fall inside a root
span's host interval (``fragnet.step`` or ``fragnet.predict``, from the
profiler's host events), over the number of root spans. The program's
host code, not the benchmark's loop, kept the card waiting there (see
_spans.py)."""

from perfbench.metrics import _spans


def read(r):
    t = r.traced
    tab = _spans.window_table(r)
    if tab is None or not t.device:
        return None
    names = [n for n in _spans.ROOTS if n in tab["spans"]]
    if not names or _spans.device_ms_per_step(tab, *names) is None:
        return None
    roots = [(a, b) for n, a, b in t.host if n in _spans.ROOTS]
    if not roots:
        return None
    names = {n for n, _, _ in t.host}
    return 1e3 * _spans.idle_within(t.device, roots, names) / len(roots)
