"""How unevenly the router loads the experts held here: the largest held
expert's rows over the mean held expert's, summed over the traced
window's expert-layer calls (the program's counters
``fragnet.protein.moe.load_max`` and ``.load_mean``); 1 is even."""

from perfbench.metrics import _counts, _spans


def read(r):
    tab = _spans.window_table(r)
    top = _counts.total(tab, "fragnet.protein.moe.load_max")
    mean = _counts.total(tab, "fragnet.protein.moe.load_mean")
    if not top or not mean:
        return None
    return top / mean
