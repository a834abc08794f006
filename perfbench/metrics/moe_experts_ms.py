"""Device ms per step of the experts' forward: the held routed experts'
matrix products (span ``fragnet.protein.moe.experts``) and the shared
experts (``fragnet.protein.moe.shared``) (see _spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.protein.moe.experts",
                             "fragnet.protein.moe.shared")
