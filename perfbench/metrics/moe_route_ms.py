"""Device ms per step of the expert layers' routing and its data movement:
the program's spans ``fragnet.protein.moe.route`` (router, routes, the
experts' row counts read back, the dispatch) and
``fragnet.protein.moe.combine``, and their backwards (``.bwd``) (see
_spans.py)."""

from perfbench.metrics import _spans

SPANS = ("fragnet.protein.moe.route", "fragnet.protein.moe.combine",
         "fragnet.protein.moe.route.bwd", "fragnet.protein.moe.combine.bwd")


def read(r):
    return _spans.read_stage(r, *SPANS)
