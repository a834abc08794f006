"""Device ms per step of the DTA model's protein encoder, forward: the
program's span ``fragnet.model.protein`` (see _spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.model.protein")
