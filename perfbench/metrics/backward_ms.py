"""Device ms per step of ``loss.backward()``: the program's span
``fragnet.train.backward`` (see _spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.train.backward")
