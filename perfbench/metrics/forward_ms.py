"""Device ms per step of the model's forward call: the program's span
``fragnet.model.forward`` (see _spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.model.forward")
