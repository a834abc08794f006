"""Device ms per step of the optimizer's step, the scheduler and
``zero_grad``: the program's span ``fragnet.train.optimizer`` (see
_spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.train.optimizer")
