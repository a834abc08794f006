"""Device ms per step of the packed batch's decode on the device, the
dense planes (K6) included: the program's span ``fragnet.data.decode``
(see _spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.data.decode")
