"""Device ms per step of the Moonlight tower's attention (MLA), forward:
the program's span ``fragnet.protein.attn``, every layer's (see
_spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.protein.attn")
