"""Device ms per step of the GAT logit terms' backward: every
``fragnet.gat.logits.bwd`` span (see _spans.py), which the program opens
around the backward of its logit-terms Function. A program without that
span gives None."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.gat.logits.bwd")
