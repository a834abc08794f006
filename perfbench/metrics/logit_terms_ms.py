"""Device ms per step of the GAT logit terms in the forward, summed in
float64 with their casts to and from float32: every ``fragnet.gat.logits``
span (see _spans.py). Their backward runs in autograd's own nodes, inside
``fragnet.train.backward``."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.gat.logits")
