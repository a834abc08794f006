"""Device ms per step of the bond-graph GAT level, forward and backward:
the ``fragnet.gat.bond`` and ``fragnet.gat.bond.bwd`` spans (see
_spans.py)."""

from perfbench.metrics import _spans


def read(r):
    return _spans.read_stage(r, "fragnet.gat.bond", "fragnet.gat.bond.bwd")
