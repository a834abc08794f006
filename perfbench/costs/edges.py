"""Real message edges a batch carries over all four graph levels, the
atom self-loops included, times the layers: the count of the port's
``train/fastpath.py:epoch_message_edges``, restated per batch. The
benchmark prints it beside the window, with edges per second, on an
earlier line than the result."""

from __future__ import annotations

from typing import Sequence


def message_edges(graphs: Sequence, num_layer: int) -> int:
    total = 0
    for g in graphs:
        total += (g.n_edges + g.n_atoms + g.n_bg_edges + g.n_fconn
                  + g.n_fc_edges)
    return total * num_layer
