"""The least time the H100 could take for each of the port's GAT kernels,
from the work a batch gives it: bytes with each input read once and each
output written once, and operations, each over the data-sheet peak.

The formulas are those that the port's ``chip_smoke.py`` applies to a
kernel's arguments (``_tcsr_cost``, ``_tcsr_bwd_cost``, ``_dense_cost``,
``_dense_bwd_cost``, ``_planes_cost``, ``_bound_ms``), restated here
from counts: ``n`` the level's real nodes, ``e`` its real edges, ``h``
heads, ``d`` the width per head, ``r`` the rank of the dense levels'
edge attributes, ``tn`` the tile. Counting the real nodes and edges,
not the padded slots, makes the work the same whatever implements it.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
# the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

Cost = Tuple[float, float]   # (bytes, operations)


def _tiles(n: int, tn: int) -> int:
    return -(-n // tn)


def tcsr_fwd(n: int, e: int, h: int, d: int, tn: int = 128) -> Cost:
    """K1: node logits, nf, the edges' scalars and the tile windows read;
    out, m, den written."""
    hd = h * d
    nbytes = 4 * (n * 2 * h + e * (h + 3) + 2 * _tiles(n, tn)
                  + n * (hd + 2 * h)) + 4 * n * hd
    return nbytes, e * h * (2 * d + 6) + n * hd


def tcsr_bwd(n: int, e: int, h: int, d: int, self_loops: bool,
             tn: int = 128) -> Cost:
    """K2: node logits, m / den / s, g, nf, the edges' scalars and the
    windows read; d_wn, d_nf and d_w_ea written."""
    hd = h * d
    nbytes = 4 * (n * 2 * h + 3 * n * h + n * hd + e * (h + 3)
                  + 2 * _tiles(n, tn) + n * (2 * h + hd) + e * h) \
        + 4 * n * hd
    items = e + (n if self_loops else 0)
    return nbytes, items * h * (4 * d + 10)


def dense_fwd(n: int, e: int, h: int, d: int, r: int,
              tn: int = 128) -> Cost:
    """K4: the adjacency planes of the tiles that hold the nodes, the
    nonzeros' r attribute values, wd, ws, nf and vc read; out, m, den
    written. Work at the nonzeros (the real edges) only."""
    hd = h * d
    nbytes = 4 * (_tiles(n, tn) * tn * tn + e * r + 2 * n * h + r * h
                  + n * (hd + 2 * h)) + 4 * n * hd
    return nbytes, e * h * (2 * r + 4) + 2 * e * hd


def dense_bwd(n: int, e: int, h: int, d: int, r: int,
              tn: int = 128) -> Cost:
    """K5: the adjacency planes, the nonzeros' attribute values, wd, ws,
    m, den, s, nf, g and vc read; d_wd, d_ws, d_nf and d_vc written."""
    hd = h * d
    nbytes = 4 * (_tiles(n, tn) * tn * tn + e * r + 5 * n * h + n * hd
                  + r * h + 2 * n * h + n * hd + r * h) + 4 * n * hd
    return nbytes, e * h * (4 * d + 2 * r + 6)


def planes(n: int, e: int, r: int, tn: int = 128) -> Cost:
    """K6: the r + 1 planes of the nodes' tiles written once, the edges'
    src, dst, mask and attributes and the windows read; one add per plane
    value."""
    nbytes = 4 * (n * (r + 1) * tn + e * (3 + r) + 2 * _tiles(n, tn))
    return nbytes, e * (r + 1)


def bound_ms(cost: Cost) -> float:
    nbytes, flops = cost
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def gat_passes_step(real: Dict[str, int], layers: int, h: int, d: int,
                    tn: Dict[str, int]) -> float:
    """Bound ms of the GAT passes of one training step, whichever kernel
    carries each level: the edge-list forms (``tcsr_fwd``,
    ``tcsr_bwd``), since a level's work is its nodes and edges whether
    K1/K2 or K4/K5 run it. Forward: every level in every layer (the atom
    level folds in one self-loop per atom). Backward: the atom, bond and
    connection levels in every layer, the fragment level in the last one
    only (the earlier layers' fragment outputs reach no loss). The dense
    formulation's plane building (K6) is time without model work, so it
    adds nothing here.

    ``real``: nodes ``atom``, ``bond``, ``frag``, ``fc`` and edges
    ``e_atom`` (the atom graph's, self-loops apart), ``e_bond``,
    ``e_frag``, ``e_fc``."""
    lv = {"atom": ("atom", "e_atom", True), "bond": ("bond", "e_bond", False),
          "frag": ("frag", "e_frag", False), "fc": ("fc", "e_fc", False)}
    total = 0.0
    for ax, (nk, ek, loops) in lv.items():
        n, e = real[nk], real[ek]
        total += layers * bound_ms(tcsr_fwd(n, e, h, d, tn[ax]))
        n_bwd = 1 if ax == "frag" else layers
        total += n_bwd * bound_ms(tcsr_bwd(n, e, h, d, loops, tn[ax]))
    return total
