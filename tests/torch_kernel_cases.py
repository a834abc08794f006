"""Seeded graphs for the cases a row-sliced GAT kernel can get wrong.

The port's row-sliced GAT kernels (csrc/tcsr_gat_{fwd,bwd}.cu,
csrc/dense_gat_{fwd,bwd}.cu, csrc/dense_attr_{fwd,bwd}.cu) split each node
tile into slices of 8-16 rows (and, in the backward kernels, of columns or
source rows), a block each. ``kernel_case`` draws, with numpy from a seed,
the per-edge arrays of a graph that has

  * a destination row with no kept edge (one masked edge points at it):
    the forward must give m = -1e30, den = 0, out = 0 there;
  * a row with ``hub`` in-edges (at least 64 where the tile allows it: the
    dense planes hold one edge per (dst, src) slot, so a tile of 32 nodes
    gives at most 32);
  * edges stored tile by tile, shuffled within the tile (not sorted by
    destination), the first tile's count off the te grid, so a tile's edge
    window starts with edges of the tile before it;
  * a column (source node) with edges into rows of every 16-row slice
    (every ``hub_step``-th row; ``hub_step`` 7 reaches every 8-row slice);
  * masked real edges and masked padding up to a multiple of te.

With ``tile_local`` every source lies in its destination's tile and no
(dst, src) pair repeats (the dense planes' layout); otherwise sources reach
half a tile back and a tile forward (TCSR source windows of k_src > 1) and
pairs may repeat. Used by tests/test_torch_kernel_cases.py (the plain
versions against the JAX package's Pallas kernels, interpreted) and by
tests/test_torch_cuda_kernels.py (the CUDA kernels against the plain
versions).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class KernelCase(NamedTuple):
    src: np.ndarray    # (E,) int32
    dst: np.ndarray    # (E,) int32
    mask: np.ndarray   # (E,) float32
    n_nodes: int
    empty_row: int     # a node with no kept in-edge
    hub_row: int       # a node with ``hub`` in-edges
    hub_col: int       # a source with edges into rows of every slice


def kernel_case(seed: int, tn: int, n_tiles: int = 3, te: int = 64,
                tile_local: bool = False, hub: int = 72,
                hub_step: int = 9) -> KernelCase:
    rng = np.random.default_rng(seed)
    N = n_tiles * tn
    empty_row, hub_row, hub_col = tn - 3, 1, tn - 5
    src, dst, mask = [], [], []
    for t in range(n_tiles):
        lo = t * tn if tile_local else max(0, t * tn - tn // 2)
        hi = (t + 1) * tn if tile_local else min(N, (t + 2) * tn)
        pairs = []
        for i in range(tn):
            if t == 0 and i == empty_row:
                continue
            deg = min(hub, tn) if t == 0 and i == hub_row else int(
                rng.integers(0, 5))
            if tile_local:
                js = rng.choice(tn, size=deg, replace=False) + lo
            else:
                js = rng.integers(lo, hi, deg)
            pairs += [(t * tn + i, int(j)) for j in js]
        if t == 0:  # the hub column: every hub_step-th row
            have = set(pairs)
            pairs += [(i, hub_col) for i in range(2, tn, hub_step)
                      if i != empty_row and (i, hub_col) not in have]
        rng.shuffle(pairs)
        keep = (rng.random(len(pairs)) > 0.05).astype(np.float32)
        if t == 0:  # the hub row and column keep every edge; a masked
            #         edge into the empty row; the count off te
            keep[[p[0] == hub_row or p[1] == hub_col for p in pairs]] = 1.0
            pairs.append((empty_row, hub_col))
            keep = np.append(keep, np.float32(0.0))
            if len(pairs) % te == 0:
                pairs.append((hub_row, hub_row))
                keep = np.append(keep, np.float32(0.0))
        dst += [p[0] for p in pairs]
        src += [p[1] for p in pairs]
        mask += list(keep)
    E = -(-len(src) // te) * te + te  # at least one block of padding
    out = [np.zeros(E, np.int32), np.zeros(E, np.int32),
           np.zeros(E, np.float32)]
    for arr, vals in zip(out, (src, dst, mask)):
        arr[:len(vals)] = vals
    return KernelCase(out[0], out[1], out[2], N, empty_row, hub_row, hub_col)
