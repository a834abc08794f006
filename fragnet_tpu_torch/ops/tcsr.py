"""Tiled-CSR (TCSR) layout metadata for the fused GAT kernel
(ops/tcsr_gat.py, csrc/tcsr_gat_fwd.cu).

The batcher packs molecules contiguously (hiergraph.py), so both the node ids
and the edge ids of one molecule occupy contiguous ranges. For a tile of Tn
consecutive destination nodes, the edges that aggregate into it therefore lie
inside one contiguous *edge window*, and their source nodes lie inside one
contiguous *node window*. This module computes, per destination tile:

  * ``ew_blk``  — start of the edge window, in units of Te-edge blocks
  * ``sw_tile`` — start of the source-node window, in units of Tn-node tiles

plus the static widths (``n_chunks`` Te-blocks per window, ``k_src`` Tn-tiles
per source window) and a per-edge ``flat_slot`` map (edge id → slot in the
kernel's (n_tiles * n_chunks * Te) tiled edge space) used by the backward
pass to *gather* per-edge gradients instead of scattering them.

Replaces the torch-scatter CSR machinery of the reference (gat2.py:153,162);
the layout itself has no reference analog — it exists so every memory access
in the hot kernel is a contiguous window load.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TileMeta:
    """Per-level TCSR metadata: the four arrays plus the static tile widths
    that size the kernel's launch."""

    ew_blk: np.ndarray     # (n_tiles,) i32 — edge-window start, Te-block units
    sw_tile: np.ndarray    # (n_tiles,) i32 — src-window start, Tn-tile units
    flat_slot: np.ndarray  # (E,) i32 — edge → tiled-space slot (pad edges → 0)
    cw: np.ndarray         # (n_tiles,) i32 — REAL Te-chunks per tile (≥1);
    #                        chunks c ≥ cw[t] hold no edges of tile t, so the
    #                        kernel never reads them — n_chunks is only the
    #                        static bound
    tn: int        # node tile size
    te: int        # edge chunk size
    n_chunks: int  # Te-blocks per window
    k_src: int     # Tn-tiles per src window


def _chunk_widths(ew_blk, dst, keep, tn, te, n_tiles):
    """Per-tile REAL chunk counts: 1 + max chunk offset over the tile's kept
    edges (min 1, so chunk 0 — the flat_slot sink for pad edges — is always
    computed)."""
    cw = np.ones((n_tiles,), np.int64)
    if keep.any():
        eids = np.arange(len(dst), dtype=np.int64)
        t_all = (dst // tn)[keep]
        off_blk = (eids[keep] - ew_blk[t_all] * te) // te
        np.maximum.at(cw, t_all, off_blk + 1)
    return cw


def build_tile_meta(
    src: np.ndarray,
    dst: np.ndarray,
    edge_mask: np.ndarray,
    n_nodes: int,
    tn: int = 128,
    te: int = 256,
    n_chunks: Optional[int] = None,
    k_src: Optional[int] = None,
) -> Optional[TileMeta]:
    """Compute TCSR metadata, or return None when the layout assumptions do
    not hold (caller falls back to the XLA segment path).

    Requires ``n_nodes % tn == 0`` and ``len(src) % te == 0`` (the PadSpec
    guarantees both). ``n_chunks``/``k_src`` may be pinned (e.g. from a
    dataset-wide spec) so every batch compiles to the same kernel; batches
    needing wider windows return None.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = np.asarray(edge_mask) > 0
    E = len(src)
    if n_nodes % tn or E % te or n_nodes < tn or E < te:
        return None
    n_tiles = n_nodes // tn
    n_eblk = E // te

    tile_of = dst // tn
    tile_of = np.where(keep, tile_of, -1)
    eids = np.arange(E, dtype=np.int64)

    ew_blk = np.zeros((n_tiles,), np.int64)
    sw_tile = np.zeros((n_tiles,), np.int64)
    max_chunks = 1
    max_k = 1
    # per-tile contiguous ranges via sort (tile_of is near-sorted already)
    order = np.argsort(tile_of, kind="stable")
    to_s = tile_of[order]
    start = np.searchsorted(to_s, np.arange(n_tiles), side="left")
    end = np.searchsorted(to_s, np.arange(n_tiles), side="right")
    for t in range(n_tiles):
        if start[t] == end[t]:
            continue
        ids = order[start[t] : end[t]]
        e_lo, e_hi = int(eids[ids].min()), int(eids[ids].max())
        s_lo, s_hi = int(src[ids].min()), int(src[ids].max())
        ew_blk[t] = e_lo // te
        sw_tile[t] = s_lo // tn
        max_chunks = max(max_chunks, e_hi // te - ew_blk[t] + 1)
        max_k = max(max_k, s_hi // tn - sw_tile[t] + 1)

    if n_chunks is None:
        n_chunks = max_chunks
    elif max_chunks > n_chunks:
        return None
    if k_src is None:
        k_src = max_k
    elif max_k > k_src:
        return None
    if n_chunks > n_eblk or k_src > n_tiles:
        return None  # windows wider than the (padded) arrays

    ew_blk = np.minimum(ew_blk, n_eblk - n_chunks)
    sw_tile = np.minimum(sw_tile, n_tiles - k_src)

    # re-check coverage after clamping (clamp only moves windows down, and
    # window starts were at/below the first edge, so only an assert)
    t_all = np.where(keep, dst // tn, 0)
    lo = ew_blk[t_all] * te
    if keep.any():
        bad = keep & ((eids < lo) | (eids >= lo + n_chunks * te))
        if bad.any():
            return None
        s_lo = sw_tile[t_all] * tn
        bad = keep & ((src < s_lo) | (src >= s_lo + k_src * tn))
        if bad.any():
            return None

    flat = t_all * (n_chunks * te) + (eids - ew_blk[t_all] * te)
    flat = np.where(keep, flat, 0)

    cw = _chunk_widths(ew_blk, dst, keep, tn, te, n_tiles)
    return TileMeta(
        ew_blk=ew_blk.astype(np.int32),
        sw_tile=sw_tile.astype(np.int32),
        flat_slot=flat.astype(np.int32),
        cw=cw.astype(np.int32),
        tn=tn, te=te, n_chunks=int(n_chunks), k_src=int(k_src),
    )
