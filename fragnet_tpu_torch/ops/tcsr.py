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
in the hot kernel is a contiguous window load. ``EPTileMeta`` /
``build_ep_tile_meta`` give the same per edge shard of the edge-partitioned
mode (copied from fragnet_tpu/ops/tcsr.py:169-306).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from fragnet_tpu_torch import native


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
    needing wider windows return None. The windows come from the C++ native
    runtime (fragnet_tpu_torch/native) when a compiler is present, else
    from ``build_tile_meta_numpy``; the two give the same metadata.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    E = len(src)
    if n_nodes % tn or E % te or n_nodes < tn or E < te:
        return None
    nat = native.tile_meta_arrays(src, dst, edge_mask, n_nodes, tn, te,
                                  n_chunks, k_src)
    if nat is None:
        return build_tile_meta_numpy(src, dst, edge_mask, n_nodes, tn, te,
                                     n_chunks, k_src)
    if nat == "overflow":
        return None
    ew, sw, flat, nc, kk = nat
    keep = np.asarray(edge_mask) > 0
    cw = _chunk_widths(np.asarray(ew, np.int64), dst, keep, tn, te,
                       n_nodes // tn)
    return TileMeta(ew_blk=ew, sw_tile=sw, flat_slot=flat,
                    cw=cw.astype(np.int32),
                    tn=tn, te=te, n_chunks=int(nc), k_src=int(kk))


def build_tile_meta_numpy(
    src: np.ndarray,
    dst: np.ndarray,
    edge_mask: np.ndarray,
    n_nodes: int,
    tn: int = 128,
    te: int = 256,
    n_chunks: Optional[int] = None,
    k_src: Optional[int] = None,
) -> Optional[TileMeta]:
    """``build_tile_meta`` in numpy (no native runtime)."""
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


# ---------------------------------------------------------------------------
# edge-partitioned TCSR (the K3 kernels under torch.distributed,
# dist/edge_partition.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EPTileMeta:
    """Per-SHARD TCSR metadata for the edge-partitioned pass.

    Edges are split into ``n_shards`` contiguous ranges, one per rank;
    because the batcher packs edges sorted by destination, each shard's
    destinations cover a contiguous tile range [t0, t0 + n_tiles_grid). The
    shard's kernel therefore runs a RESTRICTED grid of ``n_tiles_grid`` dst
    tiles — per-shard work scales ~1/S — and the caller adds its
    (n_tiles_grid·tn)-row outputs at t0·tn in the cross-shard softmax
    combine (ops/tcsr_gat.py:tcsr_gat_pass_ep). Every rank holds every
    shard's rows, so each knows the others' t0 without a collective.
    """

    t0: np.ndarray         # (S, 1) i32 — first dst tile of each shard's grid
    ew_blk: np.ndarray     # (S, Tg) i32 — edge-window starts, LOCAL Te-blocks
    sw_tile: np.ndarray    # (S, Tg) i32 — src-window starts, GLOBAL Tn-tiles
    flat_slot: np.ndarray  # (S, Es) i32 — local edge → local tiled slot
    cw: np.ndarray         # (S, Tg) i32 — real Te-chunks per grid tile (≥1)
    tn: int
    te: int
    n_chunks: int
    k_src: int
    n_tiles_grid: int


def build_ep_tile_meta(
    src: np.ndarray,
    dst: np.ndarray,
    edge_mask: np.ndarray,
    n_nodes: int,
    n_shards: int,
    tn: int = 128,
    te: int = 256,
    n_chunks: Optional[int] = None,
    k_src: Optional[int] = None,
    n_tiles_grid: Optional[int] = None,
) -> Optional["EPTileMeta"]:
    """Per-shard TCSR metadata, or None when the layout assumptions fail.
    Requires the global edge count divisible by n_shards·te and n_nodes by
    tn."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    E = len(src)
    if E % n_shards:
        return None
    Es = E // n_shards
    if n_nodes % tn or Es % te or n_nodes < tn or Es < te:
        return None
    n_tiles = n_nodes // tn
    n_eblk_l = Es // te
    eids = np.arange(Es, dtype=np.int64)

    shards = []
    max_span = 1
    for s in range(n_shards):
        sl = slice(s * Es, (s + 1) * Es)
        keep = np.asarray(edge_mask[sl]) > 0
        tile_of = np.where(keep, dst[sl] // tn, -1)
        if (tile_of >= 0).any():
            t_lo = int(tile_of[tile_of >= 0].min())
            t_hi = int(tile_of.max())
        else:
            t_lo = t_hi = 0
        shards.append((src[sl], keep, tile_of, t_lo, t_hi))
        max_span = max(max_span, t_hi - t_lo + 1)

    Tg = min(int(n_tiles_grid), n_tiles) if n_tiles_grid is not None \
        else max_span
    if max_span > Tg or Tg > n_tiles:
        return None

    ew = np.zeros((n_shards, Tg), np.int64)
    sw = np.zeros((n_shards, Tg), np.int64)
    t0s = np.zeros((n_shards,), np.int64)
    max_c, max_k = 1, 1
    for s, (src_l, keep, tile_of, t_lo, t_hi) in enumerate(shards):
        t0 = min(t_lo, n_tiles - Tg)
        t0s[s] = t0
        for t in range(Tg):
            ids = np.nonzero(tile_of == t0 + t)[0]
            if len(ids) == 0:
                continue
            ew[s, t] = int(ids.min()) // te
            sw[s, t] = int(src_l[ids].min()) // tn
            max_c = max(max_c, int(ids.max()) // te - int(ew[s, t]) + 1)
            max_k = max(max_k, int(src_l[ids].max()) // tn - int(sw[s, t]) + 1)

    # pinned widths clamp to the array bounds (bounds are spec-static, so
    # the clamped statics stay uniform across batches)
    if n_chunks is None:
        n_chunks = max_c
    else:
        n_chunks = min(int(n_chunks), n_eblk_l)
        if max_c > n_chunks:
            return None
    if k_src is None:
        k_src = max_k
    else:
        k_src = min(int(k_src), n_tiles)
        if max_k > k_src:
            return None
    if n_chunks > n_eblk_l or k_src > n_tiles:
        return None
    ew = np.minimum(ew, n_eblk_l - n_chunks)
    sw = np.minimum(sw, n_tiles - k_src)

    flat = np.zeros((n_shards, Es), np.int64)
    cw = np.ones((n_shards, Tg), np.int64)
    for s, (src_l, keep, tile_of, *_rest) in enumerate(shards):
        t_loc = np.where(keep, tile_of - t0s[s], 0)
        t_cl = np.clip(t_loc, 0, Tg - 1)
        if keep.any():
            if ((t_loc[keep] < 0) | (t_loc[keep] >= Tg)).any():
                return None
            lo = ew[s][t_cl] * te
            if (keep & ((eids < lo) | (eids >= lo + n_chunks * te))).any():
                return None
            s_lo = sw[s][t_cl] * tn
            if (keep & ((src_l < s_lo) | (src_l >= s_lo + k_src * tn))).any():
                return None
            np.maximum.at(cw[s], t_loc[keep],
                          (eids[keep] - ew[s][t_loc[keep]] * te) // te + 1)
        f = t_loc * (n_chunks * te) + (eids - ew[s][t_cl] * te)
        flat[s] = np.where(keep, f, 0)

    return EPTileMeta(
        t0=t0s.reshape(n_shards, 1).astype(np.int32),
        ew_blk=ew.astype(np.int32),
        sw_tile=sw.astype(np.int32),
        flat_slot=flat.astype(np.int32),
        cw=cw.astype(np.int32),
        tn=tn, te=te, n_chunks=int(n_chunks), k_src=int(k_src),
        n_tiles_grid=int(Tg),
    )
