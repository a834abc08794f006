"""ELL / padded-neighbor-table GAT pass (counterpart of
fragnet_tpu/ops/ell.py).

Molecular graphs have bounded degree (≤4 heavy + H neighbors per atom; the
bond line graph ≤ ~10 incident edges per directed bond), so instead of
edge-parallel segment ops a batch can carry, per destination node, a
fixed-K table of incoming-edge ids (``spec_for(..., ell=True)``). The whole
attention pass then becomes dense, regular ops:

    h_src  = h[src[nbr_edge]]            (N, K, H, D)   gather
    logit  = LReLU(Σ [h_dst ‖ ea ‖ h_src]·a)  (N, K, H)
    prob   = masked softmax over K       (dense — no segment max / sum)
    out    = Σ_k prob · h_src            (N, H, D)      dense reduction

The only scatter left is the optional attention-by-source sum. Numerics
match the segment formulation (same edge sets, max-subtracted softmax): a
node with no valid neighbour gets 0, forward and backward. The three logit
terms are each summed in f64 and rounded once (ops/tcsr_gat.py:prologue,
one pass for both row sets), as every other pass of the port takes them;
the JAX package sums them in f32, so the two agree to f32 round-off.

The JAX package computes this pass in XLA and reaches no ``pallas_call``:
there is no TPU kernel to port, and on the card it runs as torch ops, as
the segment edge-partitioned pass does (the stated exception, ROADMAP.md
Conventions).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fragnet_tpu_torch.ops.segment import segment_sum
from fragnet_tpu_torch.ops.tcsr_gat import prologue

_NEG_BIG = -1e9


def ell_gat_pass(
    node_feats_h: torch.Tensor,   # (N, H, D) per-head node features
    edge_attr: torch.Tensor,      # (E, Da) edge attrs (broadcast per head)
    edge_src: torch.Tensor,       # (E,) int message source per edge
    nbr_edge: torch.Tensor,       # (N, K) int incoming-edge ids per node
    nbr_mask: torch.Tensor,       # (N, K) f32 validity
    attn_vec: torch.Tensor,       # (H, 2*D + Da)
    negative_slope: float = 0.2,
    want_attn_by_src: bool = True,
    num_src_nodes: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (out (N, H, D) in the node features' dtype, attn_by_src
    (Ns, H) f32 or None). Logits and softmax are f32; a bf16 pass gathers
    and sums the output in bf16, as the JAX package's does."""
    N = nbr_edge.shape[0]
    H, D = node_feats_h.shape[1], node_feats_h.shape[2]
    K = nbr_edge.shape[1]
    nbr = nbr_edge.long().reshape(-1)
    src_ids = edge_src.long()[nbr]                  # (N·K,)
    # gathers by index_select, whose backward is an index_add_: the
    # backward of an advanced-indexing gather (a sorted accumulate) took
    # 39.4 of the 44.4 ms of device time of an esol-width ELL train step
    # on an H100 (PERF.md)
    h_src = node_feats_h.index_select(0, src_ids).view(N, K, H, D)

    # the split attention vector: per-node [nf·a_dst | nf·a_src] and the
    # per-edge ea·a_ea, gathered into the table (no concat message)
    wn, w_ea = prologue(node_feats_h, edge_attr, attn_vec)  # (N,2H), (E,H)
    logits = (wn[:, None, :H]
              + wn[:, H:].index_select(0, src_ids).view(N, K, H)
              + w_ea.index_select(0, nbr).view(N, K, H))     # (N, K, H)
    logits = F.leaky_relu(logits, negative_slope)

    m = nbr_mask.float()[:, :, None]
    logits = torch.where(m > 0, logits, torch.full_like(logits, _NEG_BIG))
    lmax = torch.amax(logits, dim=1, keepdim=True)
    lmax = torch.where(lmax <= _NEG_BIG / 2, torch.zeros_like(lmax), lmax)
    ex = torch.exp(logits - lmax) * m
    denom = torch.sum(ex, dim=1, keepdim=True)
    probs = ex / torch.where(denom == 0.0, torch.ones_like(denom), denom)

    out = torch.einsum("nkh,nkhd->nhd", probs.to(node_feats_h.dtype), h_src)

    attn_by_src = None
    if want_attn_by_src:
        ns = num_src_nodes or node_feats_h.shape[0]
        attn_by_src = segment_sum((probs * m).reshape(-1, H), src_ids, ns)
    return out, attn_by_src


def build_ell_table(dst: np.ndarray, n_nodes: int, k: int,
                    edge_mask: Optional[np.ndarray] = None):
    """Host-side: per-node table of incoming edge ids (numpy).
    Returns (nbr_edge (N,k) int32, nbr_mask (N,k) float32). Raises if any
    node's in-degree exceeds k."""
    nbr = np.zeros((n_nodes, k), np.int32)
    mask = np.zeros((n_nodes, k), np.float32)
    dst = np.asarray(dst, dtype=np.int64)
    if edge_mask is not None:
        ids = np.flatnonzero(np.asarray(edge_mask) > 0)
    else:
        ids = np.arange(len(dst))
    if len(ids) == 0:
        return nbr, mask
    d = dst[ids]
    order = np.argsort(d, kind="stable")
    ds = d[order]
    es = ids[order]
    # rank of each edge within its destination's run
    starts = np.r_[0, np.flatnonzero(np.diff(ds)) + 1]
    run_len = np.diff(np.r_[starts, len(ds)])
    if run_len.max() > k:
        bad = ds[starts[np.argmax(run_len)]]
        raise ValueError(
            f"node {bad} in-degree {run_len.max()} exceeds ELL width k={k}"
        )
    rank = np.arange(len(ds)) - np.repeat(starts, run_len)
    nbr[ds, rank] = es.astype(np.int32)
    mask[ds, rank] = 1.0
    return nbr, mask
