"""Masked segment primitives in PyTorch — the math contract of every GAT
pass (counterpart of fragnet_tpu/ops/segment.py).

``segment_sum``/``segment_softmax`` follow torch-scatter semantics
(per-segment max subtraction in the softmax) with an explicit mask for padded
entries. The fused kernels (ops/tcsr_gat.py, ops/dense_gat.py) implement the
same contract; on the CPU this module is also the fallback GAT pass for
batches that carry no kernel metadata, and on any device it is the
segment edge-partitioned pass (``gat_attention_pass(ep=...)``), which the
JAX package computes with XLA segment ops and mesh collectives, no Pallas
kernel: it runs as torch ops on the card, as ``TransformerConv`` does.

Numerics: matches torch_scatter.scatter_softmax (gat2.py:153) — empty segments
produce zeros (no edge scatters into them), masked entries contribute nothing;
an empty segment's max is set to 0 when it is ≤ −5e8 and a zero denominator
becomes 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_BIG = -1e9


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets. ``mask`` (same leading
    dim) zeroes padded rows before accumulation."""
    if mask is not None:
        data = data * _bcast(mask, data)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment max; an empty segment is −inf (jax.ops.segment_max)."""
    if mask is not None:
        data = torch.where(_bcast(mask, data) > 0, data,
                           torch.full_like(data, _NEG_BIG))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment softmax over the leading dim of ``logits`` (trailing dims
    pointwise, like scatter_softmax(dim=0)). Masked entries get probability 0
    and do not contribute to any denominator."""
    if mask is not None:
        logits = torch.where(_bcast(mask, logits) > 0, logits,
                             torch.full_like(logits, _NEG_BIG))
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(seg_max <= _NEG_BIG / 2,
                          torch.zeros_like(seg_max), seg_max)  # empty segments
    exp = torch.exp(logits - seg_max[segment_ids])
    if mask is not None:
        exp = exp * _bcast(mask, exp)
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return exp / denom[segment_ids]


def gat_attention_pass(
    node_feats_h: torch.Tensor,   # (N, H, D) per-head node features
    edge_attr_h: torch.Tensor,    # (E, H, Da) per-head (or broadcast) attrs
    src: torch.Tensor,            # (E,) int — message source nodes
    dst: torch.Tensor,            # (E,) int — aggregation targets
    attn_vec: torch.Tensor,       # (H, 2*D + Da) attention parameter
    num_nodes: int,
    edge_mask: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    ep=None,
    need_attn: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One GAT-style attention pass — the reference's repeated block
    (gat2.py:137-169 and three siblings):

        message   = [h_dst ‖ e ‖ h_src]              (per head)
        logit     = leaky_relu(Σ message · a, 0.2)
        prob      = segment_softmax(logit, dst)
        out[n]    = Σ_{e: dst=n} prob_e · h_src[e]
        attn[n]   = Σ_{e: src=n} prob_e              (reference sums by SOURCE,
                                                      gat2.py:165-167)

    Returns (aggregated (N, H, D), summed_attn (N, H), or None when not
    ``need_attn``).

    ``ep`` (dist/edge_partition.py:EPContext): the edge-partitioned mode of
    the JAX package's ``axis_name`` (ops/segment.py:132-157) — this call
    sees only this rank's edge shard while node state is replicated; the
    softmax shift combines with a MAX all-reduce (no gradient), the
    denominator, ``out`` and ``attn_by_src`` with differentiable SUM
    all-reduces (dist/collectives.py). Its logit terms (nf·a_dst, ea·a_ea,
    nf·a_src) are each summed in f64 and rounded once (ops/gat_logits.py:
    logit_dot), as the kernels' passes take them."""
    h_src = node_feats_h[src]  # (E, H, D)
    if ep is None:
        h_dst = node_feats_h[dst]
        msg = torch.cat([h_dst, edge_attr_h.to(h_dst.dtype), h_src], dim=-1)
        logits = torch.sum(msg.float() * attn_vec[None, :, :].float(), dim=-1)
        logits = F.leaky_relu(logits, negative_slope)
        probs = segment_softmax(logits, dst, num_nodes, mask=edge_mask)
        weighted = probs.to(h_src.dtype)[..., None] * h_src
        out = segment_sum(weighted, dst, num_nodes)
        attn_by_src = segment_sum(probs, src, num_nodes) if need_attn \
            else None
        return out, attn_by_src

    from fragnet_tpu_torch.dist.collectives import (all_reduce_max,
                                                    all_reduce_sum)
    from fragnet_tpu_torch.ops.gat_logits import logit_dot
    from fragnet_tpu_torch.ops.tcsr_gat import node_logits

    H, D = node_feats_h.shape[1:]
    Da = edge_attr_h.shape[-1]
    dl, sl = dst.long(), src.long()
    wn = node_logits(node_feats_h, attn_vec, Da)                # (N, 2H)
    w_ea = logit_dot("ehd,hd->eh", edge_attr_h, attn_vec[:, D:D + Da])
    logits = F.leaky_relu(wn[dl, :H] + w_ea + wn[sl, H:], negative_slope)
    if edge_mask is not None:
        logits = torch.where(_bcast(edge_mask, logits) > 0, logits,
                             torch.full_like(logits, _NEG_BIG))
    # the max shift is gradient-free (it cancels in the softmax)
    with torch.no_grad():
        gmax = all_reduce_max(segment_max(logits.detach(), dst, num_nodes),
                              ep.group)
        gmax = torch.where(gmax <= _NEG_BIG / 2, torch.zeros_like(gmax),
                           gmax)
    ex = torch.exp(logits - gmax[dl])
    if edge_mask is not None:
        ex = ex * _bcast(edge_mask, ex)
    den = all_reduce_sum(segment_sum(ex, dst, num_nodes), ep.group)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    probs = ex / den[dl]
    weighted = probs.to(h_src.dtype)[..., None] * h_src
    out = all_reduce_sum(segment_sum(weighted, dst, num_nodes), ep.group)
    attn_by_src = all_reduce_sum(segment_sum(probs, src, num_nodes),
                                 ep.group) if need_attn else None
    return out, attn_by_src
