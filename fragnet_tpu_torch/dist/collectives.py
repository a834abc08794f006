"""Collectives on the process group's backend device, below both the ops
and the training layers (it imports only torch).

Each collective moves a tensor to the backend's device and back — gloo
stages CUDA tensors through host memory, NCCL takes CPU tensors through the
rank's card — so one code path serves both; the kernels still run on the
card. ``all_gather_rows`` is the differentiable all-gather of the
edge-partitioned pass (ops/tcsr_gat.py:tcsr_gat_pass_ep), built from
``all_gather`` and ``all_reduce`` only, which gloo and NCCL both take;
``all_reduce_sum`` (differentiable) and ``all_reduce_max`` (no gradient)
are the segment edge-partitioned pass's (ops/segment.py:
gat_attention_pass with ``ep``). A bf16 or f16 tensor is reduced in f32
and rounded once back to its type.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def all_reduce(t: torch.Tensor, group=None, average: bool = False
               ) -> torch.Tensor:
    """The SUM (or, with ``average``, the mean) of ``t`` over the ranks of
    ``group``, as a new tensor on ``t``'s device."""
    return _reduce(t, dist.ReduceOp.SUM, group, average)


def _reduce(t: torch.Tensor, op, group, average: bool = False
            ) -> torch.Tensor:
    wide = t.dtype in (torch.bfloat16, torch.float16)
    buf = t.detach().to(_comm_device(group),
                        dtype=torch.float32 if wide else t.dtype, copy=True)
    dist.all_reduce(buf, op=op, group=group)
    if average:
        buf /= dist.get_world_size(group)
    return buf.to(t.device, t.dtype)


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise MAX of ``t`` over the ranks of ``group`` (no
    gradient: the softmax shift it serves cancels in the softmax)."""
    return _reduce(t, dist.ReduceOp.MAX, group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new leading axis, in rank order."""
    src = t.detach().contiguous().to(_comm_device(group))
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


class _AllGatherRows(torch.autograd.Function):
    """Every rank's block stacked on a new leading axis; the backward is the
    transpose (reduce-scatter SUM): the cotangent all-reduced over the
    ranks, then this rank's block."""

    @staticmethod
    def forward(ctx, x, rank, group):
        ctx.rank, ctx.group = rank, group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group)[ctx.rank], None, None


def all_gather_rows(x: torch.Tensor, rank: int, group=None) -> torch.Tensor:
    """Differentiable all-gather of ``x`` over ``group`` (see
    _AllGatherRows)."""
    return _AllGatherRows.apply(x, rank, group)


class _AllReduceSum(torch.autograd.Function):
    """The SUM over the ranks; the backward all-reduces the cotangent too
    (the JAX package's ``psum``, whose transpose under
    ``shard_map(check_vma=False)`` is ``psum``). Every rank computes the
    same loss, so a rank's partial sum receives S times its true
    cotangent; the caller's gradient average over the ranks
    (data_parallel.average_gradients) restores it, as for
    ``all_gather_rows``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM all-reduce of ``x`` over ``group`` (see
    _AllReduceSum)."""
    return _AllReduceSum.apply(x, group)
