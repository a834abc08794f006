"""Token dispatch and weighted combine of a mixture-of-experts layer that
holds some of the experts (``model/moonlight.py``'s ``MoE``).

A router ranks K experts for each of T tokens (``idx`` (T, K), in its
order). ``plan_routes`` builds on the device, from ``idx``, the experts
held here and the real-token mask, where each held assignment goes: its
row in a buffer sorted by held expert (``pos`` (T, K), -1 for a slot whose
expert is not held and for every slot of a padding token, which is routed
nowhere) and the token of each sorted row (``tok`` (A,)). The rows each
held expert takes are read back to the host once, to cut the buffer into
the experts' slices. No token is dropped: there is no capacity.

``dispatch(x, tok, pos)`` gathers the tokens' rows into the sorted buffer;
``combine(y, w, pos)`` sums, for each token, its held slots' rows of the
experts' output weighted by the router's ``w`` (T, K), in slot order. On
CUDA both run the kernels of ``csrc/moe_route.cu`` behind autograd
Functions (the dispatch's backward is the combine with unit weights; the
combine's is ``moe_combine_bwd``), with a launch count each and no
fallback: a CUDA tensor the kernels do not take raises. CPU tensors take
the plain versions (``gather_plain``, ``combine_plain``), with autograd
through them; ``combine_bwd_plain`` writes the combine's backward out as
the kernel computes it.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.ops import _cuda

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong

GATHER = _cuda.CudaKernel("moe_route.cu", "moe_gather",
                          [_VP, _VP, _VP, _LL, _LL, _VP])
COMBINE = _cuda.CudaKernel("moe_route.cu", "moe_combine",
                           [_VP, _VP, _VP, _VP, _LL, _LL, _LL, _VP])
COMBINE_BWD = _cuda.CudaKernel("moe_route.cu", "moe_combine_bwd",
                               [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL,
                                _VP])

# csrc/moe_route.cu: slots a token
MAX_K = 8


class Routes(NamedTuple):
    """Where a layer's held assignments go: ``tok`` (A,) int32, the token
    of each row of the expert-sorted buffer; ``pos`` (T, K) int32, each
    slot's row there or -1; ``counts``, the rows of each held expert in
    the order held (host ints, summing to A); ``tokens_held``, the tokens
    with a slot held here (a host int)."""
    tok: torch.Tensor
    pos: torch.Tensor
    counts: List[int]
    tokens_held: int


def plan_routes(idx: torch.Tensor, local_of: torch.Tensor, n_held: int,
                real: torch.Tensor) -> Routes:
    """The routes of ``idx`` (T, K) expert ids: ``local_of`` (n_experts,)
    maps an expert id to its place among the ``n_held`` experts held here,
    -1 if it is not held; ``real`` (T,) bool marks the real tokens. The
    buffer holds the experts' rows in the order held, each expert's in
    token order (a stable sort of the slots by held expert). Built on the
    device, with one read-back of n_held + 1 integers."""
    T, K = idx.shape
    local = torch.where(real[:, None], local_of[idx], -1)
    held = local >= 0
    key = torch.where(held, local, n_held).reshape(-1)
    order = torch.sort(key, stable=True).indices
    stats = torch.cat([torch.bincount(key, minlength=n_held + 1)[:n_held],
                       held.any(1).sum().view(1)])
    host = stats.tolist()
    counts, tokens_held = host[:n_held], host[n_held]
    A = sum(counts)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=idx.device)
    pos = torch.where(held.reshape(-1), rank, -1).view(T, K).to(torch.int32)
    tok = torch.div(order[:A], K, rounding_mode="floor").to(torch.int32)
    return Routes(tok, pos, counts, tokens_held)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gather_plain(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(A, D): the rows ``x[tok]``."""
    return x.index_select(0, tok.long())


def combine_plain(y: torch.Tensor, pos: torch.Tensor,
                  w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, D): for each token the sum over its slots k in order, where
    ``pos[t, k] >= 0``, of ``w[t, k] * y[pos[t, k]]`` (the rows alone
    where ``w`` is None), starting from 0, each product and sum rounded
    once."""
    T, K = pos.shape
    out = y.new_zeros((T, y.shape[1]))
    for k in range(K):
        p = pos[:, k].long()
        held = (p >= 0)[:, None]
        rows = y.index_select(0, p.clamp(min=0)) if y.shape[0] else \
            y.new_zeros((T, y.shape[1]))
        term = rows if w is None else w[:, k:k + 1] * rows
        out = torch.where(held, out + term, out)
    return out


def combine_bwd_plain(y: torch.Tensor, pos: torch.Tensor, w: torch.Tensor,
                      d_out: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_y (A, D), d_w (T, K)) of ``combine_plain(y, pos, w)`` for
    ``d_out`` (T, D): ``d_y[pos[t, k]] = w[t, k] * d_out[t]``, ``d_w[t, k]
    = <y[pos[t, k]], d_out[t]>``, 0 where ``pos[t, k] < 0``."""
    T, K = pos.shape
    p = pos.long().reshape(-1)
    held = p >= 0
    t_of = torch.arange(T, device=pos.device).repeat_interleave(K)
    d_y = torch.zeros_like(y)
    d_y[p[held]] = w.reshape(-1)[held, None] * d_out[t_of[held]]
    d_w = torch.zeros(T * K, dtype=y.dtype, device=y.device)
    d_w[held] = (y[p[held]] * d_out[t_of[held]]).sum(-1)
    return d_y, d_w.view(T, K)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(t: torch.Tensor, name: str, rows: int, D: int, dev) -> None:
    _cuda.check(t, name, torch.float32, (rows, D), dev)
    if rows:
        _cuda.check_aligned(t, name, 16)


def _check_common(y: torch.Tensor, pos: torch.Tensor,
                  w: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"no moe_route kernel for device {dev}")
    if y.dim() != 2 or y.shape[1] % 4:
        raise ValueError(f"moe_route: rows of shape {tuple(y.shape)}: the "
                         f"kernels take (rows, D) with D a multiple of 4")
    T, K = pos.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"moe_route: {K} slots a token, 1 to {MAX_K}")
    D = y.shape[1]
    _check_rows(y, "y", y.shape[0], D, dev)
    _cuda.check(pos, "pos", torch.int32, (T, K), dev)
    if w is not None:
        _cuda.check(w, "w", torch.float32, (T, K), dev)
    return T, K, D


def _p(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return _VP(None if t is None else t.data_ptr())


def moe_gather(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: (A, D) f32, the rows ``x[tok]``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no moe_route kernel for device {dev}")
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError(f"moe_gather: rows of shape {tuple(x.shape)}: the "
                         f"kernel takes (rows, D) with D a multiple of 4")
    D = x.shape[1]
    _check_rows(x, "x", x.shape[0], D, dev)
    A = tok.shape[0]
    _cuda.check(tok, "tok", torch.int32, (A,), dev)
    out = torch.empty((A, D), dtype=torch.float32, device=dev)
    GATHER.launch(_p(x), _p(tok), _p(out), A, D // 4, _cuda.stream_ptr(dev))
    return out


def moe_combine(y: torch.Tensor, pos: torch.Tensor,
                w: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel wrapper: (T, D) f32, ``combine_plain(y, pos, w)``."""
    T, K, D = _check_common(y, pos, w)
    out = torch.empty((T, D), dtype=torch.float32, device=y.device)
    COMBINE.launch(_p(y), _p(pos), _p(w), _p(out), T, K, D // 4,
                   _cuda.stream_ptr(y.device))
    return out


def moe_combine_bwd(y: torch.Tensor, pos: torch.Tensor, w: torch.Tensor,
                    d_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: (d_y (A, D), d_w (T, K)) f32,
    ``combine_bwd_plain(y, pos, w, d_out)``."""
    if w is None:
        raise ValueError("moe_combine_bwd: the weights are required")
    T, K, D = _check_common(y, pos, w)
    _check_rows(d_out, "d_out", T, D, y.device)
    d_y = torch.empty_like(y)
    d_w = torch.empty((T, K), dtype=torch.float32, device=y.device)
    COMBINE_BWD.launch(_p(y), _p(pos), _p(w), _p(d_out), _p(d_y), _p(d_w),
                       T, K, D // 4, _cuda.stream_ptr(y.device))
    return d_y, d_w


class DispatchFn(torch.autograd.Function):
    """(x (T, D), tok, pos) → the sorted rows ``x[tok]``; the gradient of
    x is each token's rows' gradients summed in slot order (the combine
    kernel with unit weights)."""

    @staticmethod
    def forward(ctx, x, tok, pos):
        ctx.save_for_backward(pos)
        ctx.span = obs.current()
        return moe_gather(x, tok)

    @staticmethod
    @obs.spanned_backward
    def backward(ctx, d_rows):
        (pos,) = ctx.saved_tensors
        return moe_combine(d_rows.contiguous(), pos, None), None, None


class CombineFn(torch.autograd.Function):
    """(y (A, D), w (T, K), pos) → each token's weighted sum of its held
    slots' rows; the gradients from ``moe_combine_bwd``."""

    @staticmethod
    def forward(ctx, y, w, pos):
        ctx.save_for_backward(y, w, pos)
        ctx.span = obs.current()
        return moe_combine(y, pos, w)

    @staticmethod
    @obs.spanned_backward
    def backward(ctx, d_out):
        y, w, pos = ctx.saved_tensors
        d_y, d_w = moe_combine_bwd(y, pos, w, d_out.contiguous())
        return d_y, d_w, None


def dispatch(x: torch.Tensor, tok: torch.Tensor,
             pos: torch.Tensor) -> torch.Tensor:
    """The sorted rows ``x[tok]``: the kernel on CUDA, else the plain
    gather."""
    if x.is_cuda:
        return DispatchFn.apply(x, tok, pos)
    return gather_plain(x, tok)


def combine(y: torch.Tensor, w: torch.Tensor,
            pos: torch.Tensor) -> torch.Tensor:
    """Each token's held slots' rows of ``y`` weighted by ``w``, summed in
    slot order: the kernel on CUDA, else the plain version."""
    if y.is_cuda:
        return CombineFn.apply(y, w.contiguous(), pos)
    return combine_plain(y, pos, w)
