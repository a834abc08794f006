"""The GAT logit terms: wn = [nf·a_dst | nf·a_src] per head and w_ea =
ea·a_ea (pallas_gat.py:471-479, where they are XLA einsums), summed in f64
and rounded once to f32.

A logit's terms can cancel to within f32 round-off of the leaky ReLU's kink
(an ea·a_ea dot of terms near 1 summing to 1e-2): an f32 sum then lands on
the side its BLAS's order gives, which changes with the machine, and the
gradient through that edge by the slope's factor 5. Rounded once from f64,
each term is within half an ulp of its exact value on every machine.

CUDA tensors go through ``GatLogitsFn``: the forward and backward kernels of
csrc/gat_logits.cu read the rows as they are (f32 or bf16, no copies) and
sum in f64 registers; ``gat_logits_dvec`` sums the backward's per-block
partials of the attention vector's gradient in order. A CUDA tensor the
kernels do not take raises. CPU tensors take ``logit_dot``, the f64 einsum,
with autograd through it (``gat_logits_plain``); ``gat_logits_bwd_plain``
writes that backward out from the formulas, as the kernels compute it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.ops import _cuda

_VP = ctypes.c_void_p

KERNEL = _cuda.CudaKernel("gat_logits.cu", "gat_logits_fwd", [_VP] * 7)
KERNEL_BF16 = _cuda.CudaKernel("gat_logits.cu", "gat_logits_fwd_bf16",
                               [_VP] * 7)
KERNEL_BWD = _cuda.CudaKernel("gat_logits.cu", "gat_logits_bwd", [_VP] * 10)
KERNEL_BWD_BF16 = _cuda.CudaKernel("gat_logits.cu", "gat_logits_bwd_bf16",
                                   [_VP] * 10)
KERNEL_DVEC = _cuda.CudaKernel("gat_logits.cu", "gat_logits_dvec", [_VP] * 4)

# csrc/gat_logits.cu: threads a block, attention values a slot holds
_THREADS = 256
_MAX_KV = 16
# blocks a launch, per SM (the backward's partials of d_vec: one a block)
_BLOCKS_PER_SM = 4


def logit_dot(eq: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, y)`` of a logit term, summed in f64 and rounded
    once to f32."""
    return torch.einsum(eq, x.double(), y.double()).float()


def gat_logits_plain(nf: Optional[torch.Tensor], ea: Optional[torch.Tensor],
                     a: torch.Tensor, Da: int):
    """(wn (N, 2H) or None, w_ea (E, H) or None): the logit terms of node
    features ``nf`` (N, H, D) and edge attributes ``ea`` (E, Da), either
    None, for the attention vector ``a`` (H, 2D + Da) = [a_dst | a_ea |
    a_src], as f64 einsums (``logit_dot``), the node terms in one."""
    wn = w_ea = None
    D = (a.shape[1] - Da) // 2
    if nf is not None:
        N, H, _ = nf.shape
        a_nodes = torch.stack([a[:, :D], a[:, D + Da:]])        # (2, H, D)
        wn = logit_dot("nhd,khd->nkh", nf, a_nodes).reshape(N, 2 * H)
    if ea is not None:
        w_ea = logit_dot("ed,hd->eh", ea, a[:, D:D + Da])
    return wn, w_ea


def gat_logits_bwd_plain(nf, ea, a, Da: int, d_wn, d_wea):
    """(d_a (H, 2D + Da) f32, d_nf or None, d_ea or None) for the
    cotangents ``d_wn`` (N, 2H) and ``d_wea`` (E, H), written out from the
    formulas as the kernels compute them: every product and sum in f64,
    each output rounded once to its input's type (bf16 through f32, as
    torch's cast from f64 does)."""
    H, Wa = a.shape
    D = (Wa - Da) // 2
    a64 = a.double()
    d_a = torch.zeros((H, Wa), dtype=torch.float64, device=a.device)
    d_nf = d_ea = None
    if nf is not None:
        x = nf.double()                                         # (N, H, D)
        g = d_wn.double().view(-1, 2, H, 1)
        d_nf = (g[:, 0] * a64[:, :D] + g[:, 1] * a64[:, D + Da:]).to(
            nf.dtype)
        d_a[:, :D] = (g[:, 0] * x).sum(0)
        d_a[:, D + Da:] = (g[:, 1] * x).sum(0)
    if ea is not None:
        g = d_wea.double()                                      # (E, H)
        d_ea = (g @ a64[:, D:D + Da]).to(ea.dtype)
        d_a[:, D:D + Da] = g.t() @ ea.double()
    return d_a.float(), d_nf, d_ea


class Plan(NamedTuple):
    """How the kernels walk one row set: V columns a load, Qp slots a
    segment (L / V rounded up to a power of two), TR rows a tile of one
    block's 256 threads, and the set's tiles."""
    V: int
    Qp: int
    TR: int
    tiles: int


def plan(R: int, S: int, L: int, K: int, stride: int, elem: int,
         ptr: int) -> Plan:
    """The kernels' walk over R rows of S segments of L columns with K
    attention vectors a segment, ``stride`` elements of ``elem`` bytes
    apart from address ``ptr``: the widest load (16 bytes, else 8, 4, 2)
    that L, the stride and the address allow and that keeps a slot's K·V
    attention values (and backward sums) within 16 f64 registers. Raises
    where a segment would need more slots than a block has threads."""
    if K > _MAX_KV:
        raise ValueError(f"gat_logits: {K} vectors a segment, at most "
                         f"{_MAX_KV}")
    V = 16 // elem
    while V > 1 and (L % V or stride % V or ptr % (V * elem)
                     or K * V > _MAX_KV):
        V //= 2
    Qp = 1 << max(L // V - 1, 0).bit_length()
    C = S * Qp
    if C > _THREADS:
        raise ValueError(f"gat_logits: rows of {S} x {L} columns need {C} "
                         f"slots of {V}, at most {_THREADS}")
    TR = _THREADS // C
    return Plan(V, Qp, TR, -(-R // TR))


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(sets, n_sm: int):
    """Each set's blocks: about _BLOCKS_PER_SM a SM in all, shared by the
    sets' slots × vectors × rows, at least one and at most a tile each."""
    work = [s.R * s.S * s.plan.Qp * s.K if s else 0 for s in sets]
    total = sum(work)
    return [min(s.plan.tiles, max(1, round(_BLOCKS_PER_SM * n_sm * w
                                           / total))) if w else 0
            for s, w in zip(sets, work)]


class _RowSet(NamedTuple):
    x: torch.Tensor
    R: int
    stride: int
    S: int
    L: int
    K: int
    node: int
    plan: Plan


def _row_set(name, x, node: bool, H: int, D: int, Da: int, dev):
    """The node (N, H, D) or edge (E, Da) rows ``x`` as the kernels take
    them, or None for None; raises on a dtype, shape, layout or alignment
    they do not take."""
    if x is None:
        return None
    _cuda.check_compute_dtype(f"gat_logits {name}", x)
    shape = (x.shape[0], H, D) if node else (x.shape[0], Da)
    _cuda.check(x, name, x.dtype, shape, dev, inner_contiguous=True)
    _cuda.check_aligned(x, name, x.element_size())
    S, L, K = (H, D, 2) if node else (1, Da, H)
    if L < 1:
        raise ValueError(f"gat_logits: {name} rows of width 0")
    R = x.shape[0]
    stride = x.stride(0) if R > 1 else S * L
    return _RowSet(x, R, stride, S, L, K, int(node),
                   plan(R, S, L, K, stride, x.element_size(), x.data_ptr()))


def _sets(nf, ea, a, Da: int):
    """([node rows, edge rows] as _RowSets or None, the kernels' cfg (a
    host int64 array, csrc/gat_logits.cu), the backward's partials (f64
    values), whether the bf16 entries launch) for one call; raises on
    what the kernels do not take."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"no gat_logits kernel for device {dev}")
    H, Wa = a.shape
    D = nf.shape[2] if nf is not None else (Wa - Da) // 2
    _cuda.check(a, "a", torch.float32, (H, 2 * D + Da), dev,
                inner_contiguous=True)
    _cuda.check_aligned(a, "a", 4)
    sets = [_row_set("nf", nf, True, H, D, Da, dev),
            _row_set("ea", ea, False, H, D, Da, dev)]
    blocks = _blocks(sets, _n_sm(dev.index if dev.index is not None
                                 else torch.cuda.current_device()))
    part0, cfg = 0, [H, D, Da, a.stride(0)]
    for s, b in zip(sets, blocks):
        if s is None:
            cfg += [0] * 12
            continue
        p = s.plan
        cfg += [s.R, s.stride, part0, s.S, s.L, s.K, s.node,
                int(s.x.dtype == torch.bfloat16), p.V, p.Qp, p.TR, b]
        part0 += b * s.K * s.S * s.L
    bf16 = any(s is not None and s.R and s.x.dtype == torch.bfloat16
               for s in sets)
    return sets, (ctypes.c_longlong * len(cfg))(*cfg), part0, bf16


def _ptr(t):
    return _VP(None if t is None else t.data_ptr())


def gat_logits_fwd(nf, ea, a, Da: int):
    """Forward kernel wrapper: (wn (N, 2H) or None, w_ea (E, H) or None) f32,
    both row sets in one launch (the bf16 entry where either is bf16)."""
    sets, cfg, _, bf16 = _sets(nf, ea, a, Da)
    outs = [None if s is None else
            torch.empty((s.R, s.K * s.S), dtype=torch.float32,
                        device=a.device) for s in sets]
    (KERNEL_BF16 if bf16 else KERNEL).launch(
        _ptr(a), _ptr(nf), _ptr(outs[0]), _ptr(ea), _ptr(outs[1]),
        _VP(ctypes.addressof(cfg)), _cuda.stream_ptr(a.device))
    return outs[0], outs[1]


def gat_logits_bwd(nf, ea, a, Da: int, d_wn, d_wea):
    """Backward kernel wrapper: (d_a (H, 2D + Da) f32, d_nf or None, d_ea
    or None), each row gradient in its input's type, for the cotangents
    ``d_wn`` (N, 2H) and ``d_wea`` (E, H) f32."""
    sets, cfg, n_part, bf16 = _sets(nf, ea, a, Da)
    dev = a.device
    dws, dx = [], []
    for s, dw, name in zip(sets, (d_wn, d_wea), ("d_wn", "d_wea")):
        if s is not None:
            dw = dw.contiguous()
            _cuda.check(dw, name, torch.float32, (s.R, s.K * s.S), dev)
        dws.append(dw)
        dx.append(None if s is None else
                  torch.empty(s.x.shape, dtype=s.x.dtype, device=dev))
    part = torch.empty(n_part, dtype=torch.float64, device=dev)
    d_a = torch.empty(a.shape, dtype=torch.float32, device=dev)
    stream = _cuda.stream_ptr(dev)
    cfg_p = _VP(ctypes.addressof(cfg))
    (KERNEL_BWD_BF16 if bf16 else KERNEL_BWD).launch(
        _ptr(a), _ptr(nf), _ptr(dx[0]), _ptr(dws[0]), _ptr(ea), _ptr(dx[1]),
        _ptr(dws[1]), _ptr(part), cfg_p, stream)
    KERNEL_DVEC.launch(_ptr(part), _ptr(d_a), cfg_p, stream)
    return d_a, dx[0], dx[1]


class GatLogitsFn(torch.autograd.Function):
    """(a, nf, ea) → the logit terms of the row sets given (wn for ``nf``,
    w_ea for ``ea``, in that order) through the forward kernel, with the
    backward kernels as the gradient: d_nf, d_ea in their inputs' types
    and d_a (H, 2D + Da) in a's layout, zeros where no row set reads it."""

    @staticmethod
    def forward(ctx, a, nf, ea, Da):
        wn, w_ea = gat_logits_fwd(nf, ea, a, Da)
        ctx.save_for_backward(a, nf, ea)
        ctx.Da = Da
        ctx.span = obs.current()
        return tuple(t for t in (wn, w_ea) if t is not None)

    @staticmethod
    @obs.spanned_backward
    def backward(ctx, *grads):
        a, nf, ea = ctx.saved_tensors
        it = iter(grads)
        d_wn = next(it) if nf is not None else None
        d_wea = next(it) if ea is not None else None
        d_a, d_nf, d_ea = gat_logits_bwd(nf, ea, a, ctx.Da, d_wn, d_wea)
        return d_a, d_nf, d_ea, None


def logit_terms(nf: Optional[torch.Tensor], ea: Optional[torch.Tensor],
                a: torch.Tensor, Da: int
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(wn (N, 2H) = [w_dst | w_src] or None, w_ea (E, H) or None) in f32
    for node features ``nf`` (N, H, D) and edge attributes ``ea`` (E, Da),
    either None, and the attention vector ``a`` (H, 2D + Da) = [a_dst |
    a_ea | a_src]: through the kernels where a tensor is on CUDA, else the
    f64 einsums."""
    if any(t is not None and t.is_cuda for t in (nf, ea, a)):
        outs = iter(GatLogitsFn.apply(a, nf, ea, Da))
        return (next(outs) if nf is not None else None,
                next(outs) if ea is not None else None)
    return gat_logits_plain(nf, ea, a, Da)
