"""Fused TCSR GAT pass — counterpart of fragnet_tpu/ops/pallas_gat.py.

One GAT pass (math contract: ops/segment.py:gat_attention_pass) over the
TCSR layout of ops/tcsr.py, in four parts:

  * ``prologue`` — the per-node and per-edge logit terms (pallas_gat.py:
    471-479): w_dst = nf·a_dst, w_src = nf·a_src per head, w_ea = ea·a_ea;
  * ``tcsr_gat_fwd`` — the forward kernel (csrc/tcsr_gat_fwd.cu, which
    replaces pallas_gat.py:_fwd_kernel): segment-softmax aggregation per
    destination tile, self-loops folded in analytically; emits out, m, den.
    ``tcsr_gat_fwd_plain`` is the same function in plain PyTorch;
  * ``tcsr_gat_bwd`` — the backward kernel (csrc/tcsr_gat_bwd.cu, which
    replaces pallas_gat.py:_bwd_kernel): d_wn, d_nf (the p·g aggregation)
    and d_w_ea from (m, den), with ``tcsr_gat_bwd_plain`` beside it;
    ``TcsrGatFn`` joins the two as the autograd boundary (pallas_gat.py:
    op_bwd), and the prologue stays plain torch, so autograd carries d_wn
    and d_w_ea on to nf, ea and the attention vector;
  * the summed-attention-by-source epilogue (pallas_gat.py:598-622),
    rebuilt from (m, den) with torch ops on detached tensors, only when
    asked for;
  * the edge-partitioned pass ``tcsr_gat_pass_ep`` (pallas_gat.py:
    625-869): K3's forward and backward (``tcsr_gat_ep_fwd`` /
    ``tcsr_gat_ep_bwd``, entry points of the same two sources) on one edge
    shard per rank, with the cross-shard softmax combine in torch around
    them.

A CUDA tensor goes through the kernels or the call raises; only CPU tensors
take the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fragnet_tpu_torch.dist.collectives import (all_gather, all_gather_rows,
                                                all_reduce)
from fragnet_tpu_torch.ops import _cuda
from fragnet_tpu_torch.ops.tcsr import EPTileMeta, TileMeta

_NEG = -1e30
_VP = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _cuda.CudaKernel(
    "tcsr_gat_fwd.cu", "tcsr_gat_fwd",
    [_VP] * 11 + [_I] * 6 + [ctypes.c_float, _VP])
KERNEL_BWD = _cuda.CudaKernel(
    "tcsr_gat_bwd.cu", "tcsr_gat_bwd",
    [_VP] * 16 + [_I] * 8 + [ctypes.c_float, _VP])

# the widest row the kernels take (H*D, lanes of float4) and their rows per
# block (csrc/tcsr_gat_fwd.cu, csrc/tcsr_gat_bwd.cu kRows)
_MAX_HD = 256
_ROWS = 8


def prologue(nf: torch.Tensor, ea: torch.Tensor, a: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wn (N, 2H) = [w_dst | w_src], w_ea (E, H)) in f32."""
    D = nf.shape[2]
    Da = ea.shape[-1]
    nf32 = nf.float()
    a32 = a.float()
    a_dst, a_ea, a_src = a32[:, :D], a32[:, D:D + Da], a32[:, D + Da:]
    w_dst = torch.einsum("nhd,hd->nh", nf32, a_dst)
    w_src = torch.einsum("nhd,hd->nh", nf32, a_src)
    wn = torch.cat([w_dst, w_src], dim=-1)
    w_ea = ea.float() @ a_ea.T
    return wn, w_ea


def tcsr_gat_fwd_plain(wn, nf, w_ea, src, dst, emask, meta: TileMeta,
                       self_loops: bool, slope: float = 0.2):
    """Plain PyTorch version of the forward kernel: same inputs, same
    (out (N, H*D), m (N, H), den (N, H)). It reads every kept edge directly
    (TileMeta guarantees each lies in its tile's window)."""
    N, HD = nf.shape
    H = wn.shape[1] // 2
    D = HD // H
    keep = emask > 0
    s, d = src[keep].long(), dst[keep].long()
    z = F.leaky_relu(wn[d, :H] + wn[s, H:] + w_ea[keep], slope)   # (Ek, H)
    if self_loops:
        z_self = F.leaky_relu(wn[:, :H] + wn[:, H:], slope)
        m = z_self.clone()
    else:
        m = torch.full((N, H), _NEG, dtype=torch.float32, device=nf.device)
    m = m.scatter_reduce(0, d[:, None].expand_as(z), z, "amax")
    p = torch.exp(z - m[d])
    den = torch.zeros((N, H), dtype=torch.float32, device=nf.device)
    num = torch.zeros((N, H, D), dtype=torch.float32, device=nf.device)
    if self_loops:
        p_self = torch.exp(z_self - m)
        den = den + p_self
        num = num + p_self[..., None] * nf.view(N, H, D)
    den = den.index_add(0, d, p)
    num = num.index_add(0, d, p[..., None] * nf.view(N, H, D)[s])
    den_g = torch.where(den == 0.0, torch.ones_like(den), den)
    return (num / den_g[..., None]).reshape(N, HD), m, den


def _check_cuda(name, wn, nf, w_ea, src, dst, emask, meta: TileMeta,
                extra=()):
    """Raise unless the kernels take these tensors; returns (N, HD, H, E,
    n_tiles). ``extra`` adds (name, tensor, dtype, shape) node arrays."""
    if nf.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {nf.device}")
    N, HD = nf.shape
    H = wn.shape[1] // 2
    E = src.shape[0]
    tn, te = meta.tn, meta.te
    if H <= 0 or HD % H or N % tn or E % te:
        raise ValueError(f"{name}: bad shapes N={N} HD={HD} H={H} "
                         f"E={E} tn={tn} te={te}")
    n_tiles = N // tn
    f32, i32 = torch.float32, torch.int32
    for arg, t, dt, shape in (
            ("wn", wn, f32, (N, 2 * H)), ("nf", nf, f32, (N, HD)),
            ("w_ea", w_ea, f32, (E, H)), ("src", src, i32, (E,)),
            ("dst", dst, i32, (E,)), ("emask", emask, f32, (E,)),
            ("ew_blk", meta.ew_blk, i32, (n_tiles,)),
            ("cw", meta.cw, i32, (n_tiles,))) + tuple(extra):
        _cuda.check(t, arg, dt, shape, nf.device)
    return N, HD, H, E, n_tiles


def _check_fwd(name, nf, H: int, tn: int):
    """Raise unless the forward kernel (csrc/tcsr_gat_fwd.cu) takes this row
    width and tile: lanes read nf in float4 (D a multiple of 4, nf 16-byte
    aligned, H*D <= 256) and a block takes _ROWS rows of a tile."""
    HD = nf.shape[1]
    D = HD // H
    if D % 4 or HD > _MAX_HD or tn % _ROWS:
        raise ValueError(f"{name}: H={H} D={D} tn={tn} unsupported (D a "
                         f"multiple of 4, H*D <= {_MAX_HD}, tn a multiple "
                         f"of {_ROWS})")
    _cuda.check_aligned(nf, "nf", 16)


def tcsr_gat_fwd(wn, nf, w_ea, src, dst, emask, meta: TileMeta,
                 self_loops: bool, slope: float = 0.2):
    """Forward kernel wrapper: (out (N, H*D), m (N, H), den (N, H)) f32.

    ``wn`` (N, 2H) f32, ``nf`` (N, H*D) f32, ``w_ea`` (E, H) f32, ``src`` /
    ``dst`` (E,) int32, ``emask`` (E,) f32; ``meta`` holds ``ew_blk`` and
    ``cw`` (n_tiles,) int32 tensors on the same device."""
    if nf.device.type == "cpu":
        return tcsr_gat_fwd_plain(wn, nf, w_ea, src, dst, emask, meta,
                                  self_loops, slope)
    N, HD, H, E, n_tiles = _check_cuda("tcsr_gat_fwd", wn, nf, w_ea, src,
                                       dst, emask, meta)
    tn = meta.tn
    _check_fwd("tcsr_gat_fwd", nf, H, tn)
    dev = nf.device
    out = torch.empty((N, HD), dtype=torch.float32, device=dev)
    m = torch.empty((N, H), dtype=torch.float32, device=dev)
    den = torch.empty((N, H), dtype=torch.float32, device=dev)
    P = _cuda.ptr
    KERNEL.launch(P(wn), P(nf), P(w_ea), P(src), P(dst), P(emask),
                  P(meta.ew_blk), P(meta.cw), P(out), P(m), P(den),
                  n_tiles, tn, meta.te, H, HD // H, int(bool(self_loops)),
                  ctypes.c_float(slope), _cuda.stream_ptr(dev))
    return out, m, den


def tcsr_gat_bwd_plain(wn, nf, w_ea, src, dst, emask, meta: TileMeta, m, den,
                       g, s, self_loops: bool, slope: float = 0.2):
    """Plain PyTorch version of the backward kernel, written out from the
    formulas (not autograd of the plain forward, so the two check each
    other): (d_wn (N, 2H), d_nf (N, H*D), d_w_ea (E, H)) for the cotangent
    ``g`` (N, H*D) of out, with ``s`` (N, H) = Σ_d g·out."""
    N, HD = nf.shape
    H = wn.shape[1] // 2
    D = HD // H
    keep = emask > 0
    sk, dk = src[keep].long(), dst[keep].long()
    den_g = torch.where(den == 0.0, torch.ones_like(den), den)
    g3, nf3 = g.view(N, H, D), nf.view(N, H, D)

    def grads(zpre, d_rows, s_rows):
        p = torch.exp(F.leaky_relu(zpre, slope) - m[d_rows]) / den_g[d_rows]
        d_p = (g3[d_rows] * nf3[s_rows]).sum(-1)
        fac = torch.where(zpre > 0, torch.ones_like(zpre),
                          torch.full_like(zpre, slope))
        return p, p * (d_p - s[d_rows]) * fac

    p, dz = grads(wn[dk, :H] + wn[sk, H:] + w_ea[keep], dk, sk)
    d_w_ea = torch.zeros_like(w_ea)
    d_w_ea[keep] = dz
    d_dst = torch.zeros((N, H), dtype=dz.dtype, device=dz.device)
    d_dst = d_dst.index_add(0, dk, dz)
    d_src = torch.zeros_like(d_dst).index_add(0, sk, dz)
    d_nf = torch.zeros_like(g3).index_add(0, sk, p[..., None] * g3[dk])
    if self_loops:
        n = torch.arange(N, device=nf.device)
        p_s, dz_s = grads(wn[:, :H] + wn[:, H:], n, n)
        d_dst, d_src = d_dst + dz_s, d_src + dz_s
        d_nf = d_nf + p_s[..., None] * g3
    return torch.cat([d_dst, d_src], dim=1), d_nf.reshape(N, HD), d_w_ea


def _check_bwd(name, nf, g, H: int, tn: int):
    """Raise unless the backward kernel (csrc/tcsr_gat_bwd.cu) takes this
    row width and tile: lanes read nf and g in float4 and sum a head's D/4
    lanes by shuffles (D/4 a power of two up to 32, H*D <= 256, both 16-byte
    aligned), and a block takes _ROWS rows."""
    HD = nf.shape[1]
    D = HD // H
    if D % 4 or D // 4 not in (1, 2, 4, 8, 16, 32) or HD > _MAX_HD \
            or tn % _ROWS:
        raise ValueError(f"{name}: H={H} D={D} tn={tn} unsupported (D in 4, "
                         f"8, ..., 128; H*D <= {_MAX_HD}; tn a multiple of "
                         f"{_ROWS})")
    _cuda.check_aligned(nf, "nf", 16)
    _cuda.check_aligned(g, "g", 16)


def tcsr_gat_bwd(wn, nf, w_ea, src, dst, emask, meta: TileMeta, m, den, g, s,
                 self_loops: bool, slope: float = 0.2):
    """Backward kernel wrapper: (d_wn (N, 2H), d_nf (N, H*D), d_w_ea (E, H))
    f32, from the forward's inputs, its (m, den), the cotangent ``g`` (N,
    H*D) of out and ``s`` (N, H) = Σ_d g·out. Masked edges get exactly 0.
    ``meta`` holds ``ew_blk``, ``cw`` and ``sw_tile`` (n_tiles,) int32
    tensors on the same device; the kernel writes every output element."""
    if nf.device.type == "cpu":
        return tcsr_gat_bwd_plain(wn, nf, w_ea, src, dst, emask, meta, m, den,
                                  g, s, self_loops, slope)
    f32, i32 = torch.float32, torch.int32
    NH = (nf.shape[0], wn.shape[1] // 2)
    N, HD, H, E, n_tiles = _check_cuda(
        "tcsr_gat_bwd", wn, nf, w_ea, src, dst, emask, meta,
        extra=(("m", m, f32, NH), ("den", den, f32, NH),
               ("g", g, f32, tuple(nf.shape)), ("s", s, f32, NH),
               ("sw_tile", meta.sw_tile, i32, (nf.shape[0] // meta.tn,))))
    _check_bwd("tcsr_gat_bwd", nf, g, H, meta.tn)
    dev = nf.device
    d_wn = torch.empty((N, 2 * H), dtype=f32, device=dev)
    d_nf = torch.empty((N, HD), dtype=f32, device=dev)
    d_w_ea = torch.empty((E, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_BWD.launch(P(wn), P(nf), P(w_ea), P(src), P(dst), P(emask),
                      P(meta.ew_blk), P(meta.cw), P(meta.sw_tile), P(m),
                      P(den), P(g), P(s), P(d_wn), P(d_nf), P(d_w_ea),
                      n_tiles, E, meta.tn, meta.te, meta.k_src, H, HD // H,
                      int(bool(self_loops)), ctypes.c_float(slope),
                      _cuda.stream_ptr(dev))
    return d_wn, d_nf, d_w_ea


class TcsrGatFn(torch.autograd.Function):
    """(wn, nf, w_ea) → (out, m, den) through the forward kernel, with the
    backward kernel as its gradient (pallas_gat.py:493-555). ``m`` and
    ``den`` carry no gradient; ``emask`` and the metadata get none (JAX
    returns zeros for emask)."""

    @staticmethod
    def forward(ctx, wn, nf, w_ea, src, dst, emask, meta, self_loops, slope):
        out, m, den = tcsr_gat_fwd(wn, nf, w_ea, src, dst, emask, meta,
                                   self_loops, slope)
        ctx.save_for_backward(wn, nf, w_ea, src, dst, emask, out, m, den)
        ctx.meta, ctx.self_loops, ctx.slope = meta, self_loops, slope
        ctx.mark_non_differentiable(m, den)
        return out, m, den

    @staticmethod
    def backward(ctx, g_out, _g_m, _g_den):
        wn, nf, w_ea, src, dst, emask, out, m, den = ctx.saved_tensors
        N, HD = nf.shape
        H = wn.shape[1] // 2
        g = g_out.float().contiguous()
        s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)   # _hsum_xla
        d_wn, d_nf, d_w_ea = tcsr_gat_bwd(wn, nf, w_ea, src, dst, emask,
                                          ctx.meta, m, den, g, s,
                                          ctx.self_loops, ctx.slope)
        return d_wn, d_nf, d_w_ea, None, None, None, None, None, None


def attention_by_source(wn, w_ea, src, dst, emask, m, den, self_loops: bool,
                        slope: float = 0.2) -> torch.Tensor:
    """Summed final probabilities by SOURCE (gat2.py:165-167), rebuilt from
    the kernel's softmax state (pallas_gat.py:598-622). An interpretability
    output: callers pass detached tensors (the JAX package's stop_gradient),
    so it carries no gradient."""
    N = wn.shape[0]
    H = wn.shape[1] // 2
    src_l, dst_l = src.long(), dst.long()
    den_s = torch.where(den == 0.0, torch.ones_like(den), den)
    z = F.leaky_relu(wn[dst_l, :H] + wn[src_l, H:] + w_ea, slope)
    # mask BEFORE exp: a masked edge whose dst segment is empty has m = -1e30
    # and exp(z - m) would overflow before the mask could zero it
    expo = torch.where(emask[:, None] > 0, z - m[dst_l],
                       torch.full_like(z, float("-inf")))
    p = torch.exp(expo) / den_s[dst_l]
    attn = torch.zeros((N, H), dtype=torch.float32, device=wn.device)
    attn = attn.index_add(0, src_l, p)
    if self_loops:
        z_self = F.leaky_relu(wn[:, :H] + wn[:, H:], slope)
        attn = attn + torch.exp(z_self - m) / den_s
    return attn


def tcsr_gat_pass(
    node_feats_h: torch.Tensor,   # (N, H, D)
    edge_attr: torch.Tensor,      # (E, Da) — broadcast per head
    src: torch.Tensor,            # (E,) int32
    dst: torch.Tensor,            # (E,) int32
    edge_mask: torch.Tensor,      # (E,)
    attn_vec: torch.Tensor,       # (H, 2D + Da)
    meta: TileMeta,
    self_loops: bool = False,
    negative_slope: float = 0.2,
    return_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused GAT pass (same math as ops.segment.gat_attention_pass). Self-loops
    are folded in analytically when ``self_loops`` (the atom pass,
    gat2.py:179-185: appended after real edges with zero edge attrs).
    Differentiable w.r.t. the node features, edge attrs and attention vector
    through ``TcsrGatFn``.

    Returns ``(out (N,H,D), attn_by_src (N,H) or None)``; the attention
    vector is computed only when ``return_attention`` and carries no
    gradient."""
    N, H, D = node_feats_h.shape
    wn, w_ea = prologue(node_feats_h, edge_attr, attn_vec)
    emask = edge_mask.float().contiguous()
    out, m, den = TcsrGatFn.apply(
        wn.contiguous(), node_feats_h.float().reshape(N, H * D).contiguous(),
        w_ea.contiguous(), src, dst, emask, meta, self_loops, negative_slope)
    out = out.reshape(N, H, D).to(node_feats_h.dtype)
    if not return_attention:
        return out, None
    return out, attention_by_source(wn.detach(), w_ea.detach(), src, dst,
                                    emask, m, den, self_loops,
                                    negative_slope)


# --------------------------------------------------------------------------
# edge-partitioned pass (K3): one edge shard per rank, node state replicated
# (pallas_gat.py:625-869, dist/edge_partition.py)
# --------------------------------------------------------------------------

KERNEL_EP = _cuda.CudaKernel(
    "tcsr_gat_fwd.cu", "tcsr_gat_ep_fwd",
    [_VP] * 12 + [_I] * 5 + [ctypes.c_float, _VP])
KERNEL_EP_BWD = _cuda.CudaKernel(
    "tcsr_gat_bwd.cu", "tcsr_gat_ep_bwd",
    [_VP] * 17 + [_I] * 8 + [ctypes.c_float, _VP])


def _grid_rows(meta: EPTileMeta, rank: int) -> Tuple[int, int]:
    """(first grid row t0·tn, grid rows Ng) of shard ``rank``, as host ints
    (the plain versions' view; the kernels read t0 on the device)."""
    return int(meta.t0[rank, 0]) * meta.tn, meta.n_tiles_grid * meta.tn


def tcsr_gat_ep_fwd_plain(wn, nf, w_ea, src, dst, emask, meta: EPTileMeta,
                          rank: int, slope: float = 0.2):
    """Plain PyTorch version of K3's forward: the whole-batch forward over
    this shard's edges (no self-loops), cut to the shard's grid rows
    [t0·tn, t0·tn + Ng) — every kept edge of the shard has its destination
    there (build_ep_tile_meta checks it)."""
    r0, Ng = _grid_rows(meta, rank)
    out, m, den = tcsr_gat_fwd_plain(wn, nf, w_ea, src, dst, emask, None,
                                     False, slope)
    return out[r0:r0 + Ng], m[r0:r0 + Ng], den[r0:r0 + Ng]


def _check_ep(name, wn, nf, w_ea, src, dst, emask, meta: EPTileMeta,
              rank: int, extra=()):
    """Raise unless K3 takes these tensors; returns (N, HD, H, Ng) and the
    shard's (t0, ew_blk, cw, sw_tile) rows."""
    if nf.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {nf.device}")
    N, HD = nf.shape
    H = wn.shape[1] // 2
    Es = src.shape[0]
    S, Tg = meta.ew_blk.shape
    tn, te = meta.tn, meta.te
    if H <= 0 or HD % H or HD > _MAX_HD or N % tn or Es % te \
            or not 0 <= rank < S:
        raise ValueError(f"{name}: bad shapes N={N} HD={HD} H={H} Es={Es} "
                         f"tn={tn} te={te} rank={rank} of {S} shards")
    f32, i32 = torch.float32, torch.int32
    for arg, t, dt, shape in (
            ("wn", wn, f32, (N, 2 * H)), ("nf", nf, f32, (N, HD)),
            ("w_ea", w_ea, f32, (Es, H)), ("src", src, i32, (Es,)),
            ("dst", dst, i32, (Es,)), ("emask", emask, f32, (Es,)),
            ("t0", meta.t0, i32, (S, 1)), ("ew_blk", meta.ew_blk, i32,
                                            (S, Tg)),
            ("cw", meta.cw, i32, (S, Tg)),
            ("sw_tile", meta.sw_tile, i32, (S, Tg))) + tuple(extra):
        _cuda.check(t, arg, dt, shape, nf.device)
    return (N, HD, H, Tg * tn), (meta.t0[rank], meta.ew_blk[rank],
                                  meta.cw[rank], meta.sw_tile[rank])


def tcsr_gat_ep_fwd(wn, nf, w_ea, src, dst, emask, meta: EPTileMeta,
                    rank: int, slope: float = 0.2):
    """K3 forward wrapper: (out_l (Ng, H*D), m_l (Ng, H), den_l (Ng, H)) f32
    for shard ``rank`` — its ``src``/``dst``/``emask`` (Es,) and ``w_ea``
    (Es, H) against the whole ``wn`` (N, 2H) and ``nf`` (N, H*D); row i is
    node t0·tn + i. ``meta`` holds every shard's rows as int32 tensors on
    the same device."""
    if nf.device.type == "cpu":
        return tcsr_gat_ep_fwd_plain(wn, nf, w_ea, src, dst, emask, meta,
                                     rank, slope)
    (N, HD, H, Ng), (t0, ew, cw, _sw) = _check_ep(
        "tcsr_gat_ep_fwd", wn, nf, w_ea, src, dst, emask, meta, rank)
    tn = meta.tn
    _check_fwd("tcsr_gat_ep_fwd", nf, H, tn)
    dev = nf.device
    out = torch.empty((Ng, HD), dtype=torch.float32, device=dev)
    m = torch.empty((Ng, H), dtype=torch.float32, device=dev)
    den = torch.empty((Ng, H), dtype=torch.float32, device=dev)
    P = _cuda.ptr
    KERNEL_EP.launch(P(wn), P(nf), P(w_ea), P(src), P(dst), P(emask), P(t0),
                     P(ew), P(cw), P(out), P(m), P(den), meta.n_tiles_grid,
                     tn, meta.te, H, HD // H, ctypes.c_float(slope),
                     _cuda.stream_ptr(dev))
    return out, m, den


def tcsr_gat_ep_bwd_plain(wn, nf, w_ea, src, dst, emask, meta: EPTileMeta,
                          rank: int, m, dU, dV, slope: float = 0.2):
    """Plain PyTorch version of K3's backward, from the formulas: the
    gradient of the shard's U = Σ_e exp(z − m[dst])·nf[src] and V = Σ_e
    exp(z − m[dst]) (grid rows, ``m`` (Ng, H) the global max there) for
    cotangents ``dU`` (Ng, H*D), ``dV`` (Ng, H) — the whole-batch backward
    with m ← m, den ← 1, g ← dU, s ← −dV on the shard's edges, its rows
    placed at t0·tn. Returns (d_wn (N, 2H), d_nf (N, H*D), d_w_ea (Es, H))."""
    r0, Ng = _grid_rows(meta, rank)
    N, HD = nf.shape
    H = wn.shape[1] // 2

    def whole(rows, width):
        full = rows.new_zeros((N, width))
        full[r0:r0 + Ng] = rows
        return full

    ones = torch.ones((N, H), dtype=torch.float32, device=nf.device)
    return tcsr_gat_bwd_plain(wn, nf, w_ea, src, dst, emask, None,
                              whole(m, H), ones, whole(dU, HD),
                              whole(-dV, H), False, slope)


def tcsr_gat_ep_bwd(wn, nf, w_ea, src, dst, emask, meta: EPTileMeta,
                    rank: int, m, dU, dV, slope: float = 0.2):
    """K3 backward wrapper: (d_wn (N, 2H), d_nf (N, H*D), d_w_ea (Es, H))
    f32, the gradient of shard ``rank``'s U, V for the cotangents ``dU``
    (Ng, H*D) and ``dV`` (Ng, H) given the global max ``m`` (Ng, H) at its
    grid rows. Masked edges get exactly 0; the kernel writes every output
    element."""
    if nf.device.type == "cpu":
        return tcsr_gat_ep_bwd_plain(wn, nf, w_ea, src, dst, emask, meta,
                                     rank, m, dU, dV, slope)
    f32 = torch.float32
    Ng, H, HD = meta.n_tiles_grid * meta.tn, wn.shape[1] // 2, nf.shape[1]
    (N, HD, H, Ng), (t0, ew, cw, sw) = _check_ep(
        "tcsr_gat_ep_bwd", wn, nf, w_ea, src, dst, emask, meta, rank,
        extra=(("m", m, f32, (Ng, H)), ("dU", dU, f32, (Ng, HD)),
               ("dV", dV, f32, (Ng, H))))
    _check_bwd("tcsr_gat_ep_bwd", nf, dU, H, meta.tn)
    dev = nf.device
    Es = src.shape[0]
    ones = torch.ones((Ng, H), dtype=f32, device=dev)
    neg_dv = -dV
    d_wn = torch.empty((N, 2 * H), dtype=f32, device=dev)
    d_nf = torch.empty((N, HD), dtype=f32, device=dev)
    d_w_ea = torch.empty((Es, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_EP_BWD.launch(P(wn), P(nf), P(w_ea), P(src), P(dst), P(emask),
                         P(t0), P(ew), P(cw), P(sw), P(m), P(ones), P(dU),
                         P(neg_dv), P(d_wn), P(d_nf), P(d_w_ea),
                         meta.n_tiles_grid, N, Es, meta.tn, meta.te,
                         meta.k_src, H, HD // H, ctypes.c_float(slope),
                         _cuda.stream_ptr(dev))
    return d_wn, d_nf, d_w_ea


class TcsrGatEpFn(torch.autograd.Function):
    """The shard's un-normalised softmax sums (pallas_gat.py:local_unnorm,
    l.690-746): (wn, nf, w_ea) → (U_l (Ng, H*D), V_l (Ng, H)) given the
    global max ``m`` (Ng, H) at the grid rows and K3's forward stats, which
    carry no gradient. The forward is an elementwise rescale of the stats;
    the backward is K3's backward kernel."""

    @staticmethod
    def forward(ctx, wn, nf, w_ea, src, dst, emask, meta, rank, m, stats,
                slope):
        out_l, m_l, den_l = stats
        scale = torch.where(m_l > _NEG / 2, torch.exp(m_l - m),
                            torch.zeros_like(m_l))
        V = den_l * scale
        Ng, H = V.shape
        U = (out_l.view(Ng, H, -1) * V[..., None]).reshape(Ng, -1)
        ctx.save_for_backward(wn, nf, w_ea, src, dst, emask, m)
        ctx.meta, ctx.rank, ctx.slope = meta, rank, slope
        return U, V

    @staticmethod
    def backward(ctx, dU, dV):
        wn, nf, w_ea, src, dst, emask, m = ctx.saved_tensors
        d_wn, d_nf, d_w_ea = tcsr_gat_ep_bwd(
            wn, nf, w_ea, src, dst, emask, ctx.meta, ctx.rank, m,
            dU.float().contiguous(), dV.float().contiguous(), ctx.slope)
        return (d_wn, d_nf, d_w_ea) + (None,) * 8


def tcsr_gat_pass_ep(
    node_feats_h: torch.Tensor,   # (N, H, D) — replicated node state
    edge_attr: torch.Tensor,      # (Es, Da) — THIS shard's edge attrs
    src: torch.Tensor,            # (Es,) int32, absolute node ids
    dst: torch.Tensor,            # (Es,) int32
    edge_mask: torch.Tensor,      # (Es,)
    attn_vec: torch.Tensor,       # (H, 2D + Da)
    meta: EPTileMeta,             # every shard's rows
    rank: int,
    group=None,                   # the process group (None: the default)
    self_loops: bool = False,
    negative_slope: float = 0.2,
    return_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Edge-partitioned GAT pass (pallas_gat.py:pallas_gat_pass_ep): every
    rank of ``group`` calls it with its own edge shard; returns the
    replicated (out (N,H,D), attn_by_src (N,H) or None), the same as
    tcsr_gat_pass over all the shards' edges.

    K3's forward gives the shard's softmax stats on its grid rows; the
    global max is the scatter-max of every shard's (an all-gather, no
    gradient); ``TcsrGatEpFn`` rescales the stats into the shard's
    un-normalised sums U_l, V_l, which one differentiable all-gather
    (dist/collectives.py:all_gather_rows — its backward all-reduces the
    cotangent and keeps the rank's block) brings to every rank for one
    index-add; the analytic self-loop term is added once there. Gradient
    convention: every rank computes the same loss, and the caller averages
    every parameter gradient over the ranks (dist/data_parallel.py:
    average_gradients)."""

    N, H, D = node_feats_h.shape
    HD = H * D
    S = meta.ew_blk.shape[0]
    Ng = meta.n_tiles_grid * meta.tn
    wn, w_ea = prologue(node_feats_h, edge_attr, attn_vec)
    wn, w_ea = wn.contiguous(), w_ea.contiguous()
    nf = node_feats_h.float().reshape(N, HD).contiguous()
    emask = edge_mask.float().contiguous()

    # 1. the shard's softmax stats (values only)
    with torch.no_grad():
        stats = tcsr_gat_ep_fwd(wn.detach(), nf.detach(), w_ea.detach(), src,
                                dst, emask, meta, rank, negative_slope)

    # 2. global max: scatter-max of every shard's grid rows (no gradient)
    rows = (meta.t0.long().reshape(S, 1) * meta.tn
            + torch.arange(Ng, device=nf.device)).reshape(-1)
    with torch.no_grad():
        m_all = all_gather(stats[1], group).reshape(S * Ng, H)
        if self_loops:
            M = F.leaky_relu(wn[:, :H] + wn[:, H:], negative_slope)
        else:
            M = torch.full((N, H), _NEG, dtype=torch.float32,
                           device=nf.device)
        M = M.scatter_reduce(0, rows[:, None].expand(-1, H), m_all, "amax")
        Mg = torch.where(M <= _NEG / 2, torch.zeros_like(M), M)
    own = rows[rank * Ng:(rank + 1) * Ng]

    # 3. the shard's un-normalised sums, gathered with their gradient
    U_l, V_l = TcsrGatEpFn.apply(wn, nf, w_ea, src, dst, emask, meta, rank,
                                 Mg[own].contiguous(), stats, negative_slope)
    UV = all_gather_rows(torch.cat([U_l, V_l], dim=1), rank, group)
    UV = UV.reshape(S * Ng, HD + H)
    NUM = nf.new_zeros((N, HD)).index_add(0, rows, UV[:, :HD])
    DEN = nf.new_zeros((N, H)).index_add(0, rows, UV[:, HD:])
    if self_loops:
        es = torch.exp(F.leaky_relu(wn[:, :H] + wn[:, H:], negative_slope)
                       - Mg)
        DEN = DEN + es
        NUM = NUM + (es[..., None] * nf.view(N, H, D)).reshape(N, HD)
    DENg = torch.where(DEN == 0.0, torch.ones_like(DEN), DEN)
    out = (NUM.view(N, H, D) / DENg[..., None]).to(node_feats_h.dtype)
    if not return_attention:
        return out, None
    # attention epilogue (pallas_gat.py:855-869): each shard's edges by
    # source, summed over the ranks; the self-loop term added once
    with torch.no_grad():
        attn = attention_by_source(wn, w_ea, src, dst, emask, Mg, DEN,
                                   self_loops and rank == 0, negative_slope)
        attn = all_reduce(attn, group)
    return out, attn
