"""Dense per-tile GAT pass — counterpart of fragnet_tpu/ops/dense_gat.py,
the zero-gather kernel for rank-structured edge attributes (bond + fconn
levels).

With tile-aligned packing (graphs/hiergraph.py ``PadSpec.align``) every edge
of a tile has both endpoints inside that tile, and the edge-attr logit term
of the bond level (1-dim cos-angle) and the fconn level (6-dim connection
one-hot sum) is a rank-R function of the raw attrs: w_ea = raw·v + c. So the
pass is dense masked attention per (tn, tn) tile over host-built planes:

    z[i,j,h] = leaky(wd[i,h] + ws[j,h] + Σ_r EA_r[i,j]·v[r,h] + c[h])
    out[i]   = Σ_j softmax_j(z masked by adj)[i,j,h] · nf[j,h,:]

Parts: ``build_dense_planes`` (host, numpy), the device plane builder
``build_dense_planes_device`` (csrc/dense_planes.cu, which replaces
dense_gat.py:_plane_builder_kernel) and its plain version
``build_dense_planes_device_plain``, the forward kernel wrapper
``dense_gat_fwd`` (csrc/dense_gat_fwd.cu, which replaces dense_gat.py:
_fwd_kernel) and its plain version ``dense_gat_fwd_plain``, the backward
kernel wrapper ``dense_gat_bwd`` (csrc/dense_gat_bwd.cu, which replaces
dense_gat.py:_bwd_kernel) and ``dense_gat_bwd_plain``, ``DenseGatFn`` joining
the two as the autograd boundary (dense_gat.py:op_bwd), and the
summed-attention-by-source epilogue (dense_gat.py:848-864) on detached
tensors.

The dense-attr section serves the levels whose edge-attr logit term is
dynamic (atom and frag, and fconn under the policy ``fc="attr"``): the
forward kernel wrapper ``dense_attr_fwd`` (csrc/dense_attr_fwd.cu, which
replaces dense_gat.py:_attr_fwd_kernel) with ``dense_attr_fwd_plain``, the
backward kernel wrapper ``dense_attr_bwd`` (csrc/dense_attr_bwd.cu, which
replaces dense_gat.py:_attr_bwd_kernel) with ``dense_attr_bwd_plain``, the
emit kernel wrapper ``dense_attr_emit`` (csrc/dense_attr_emit.cu, which
replaces dense_gat.py:_attr_emit_kernel) with ``dense_attr_emit_plain``,
``DenseAttrGatFn`` joining them as the autograd boundary
(dense_gat.py:584-628), and ``dense_attr_gat_pass`` with its epilogue
(dense_gat.py:632-686). Math contract: ops/segment.py:gat_attention_pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fragnet_tpu_torch.ops import _cuda

_NEG = -1e30
_VP = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _cuda.CudaKernel(
    "dense_gat_fwd.cu", "dense_gat_fwd",
    [_VP] * 8 + [_I] * 5 + [ctypes.c_float, _VP])
KERNEL_BWD = _cuda.CudaKernel(
    "dense_gat_bwd.cu", "dense_gat_bwd",
    [_VP] * 13 + [_I] * 5 + [ctypes.c_float, _VP])
KERNEL_PLANES = _cuda.CudaKernel(
    "dense_planes.cu", "dense_planes", [_VP] * 7 + [_I] * 5 + [_VP])
_LL = ctypes.c_longlong
KERNEL_ATTR = _cuda.CudaKernel(
    "dense_attr_fwd.cu", "dense_attr_fwd",
    [_VP] * 13 + [_LL] + [_I] * 7 + [ctypes.c_float, _VP])
KERNEL_ATTR_BWD = _cuda.CudaKernel(
    "dense_attr_bwd.cu", "dense_attr_bwd",
    [_VP] * 19 + [_LL] + [_I] * 7 + [ctypes.c_float, _VP])
KERNEL_ATTR_EMIT = _cuda.CudaKernel(
    "dense_attr_emit.cu", "dense_attr_emit", [_VP] * 7 + [_I] * 5 + [_VP])

_KERNEL_H = (1, 2, 4, 8)
_KERNEL_TN = (32, 64, 128, 256)


# --------------------------------------------------------------------------
# host-side plane builder
# --------------------------------------------------------------------------

def build_dense_planes(
    src: np.ndarray,
    dst: np.ndarray,
    edge_mask: np.ndarray,
    edge_attr: np.ndarray,   # (E, R) raw edge attrs
    n_nodes: int,
    tn: int = 128,
) -> Optional[np.ndarray]:
    """(n_tiles, (R+1)*tn, tn) f32: per dst tile, rows [0,tn) = adjacency
    (1.0 where edge), rows [(r+1)tn,(r+2)tn) = raw attr plane r. Returns
    None when any real edge crosses a tile boundary (batch not aligned —
    caller falls back to the TCSR path) or a (dst,src) slot is duplicated."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = np.asarray(edge_mask) > 0
    ea = np.asarray(edge_attr, np.float32)
    R = ea.shape[1]
    if n_nodes % tn:
        return None
    n_tiles = n_nodes // tn
    s, d, a = src[keep], dst[keep], ea[keep]
    if (s // tn != d // tn).any():
        return None
    t = d // tn
    di, sj = d % tn, s % tn
    flat = t * tn * tn + di * tn + sj
    if len(np.unique(flat)) != len(flat):
        return None  # duplicate (dst, src) pair — dense slot would collide
    planes = np.zeros((n_tiles, (R + 1) * tn, tn), np.float32)
    planes[t, di, sj] = 1.0
    for r in range(R):
        planes[t, (r + 1) * tn + di, sj] = a[:, r]
    return planes


# --------------------------------------------------------------------------
# device-side plane builder and its plain version
# --------------------------------------------------------------------------

_PLANES_R = (0, 1, 6)


def _plane_edges(src, dst, edge_mask, n_nodes: int, meta):
    """(edge ids, their tile, dst mod tn, src mod tn) of the edges that the
    plane builder adds: inside their destination tile's TCSR edge window
    (``ew_blk[t]`` .. ``ew_blk[t] + cw[t] - 1`` te-blocks), ``edge_mask > 0``,
    both endpoints in that tile."""
    tn, te = meta.tn, meta.te
    T = n_nodes // tn
    s, d = src.long(), dst.long()
    t = d // tn
    tc = t.clamp(0, max(T - 1, 0))
    lo = meta.ew_blk.long()[tc] * te
    hi = lo + meta.cw.long()[tc] * te
    eids = torch.arange(src.shape[0], device=src.device)
    keep = ((edge_mask > 0) & (t < T) & (s // tn == t) & (eids >= lo)
            & (eids < hi))
    k = keep.nonzero().squeeze(1)
    return k, t[k], d[k] % tn, s[k] % tn


def build_dense_planes_device_plain(src, dst, edge_mask, edge_attr,
                                    n_nodes: int, meta):
    """Plain PyTorch version of the plane builder: a zeros tensor, then one
    accumulating ``index_put_`` of (1, ea[e, 0..R-1]) for every kept edge
    of each tile's window. Same output as ``build_dense_planes_device``."""
    tn = meta.tn
    T = n_nodes // tn
    R = 0 if edge_attr is None else int(edge_attr.shape[1])
    k, t, di, sj = _plane_edges(src, dst, edge_mask, n_nodes, meta)
    vals = torch.ones((k.shape[0], R + 1), dtype=torch.float32,
                      device=src.device)
    if R:
        vals[:, 1:] = edge_attr[k].float()
    planes = torch.zeros((T, R + 1, tn, tn), dtype=torch.float32,
                         device=src.device)
    r = torch.arange(R + 1, device=src.device)[None, :]
    planes.index_put_((t[:, None], r, di[:, None], sj[:, None]), vals,
                      accumulate=True)
    return planes.reshape(T, (R + 1) * tn, tn)


def build_dense_planes_device(src, dst, edge_mask, edge_attr, n_nodes: int,
                              meta):
    """The dense planes of one level, built on the batch's device from its
    per-edge arrays over the level's ``TileMeta`` edge windows (the JAX
    package's build_dense_planes_device, dense_gat.py:168): (n_tiles,
    (R+1)*tn, tn) f32, the layout of ``build_dense_planes``, for R in
    {0, 1, 6}. ``src``/``dst`` (E,) int32, ``edge_mask`` (E,) f32,
    ``edge_attr`` (E, R) f32 or None (R = 0). On a CUDA tensor this launches
    csrc/dense_planes.cu (which replaces dense_gat.py:_plane_builder_kernel);
    on a CPU tensor it runs the plain version. Exact for batches that
    packing.dp_level_ok admits (tile-local, no repeated (dst, src) slot)."""
    if src.device.type == "cpu":
        return build_dense_planes_device_plain(src, dst, edge_mask,
                                               edge_attr, n_nodes, meta)
    if src.device.type != "cuda":
        raise ValueError(f"no dense_planes kernel for device {src.device}")
    tn, te = meta.tn, meta.te
    R = 0 if edge_attr is None else int(edge_attr.shape[1])
    E = int(src.shape[0])
    if R not in _PLANES_R or tn not in _KERNEL_TN or n_nodes % tn:
        raise ValueError(f"dense_planes: unsupported R={R} tn={tn} "
                         f"n_nodes={n_nodes} (R in {_PLANES_R}, tn in "
                         f"{_KERNEL_TN}, n_nodes a multiple of tn)")
    T = n_nodes // tn
    dev = src.device
    i32, f32 = torch.int32, torch.float32
    for arg, t, dt, shape in (("src", src, i32, (E,)), ("dst", dst, i32, (E,)),
                              ("edge_mask", edge_mask, f32, (E,)),
                              ("ew_blk", meta.ew_blk, i32, (T,)),
                              ("cw", meta.cw, i32, (T,))):
        _cuda.check(t, arg, dt, shape, dev)
    if R:
        _cuda.check(edge_attr, "edge_attr", f32, (E, R), dev)
    out = torch.empty((T, (R + 1) * tn, tn), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_PLANES.launch(P(src), P(dst), P(edge_mask),
                         P(edge_attr) if R else ctypes.c_void_p(0),
                         P(meta.ew_blk), P(meta.cw), P(out), T, tn, R, E, te,
                         _cuda.stream_ptr(dev))
    return out


# --------------------------------------------------------------------------
# forward kernel and its plain version
# --------------------------------------------------------------------------

def dense_gat_fwd_plain(planes, wd, ws, nf, vc, slope: float = 0.2):
    """Plain PyTorch version of the forward kernel: same inputs, same
    (out (N, H*D), m (N, H), den (N, H))."""
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    D = nf.shape[1] // H
    pl = planes.view(T, R + 1, tn, tn)
    adj = pl[:, 0]                                          # (T, i, j)
    zpre = wd.view(T, tn, 1, H) + ws.view(T, 1, tn, H)      # (T, i, j, H)
    for r in range(R):
        zpre = zpre + pl[:, r + 1, :, :, None] * vc[r]
    zpre = zpre + vc[R]
    z = torch.where(adj[..., None] > 0, F.leaky_relu(zpre, slope),
                    torch.full_like(zpre, _NEG))
    m = z.amax(dim=2)                                       # (T, i, H)
    p = torch.exp(z - m[:, :, None, :]) * adj[..., None]
    den = p.sum(dim=2)
    deng = torch.where(den == 0.0, torch.ones_like(den), den)
    out = torch.einsum("tijh,tjhd->tihd", p, nf.view(T, tn, H, D))
    out = out / deng[..., None]
    return out.reshape(N, H * D), m.reshape(N, H), den.reshape(N, H)


def _check_cuda(name, planes, wd, ws, nf, vc, extra=()):
    """Raise unless the kernels take these tensors; returns (T, tn, R, N,
    H, HD). ``extra`` adds (name, tensor, shape) f32 arrays."""
    if nf.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {nf.device}")
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    if H not in _KERNEL_H or tn not in _KERNEL_TN or HD % H or N != T * tn \
            or rows % tn or R < 0 or R + 1 > 32:
        raise ValueError(f"{name}: unsupported shapes planes="
                         f"{tuple(planes.shape)} N={N} H={H} HD={HD} "
                         f"(H in {_KERNEL_H}, tn in {_KERNEL_TN}, R < 32)")
    for arg, t, shape in (("planes", planes, (T, rows, tn)),
                          ("wd", wd, (N, H)), ("ws", ws, (N, H)),
                          ("nf", nf, (N, HD)), ("vc", vc, (R + 1, H))
                          ) + tuple(extra):
        _cuda.check(t, arg, torch.float32, shape, nf.device)
    return T, tn, R, N, H, HD


def dense_gat_fwd(planes, wd, ws, nf, vc, slope: float = 0.2):
    """Forward kernel wrapper: (out (N, H*D), m (N, H), den (N, H)) f32.

    ``planes`` (n_tiles, (R+1)*tn, tn) f32, ``wd``/``ws`` (N, H) f32, ``nf``
    (N, H*D) f32, ``vc`` (R+1, H) f32 — rows v[0..R-1], then c."""
    if nf.device.type == "cpu":
        return dense_gat_fwd_plain(planes, wd, ws, nf, vc, slope)
    T, tn, R, N, H, HD = _check_cuda("dense_gat_fwd", planes, wd, ws, nf, vc)
    # lanes read the adjacency rows and nf in float4, a lane's four columns
    # in one head
    D = HD // H
    if D % 4 or HD > 256:
        raise ValueError(f"dense_gat_fwd: H={H} D={D} unsupported (D a "
                         f"multiple of 4, H*D <= 256)")
    _cuda.check_aligned(planes, "planes", 16)
    _cuda.check_aligned(nf, "nf", 16)
    dev = nf.device
    f32 = torch.float32
    out = torch.empty((N, HD), dtype=f32, device=dev)
    m = torch.empty((N, H), dtype=f32, device=dev)
    den = torch.empty((N, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL.launch(P(planes), P(wd), P(ws), P(nf), P(vc), P(out), P(m),
                  P(den), T, tn, H, HD // H, R, ctypes.c_float(slope),
                  _cuda.stream_ptr(dev))
    return out, m, den


def dense_gat_bwd_plain(planes, wd, ws, nf, vc, m, den, g, s,
                        slope: float = 0.2):
    """Plain PyTorch version of the backward kernel, written out from the
    formulas (not autograd of the plain forward, so the two check each
    other): (d_wd (N, H), d_ws (N, H), d_nf (N, H*D) — the Pᵀg aggregation
    only — and d_vc (R+1, H)) for the cotangent ``g`` (N, H*D) of out, with
    ``s`` (N, H) = Σ_d g·out."""
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    D = nf.shape[1] // H
    pl = planes.view(T, R + 1, tn, tn)
    keep = pl[:, 0, :, :, None] > 0                          # (T, i, j, 1)
    zpre = wd.view(T, tn, 1, H) + ws.view(T, 1, tn, H)      # (T, i, j, H)
    for r in range(R):
        zpre = zpre + pl[:, r + 1, :, :, None] * vc[r]
    zpre = zpre + vc[R]
    deng = torch.where(den == 0.0, torch.ones_like(den), den).view(T, tn, 1, H)
    expo = torch.where(keep, F.leaky_relu(zpre, slope) - m.view(T, tn, 1, H),
                       torch.full_like(zpre, float("-inf")))
    p = torch.exp(expo) / deng
    g4 = g.view(T, tn, H, D)
    d_p = torch.einsum("tihd,tjhd->tijh", g4, nf.view(T, tn, H, D))
    fac = torch.where(zpre > 0, torch.ones_like(zpre),
                      torch.full_like(zpre, slope))
    dz = p * (d_p - s.view(T, tn, 1, H)) * fac
    d_nf = torch.einsum("tijh,tihd->tjhd", p, g4).reshape(N, H * D)
    d_vc = torch.stack([(dz * pl[:, r + 1, :, :, None]).sum((0, 1, 2))
                        for r in range(R)] + [dz.sum((0, 1, 2))])
    return (dz.sum(2).reshape(N, H), dz.sum(1).reshape(N, H), d_nf, d_vc)


def dense_gat_bwd(planes, wd, ws, nf, vc, m, den, g, s, slope: float = 0.2):
    """Backward kernel wrapper: (d_wd (N, H), d_ws (N, H), d_nf (N, H*D),
    d_vc (R+1, H)) f32, from the forward's inputs, its (m, den), the
    cotangent ``g`` (N, H*D) of out and ``s`` (N, H) = Σ_d g·out. The
    kernel writes per-tile partials of d_vc; they are summed here."""
    if nf.device.type == "cpu":
        return dense_gat_bwd_plain(planes, wd, ws, nf, vc, m, den, g, s,
                                   slope)
    N, H = wd.shape
    T, tn, R, N, H, HD = _check_cuda(
        "dense_gat_bwd", planes, wd, ws, nf, vc,
        extra=(("m", m, (N, H)), ("den", den, (N, H)),
               ("g", g, tuple(nf.shape)), ("s", s, (N, H))))
    # lanes read nf and g in float4, a head's D/4 lanes summed by shuffles
    D = HD // H
    if D % 4 or D // 4 not in (1, 2, 4, 8, 16, 32) or HD > 256:
        raise ValueError(f"dense_gat_bwd: H={H} D={D} unsupported (D in "
                         f"4, 8, ..., 128; H*D <= 256)")
    _cuda.check_aligned(nf, "nf", 16)
    _cuda.check_aligned(g, "g", 16)
    dev = nf.device
    f32 = torch.float32
    d_wd = torch.empty((N, H), dtype=f32, device=dev)
    d_ws = torch.empty((N, H), dtype=f32, device=dev)
    d_nf = torch.empty((N, HD), dtype=f32, device=dev)
    d_vc = torch.empty((T, R + 1, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_BWD.launch(P(planes), P(wd), P(ws), P(nf), P(vc), P(m), P(den),
                      P(g), P(s), P(d_wd), P(d_ws), P(d_nf), P(d_vc), T, tn,
                      H, HD // H, R, ctypes.c_float(slope),
                      _cuda.stream_ptr(dev))
    return d_wd, d_ws, d_nf, d_vc.sum(0)


def head_dot(g: torch.Tensor, out: torch.Tensor, H: int) -> torch.Tensor:
    """s (N, H) = Σ_d g·out per node and head, summed in the order the
    backward kernel sums its per-head dots g[i]·nf[j] (csrc/dense_gat_bwd.cu
    dot4, head_sum): rounded products, pairwise within each four columns,
    then halves across a head's D/4 groups. A row whose output equals a
    neighbour's features then gets d_zpre = 0 exactly, as the math says,
    and not round-off. Where the kernel does not run (D/4 not a power of
    two), a plain sum."""
    N = g.shape[0]
    D = g.shape[1] // H
    w = D // 4
    if D % 4 or w & (w - 1):
        return (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    p = g.view(N, H, w, 4) * out.view(N, H, w, 4)
    t = (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
    while t.shape[-1] > 1:
        half = t.shape[-1] // 2
        t = t[..., :half] + t[..., half:]
    return t[..., 0]


class DenseGatFn(torch.autograd.Function):
    """(wd, ws, nf, vc) → (out, m, den) through the forward kernel over
    ``planes``, with the backward kernel as its gradient (dense_gat.py:
    775-809). ``m`` and ``den`` carry no gradient; ``planes`` gets none."""

    @staticmethod
    def forward(ctx, planes, wd, ws, nf, vc, slope):
        out, m, den = dense_gat_fwd(planes, wd, ws, nf, vc, slope)
        ctx.save_for_backward(planes, wd, ws, nf, vc, out, m, den)
        ctx.slope = slope
        ctx.mark_non_differentiable(m, den)
        return out, m, den

    @staticmethod
    def backward(ctx, g_out, _g_m, _g_den):
        planes, wd, ws, nf, vc, out, m, den = ctx.saved_tensors
        g = g_out.float().contiguous()
        s = head_dot(g, out, wd.shape[1])
        d_wd, d_ws, d_nf, d_vc = dense_gat_bwd(planes, wd, ws, nf, vc, m, den,
                                               g, s, ctx.slope)
        return None, d_wd, d_ws, d_nf, d_vc, None


def dense_gat_pass(
    node_feats_h: torch.Tensor,   # (N, H, D)
    planes: torch.Tensor,         # (n_tiles, (R+1)*tn, tn) f32
    v: torch.Tensor,              # (R, H) folded edge-attr projection
    c: torch.Tensor,              # (H,) folded bias term
    edge_attr: torch.Tensor,      # (E, Da) embedded attrs — epilogue only
    src: torch.Tensor,            # (E,) int32 — epilogue only
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    attn_vec: torch.Tensor,       # (H, 2D + Da) — [dst | ea | src] layout
    negative_slope: float = 0.2,
    return_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dense-tile GAT pass (math contract: ops/segment.py:gat_attention_pass
    with self_loops=False). ``v``/``c`` must satisfy
    ``edge_attr_embedded[e] @ a_ea^T == raw_ea[e] @ v + c`` — the caller
    folds the embed Linear and the a_ea slice of the attention vector
    (model/layers.py:_fold_planes).

    Differentiable w.r.t. the node features, ``v``, ``c`` and the attention
    vector through ``DenseGatFn``.

    Returns (out (N,H,D), attn_by_src (N,H) or None); the attention vector
    (gat2.py:165-167 summed-by-source probabilities) is rebuilt from
    (m, den) exactly as in tcsr_gat_pass, only when ``return_attention``,
    and carries no gradient."""
    N, H, D = node_feats_h.shape
    Da = edge_attr.shape[-1]
    nf32 = node_feats_h.float()
    a32 = attn_vec.float()
    a_dst, a_ea, a_src = a32[:, :D], a32[:, D:D + Da], a32[:, D + Da:]
    wd = torch.einsum("nhd,hd->nh", nf32, a_dst)
    ws = torch.einsum("nhd,hd->nh", nf32, a_src)
    vc = torch.cat([v.float(), c.float().reshape(1, H)], dim=0)
    out, m, den = DenseGatFn.apply(planes, wd.contiguous(), ws.contiguous(),
                                   nf32.reshape(N, H * D).contiguous(),
                                   vc.contiguous(), negative_slope)
    out = out.reshape(N, H, D).to(node_feats_h.dtype)
    if not return_attention:
        return out, None
    # interpretability epilogue: detached inputs (the JAX stop_gradient)
    wd, ws = wd.detach(), ws.detach()
    src_l, dst_l = src.long(), dst.long()
    w_ea = edge_attr.detach().float() @ a_ea.detach().T
    den_s = torch.where(den == 0.0, torch.ones_like(den), den)
    z = F.leaky_relu(wd[dst_l] + ws[src_l] + w_ea, negative_slope)
    expo = torch.where(edge_mask.float()[:, None] > 0, z - m[dst_l],
                       torch.full_like(z, float("-inf")))
    p = torch.exp(expo) / den_s[dst_l]
    attn = torch.zeros((N, H), dtype=torch.float32, device=wd.device)
    return out, attn.index_add(0, src_l, p)


# --------------------------------------------------------------------------
# dynamic-edge-attr variant (atom / frag levels, and fconn under fc="attr")
# --------------------------------------------------------------------------
#
# The atom and frag passes carry dynamic per-edge logit terms (w_ea = new
# bond features · a_ea, gat2.py:186-204, 283-316), so no plane of them can be
# built ahead. The kernels take the level's adjacency plane and its per-edge
# arrays and find each edge of a tile over the level's TCSR edge windows;
# self-loops (the atom pass, gat2.py:179-185) are folded in analytically.

def _attr_w(w_ea, src, dst, emask, meta, T: int):
    """(T, tn, tn, H) W planes: w_ea[e] at the local (dst, src) slot of every
    edge that the kernels count (``_plane_edges``), 0 elsewhere."""
    tn = meta.tn
    k, t, di, sj = _plane_edges(src, dst, emask, T * tn, meta)
    W = torch.zeros((T, tn, tn, w_ea.shape[1]), dtype=torch.float32,
                    device=w_ea.device)
    return W.index_put_((t, di, sj), w_ea[k].float(), accumulate=True)


def _attr_logits(adj, wd, ws, w_ea, src, dst, emask, meta, slope):
    """(zpre (T, i, j, H), z masked to −1e30 off the adjacency, adj as
    (T, i, j, 1), zs_pre (T, i, H) = wd + ws) for the plain versions."""
    T, tn, _ = adj.shape
    H = wd.shape[1]
    zpre = (wd.view(T, tn, 1, H) + ws.view(T, 1, tn, H)
            + _attr_w(w_ea, src, dst, emask, meta, T))
    a4 = adj.unsqueeze(-1)
    z = torch.where(a4 > 0, F.leaky_relu(zpre, slope),
                    torch.full_like(zpre, _NEG))
    return zpre, z, a4, (wd + ws).view(T, tn, H)


def dense_attr_fwd_plain(adj, wd, ws, nf, w_ea, src, dst, emask, meta,
                         self_loops: bool, slope: float = 0.2):
    """Plain PyTorch version of the dense-attr forward kernel: same inputs,
    same (out (N, H*D), m (N, H), den (N, H))."""
    T, tn, _ = adj.shape
    N, H = wd.shape
    D = nf.shape[1] // H
    zpre, z, a4, zs_pre = _attr_logits(adj, wd, ws, w_ea, src, dst, emask,
                                       meta, slope)
    m = z.amax(dim=2)                                       # (T, i, H)
    if self_loops:
        zs = F.leaky_relu(zs_pre, slope)
        m = torch.maximum(m, zs)
    p = torch.exp(z - m[:, :, None, :]) * a4
    den = p.sum(dim=2)
    nf4 = nf.view(T, tn, H, D)
    out = torch.einsum("tijh,tjhd->tihd", p, nf4)
    if self_loops:
        ps = torch.exp(zs - m)
        den = den + ps
        out = out + ps[..., None] * nf4
    deng = torch.where(den == 0.0, torch.ones_like(den), den)
    out = out / deng[..., None]
    return out.reshape(N, H * D), m.reshape(N, H), den.reshape(N, H)


def dense_attr_bwd_plain(adj, wd, ws, nf, w_ea, src, dst, emask, meta, m,
                         den, g, s, self_loops: bool, slope: float = 0.2):
    """Plain PyTorch version of the dense-attr backward kernel, written out
    from the formulas (not autograd of the plain forward, so the two check
    each other): (d_wd (N, H) row sums of d_zpre, d_ws (N, H) column sums,
    d_wself (N, H) the self-loop logit gradient — 0 without self-loops —,
    d_nf (N, H*D) = Pᵀg + ps·g, and the d_zpre planes (T, H*tn, tn), 0 off
    the adjacency) for the cotangent ``g`` (N, H*D) of out, with ``s``
    (N, H) = Σ_d g·out."""
    T, tn, _ = adj.shape
    N, H = wd.shape
    D = nf.shape[1] // H
    zpre, z, a4, zs_pre = _attr_logits(adj, wd, ws, w_ea, src, dst, emask,
                                       meta, slope)
    m3, s3 = m.view(T, tn, H), s.view(T, tn, H)
    deng = torch.where(den == 0.0, torch.ones_like(den), den).view(T, tn, H)
    expo = torch.where(a4 > 0, z - m3[:, :, None, :],
                       torch.full_like(z, float("-inf")))
    p = torch.exp(expo) * a4 / deng[:, :, None, :]
    g4, nf4 = g.view(T, tn, H, D), nf.view(T, tn, H, D)
    d_p = torch.einsum("tihd,tjhd->tijh", g4, nf4)
    fac = torch.where(zpre > 0, torch.ones_like(zpre),
                      torch.full_like(zpre, slope))
    dz = p * (d_p - s3[:, :, None, :]) * fac * a4
    d_nf = torch.einsum("tijh,tihd->tjhd", p, g4)
    if self_loops:
        ps = torch.exp(F.leaky_relu(zs_pre, slope) - m3) / deng
        d_ps = (g4 * nf4).sum(-1)
        fac_s = torch.where(zs_pre > 0, torch.ones_like(zs_pre),
                            torch.full_like(zs_pre, slope))
        d_wself = ps * (d_ps - s3) * fac_s
        d_nf = d_nf + ps[..., None] * g4
    else:
        d_wself = torch.zeros_like(m3)
    planes = dz.permute(0, 3, 1, 2).reshape(T, H * tn, tn)
    return (dz.sum(2).reshape(N, H), dz.sum(1).reshape(N, H),
            d_wself.reshape(N, H), d_nf.reshape(N, H * D), planes)


def dense_attr_emit_plain(dz, src, dst, emask, meta):
    """Plain PyTorch version of the emit kernel: (E, H) f32, d_wea[e, h] =
    dz[t, h*tn + dst mod tn, src mod tn] · emask[e] for every edge that the
    kernels count, 0 for every other edge."""
    T, Htn, tn = dz.shape
    H = Htn // tn
    k, t, di, sj = _plane_edges(src, dst, emask, T * tn, meta)
    out = torch.zeros((src.shape[0], H), dtype=torch.float32,
                      device=dz.device)
    out[k] = dz.view(T, H, tn, tn)[t, :, di, sj] * emask[k, None]
    return out


def _check_attr(name, adj, wd, nf, src, meta, extra=(), g=None):
    """Raise unless the dense-attr kernels take these tensors; returns
    (T, tn, N, H, HD, E). ``adj`` may be the first tn rows of each tile of
    a taller planes tensor (its tile stride, a multiple of 4, is passed to
    the kernel); ``extra`` adds (name, tensor, dtype, shape). Lanes read
    the adjacency rows and nf (and the backward's cotangent ``g``) in
    float4, a lane's four columns in one head: D a multiple of 4, H*D <=
    256, each 16-byte aligned; the backward also sums a head's D/4 lanes
    by shuffles (D/4 a power of two)."""
    dev = nf.device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    T, tn, tn2 = adj.shape
    N, H = wd.shape
    HD = nf.shape[1]
    E = src.shape[0]
    if H not in _KERNEL_H or tn not in _KERNEL_TN or tn2 != tn or HD % H \
            or N != T * tn or tn != meta.tn:
        raise ValueError(f"{name}: unsupported shapes adj={tuple(adj.shape)} "
                         f"N={N} H={H} HD={HD} meta.tn={meta.tn} (H in "
                         f"{_KERNEL_H}, tn in {_KERNEL_TN}, N = n_tiles * tn)")
    D = HD // H
    bwd = g is not None
    if D % 4 or HD > 256 or (bwd and D // 4 not in (1, 2, 4, 8, 16, 32)):
        raise ValueError(f"{name}: H={H} D={D} unsupported (D a multiple of "
                         f"4{', D/4 a power of two' if bwd else ''}, H*D <= "
                         f"256)")
    _cuda.check(adj, "adj", torch.float32, (T, tn, tn), dev,
                inner_contiguous=True)
    if adj.stride(0) % 4:
        raise ValueError(f"{name}: adj has strides {adj.stride()}: the tile "
                         f"stride must be a multiple of 4")
    i32, f32 = torch.int32, torch.float32
    for arg, t, dt, shape in (("wd", wd, f32, (N, H)),
                              ("nf", nf, f32, (N, HD)),
                              ("src", src, i32, (E,)),
                              ("ew_blk", meta.ew_blk, i32, (T,)),
                              ("cw", meta.cw, i32, (T,))) + tuple(extra) \
            + ((("g", g, f32, (N, HD)),) if bwd else ()):
        _cuda.check(t, arg, dt, shape, dev)
    for arg, t in (("adj", adj), ("nf", nf)) + ((("g", g),) if bwd else ()):
        _cuda.check_aligned(t, arg, 16)
    return T, tn, N, H, HD, E


def _edge_extra(E, H, w_ea, dst, emask):
    f32 = torch.float32
    return (("w_ea", w_ea, f32, (E, H)), ("dst", dst, torch.int32, (E,)),
            ("emask", emask, f32, (E,)))


def dense_attr_fwd(adj, wd, ws, nf, w_ea, src, dst, emask, meta,
                   self_loops: bool, slope: float = 0.2):
    """Dense-attr forward kernel wrapper (csrc/dense_attr_fwd.cu, which
    replaces dense_gat.py:_attr_fwd_kernel): (out (N, H*D), m (N, H), den
    (N, H)) f32.

    ``adj`` (n_tiles, tn, tn) f32 adjacency planes, contiguous within each
    tile (the fconn level passes ``dp_fc[:, :tn, :]`` as it is); ``wd`` /
    ``ws`` (N, H), ``nf`` (N, H*D), ``w_ea`` (E, H) f32; ``src`` / ``dst``
    (E,) int32, ``emask`` (E,) f32; ``meta`` holds ``ew_blk`` and ``cw``
    (n_tiles,) int32 tensors on the same device. At most one counted edge
    per (dst, src) slot (packing.dp_level_ok)."""
    if nf.device.type == "cpu":
        return dense_attr_fwd_plain(adj, wd, ws, nf, w_ea, src, dst, emask,
                                    meta, self_loops, slope)
    N, H = wd.shape
    T, tn, N, H, HD, E = _check_attr(
        "dense_attr_fwd", adj, wd, nf, src, meta,
        extra=(("ws", ws, torch.float32, (N, H)),)
        + _edge_extra(src.shape[0], H, w_ea, dst, emask))
    dev = nf.device
    f32 = torch.float32
    out = torch.empty((N, HD), dtype=f32, device=dev)
    m = torch.empty((N, H), dtype=f32, device=dev)
    den = torch.empty((N, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_ATTR.launch(P(adj), P(wd), P(ws), P(nf), P(w_ea), P(src), P(dst),
                       P(emask), P(meta.ew_blk), P(meta.cw), P(out), P(m),
                       P(den), adj.stride(0), T, tn, H, HD // H, E, meta.te,
                       int(bool(self_loops)), ctypes.c_float(slope),
                       _cuda.stream_ptr(dev))
    return out, m, den


def dense_attr_bwd(adj, wd, ws, nf, w_ea, src, dst, emask, meta, m, den, g,
                   s, self_loops: bool, slope: float = 0.2):
    """Dense-attr backward kernel wrapper (csrc/dense_attr_bwd.cu, which
    replaces dense_gat.py:_attr_bwd_kernel): (d_wd, d_ws, d_wself (N, H),
    d_nf (N, H*D), d_zpre planes (n_tiles, H*tn, tn)) f32, from the
    forward's inputs, its (m, den), the cotangent ``g`` (N, H*D) of out and
    ``s`` (N, H) = Σ_d g·out. The kernel writes every element it returns,
    every slot of the planes included (0 off the adjacency), so all five
    start empty."""
    if nf.device.type == "cpu":
        return dense_attr_bwd_plain(adj, wd, ws, nf, w_ea, src, dst, emask,
                                    meta, m, den, g, s, self_loops, slope)
    N, H = wd.shape
    HD = nf.shape[1]
    f32 = torch.float32
    T, tn, N, H, HD, E = _check_attr(
        "dense_attr_bwd", adj, wd, nf, src, meta,
        extra=(("ws", ws, f32, (N, H)), ("m", m, f32, (N, H)),
               ("den", den, f32, (N, H)), ("s", s, f32, (N, H)))
        + _edge_extra(src.shape[0], H, w_ea, dst, emask), g=g)
    dev = nf.device
    d_wd = torch.empty((N, H), dtype=f32, device=dev)
    d_ws = torch.empty((N, H), dtype=f32, device=dev)
    d_wself = torch.empty((N, H), dtype=f32, device=dev)
    d_nf = torch.empty((N, HD), dtype=f32, device=dev)
    dz = torch.empty((T, H * tn, tn), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_ATTR_BWD.launch(
        P(adj), P(wd), P(ws), P(nf), P(w_ea), P(src), P(dst), P(emask),
        P(meta.ew_blk), P(meta.cw), P(m), P(den), P(g), P(s), P(d_wd),
        P(d_ws), P(d_wself), P(d_nf), P(dz), adj.stride(0), T, tn, H, HD // H,
        E, meta.te, int(bool(self_loops)), ctypes.c_float(slope),
        _cuda.stream_ptr(dev))
    return d_wd, d_ws, d_wself, d_nf, dz


def dense_attr_emit(dz, src, dst, emask, meta):
    """Emit kernel wrapper (csrc/dense_attr_emit.cu, which replaces
    dense_gat.py:_attr_emit_kernel and op_bwd's flat_slot gather): the
    per-edge logit gradient d_wea (E, H) f32 from the d_zpre planes ``dz``
    (n_tiles, H*tn, tn) — dz at each counted edge's slot times its mask, 0
    for every other edge."""
    if dz.device.type == "cpu":
        return dense_attr_emit_plain(dz, src, dst, emask, meta)
    dev = dz.device
    if dev.type != "cuda":
        raise ValueError(f"no dense_attr_emit kernel for device {dev}")
    T, Htn, tn = dz.shape
    H = Htn // tn
    E = src.shape[0]
    if tn != meta.tn or Htn % tn:
        raise ValueError(f"dense_attr_emit: planes {tuple(dz.shape)} do not "
                         f"match meta.tn={meta.tn}")
    i32, f32 = torch.int32, torch.float32
    for arg, t, dt, shape in (("dz", dz, f32, (T, Htn, tn)),
                              ("src", src, i32, (E,)),
                              ("dst", dst, i32, (E,)),
                              ("emask", emask, f32, (E,)),
                              ("ew_blk", meta.ew_blk, i32, (T,)),
                              ("cw", meta.cw, i32, (T,))):
        _cuda.check(t, arg, dt, shape, dev)
    d_wea = torch.empty((E, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL_ATTR_EMIT.launch(P(dz), P(src), P(dst), P(emask), P(meta.ew_blk),
                            P(meta.cw), P(d_wea), T, tn, H, E, meta.te,
                            _cuda.stream_ptr(dev))
    return d_wea


class DenseAttrGatFn(torch.autograd.Function):
    """(wd, ws, nf, w_ea) → (out, m, den) through the dense-attr forward
    kernel, with the backward kernel and the emit kernel as its gradient
    (dense_gat.py:584-628). The self-loop terms join d_wd and d_ws here, as
    op_bwd adds them; ``m`` and ``den`` carry no gradient; the adjacency,
    the edge arrays and the metadata get none."""

    @staticmethod
    def forward(ctx, adj, wd, ws, nf, w_ea, src, dst, emask, meta,
                self_loops, slope):
        out, m, den = dense_attr_fwd(adj, wd, ws, nf, w_ea, src, dst, emask,
                                     meta, self_loops, slope)
        ctx.save_for_backward(adj, wd, ws, nf, w_ea, src, dst, emask, out, m,
                              den)
        ctx.meta, ctx.self_loops, ctx.slope = meta, self_loops, slope
        ctx.mark_non_differentiable(m, den)
        return out, m, den

    @staticmethod
    def backward(ctx, g_out, _g_m, _g_den):
        adj, wd, ws, nf, w_ea, src, dst, emask, out, m, den = ctx.saved_tensors
        N, H = wd.shape
        g = g_out.float().contiguous()
        s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
        d_wd, d_ws, d_wself, d_nf, dz = dense_attr_bwd(
            adj, wd, ws, nf, w_ea, src, dst, emask, ctx.meta, m, den, g, s,
            ctx.self_loops, ctx.slope)
        d_wea = dense_attr_emit(dz, src, dst, emask, ctx.meta)
        if ctx.self_loops:
            d_wd, d_ws = d_wd + d_wself, d_ws + d_wself
        return (None, d_wd, d_ws, d_nf, d_wea, None, None, None, None, None,
                None)


def dense_attr_gat_pass(
    node_feats_h: torch.Tensor,   # (N, H, D)
    edge_attr: torch.Tensor,      # (E, Da) dynamic per-edge attrs
    src: torch.Tensor,            # (E,) int32
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    attn_vec: torch.Tensor,       # (H, 2D + Da) — [dst | ea | src]
    adj_planes: torch.Tensor,     # (N//tn, tn, tn) f32 adjacency
    meta,                         # ops.tcsr.TileMeta (edge windows reused)
    self_loops: bool = False,
    negative_slope: float = 0.2,
    return_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dense-tile GAT pass for dynamic edge attrs (the JAX package's
    dense_attr_gat_pass, dense_gat.py:632; atom / frag levels, gat2.py:
    178-224 / 283-316, and fconn under ``fc="attr"``). The per-edge logit
    term w_ea = ea · a_eaᵀ and wd / ws = nf · a_dst / a_src are plain torch,
    so autograd carries the kernels' d_wea, d_wd and d_ws on to ea, nf and
    the attention vector. Self-loops (zero edge attrs, gat2.py:179-185) are
    folded in analytically for every node. ``adj_planes`` may be a view with
    a larger tile stride (the first tn rows of the fconn planes).

    Returns (out (N,H,D), attn_by_src (N,H) or None); the attention vector
    (gat2.py:165-167 summed-by-source probabilities, dense_gat.py:668-686)
    is rebuilt from (m, den) on detached tensors only when
    ``return_attention``."""
    from fragnet_tpu_torch.ops.tcsr_gat import attention_by_source

    N, H, D = node_feats_h.shape
    Da = edge_attr.shape[-1]
    nf32 = node_feats_h.float()
    a32 = attn_vec.float()
    a_dst, a_ea, a_src = a32[:, :D], a32[:, D:D + Da], a32[:, D + Da:]
    wd = torch.einsum("nhd,hd->nh", nf32, a_dst)
    ws = torch.einsum("nhd,hd->nh", nf32, a_src)
    w_ea = edge_attr.float() @ a_ea.T                        # (E, H)
    emask = edge_mask.float().contiguous()
    out, m, den = DenseAttrGatFn.apply(
        adj_planes, wd.contiguous(), ws.contiguous(),
        nf32.reshape(N, H * D).contiguous(), w_ea.contiguous(), src, dst,
        emask, meta, bool(self_loops), negative_slope)
    out = out.reshape(N, H, D).to(node_feats_h.dtype)
    if not return_attention:
        return out, None
    wn = torch.cat([wd.detach(), ws.detach()], dim=-1)
    return out, attention_by_source(wn, w_ea.detach(), src, dst, emask, m,
                                    den, self_loops, negative_slope)
