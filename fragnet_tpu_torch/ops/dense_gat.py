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

Parts: ``build_dense_planes`` (host, numpy), the forward kernel wrapper
``dense_gat_fwd`` (csrc/dense_gat_fwd.cu, which replaces dense_gat.py:
_fwd_kernel), its plain version ``dense_gat_fwd_plain``, and the
summed-attention-by-source epilogue (dense_gat.py:848-864).
Math contract: ops/segment.py:gat_attention_pass.
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

_KERNEL_H = (1, 2, 4, 8)
_KERNEL_TN = (32, 64, 128, 256)
_SMEM_LIMIT = 232448


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


def dense_gat_fwd(planes, wd, ws, nf, vc, slope: float = 0.2):
    """Forward kernel wrapper: (out (N, H*D), m (N, H), den (N, H)) f32.

    ``planes`` (n_tiles, (R+1)*tn, tn) f32, ``wd``/``ws`` (N, H) f32, ``nf``
    (N, H*D) f32, ``vc`` (R+1, H) f32 — rows v[0..R-1], then c."""
    if nf.device.type == "cpu":
        return dense_gat_fwd_plain(planes, wd, ws, nf, vc, slope)
    if nf.device.type != "cuda":
        raise ValueError(f"no dense_gat_fwd kernel for device {nf.device}")
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    if H not in _KERNEL_H or tn not in _KERNEL_TN or HD % H or N != T * tn \
            or rows % tn or R < 0:
        raise ValueError(f"dense_gat_fwd: unsupported shapes planes="
                         f"{tuple(planes.shape)} N={N} H={H} HD={HD} "
                         f"(H in {_KERNEL_H}, tn in {_KERNEL_TN})")
    dev = nf.device
    f32 = torch.float32
    for name, t, shape in (("planes", planes, (T, rows, tn)),
                           ("wd", wd, (N, H)), ("ws", ws, (N, H)),
                           ("nf", nf, (N, HD)), ("vc", vc, (R + 1, H))):
        _cuda.check(t, name, f32, shape, dev)
    smem = 4 * (tn * HD + tn * H + (R + 1) * H)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"dense_gat_fwd: tile of {tn} x {HD} needs {smem} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty((N, HD), dtype=f32, device=dev)
    m = torch.empty((N, H), dtype=f32, device=dev)
    den = torch.empty((N, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL.launch(P(planes), P(wd), P(ws), P(nf), P(vc), P(out), P(m),
                  P(den), T, tn, H, HD // H, R, ctypes.c_float(slope),
                  _cuda.stream_ptr(dev))
    return out, m, den


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

    Returns (out (N,H,D), attn_by_src (N,H) or None); the attention vector
    (gat2.py:165-167 summed-by-source probabilities) is rebuilt from
    (m, den) exactly as in tcsr_gat_pass, only when ``return_attention``."""
    N, H, D = node_feats_h.shape
    Da = edge_attr.shape[-1]
    nf32 = node_feats_h.float()
    a32 = attn_vec.float()
    a_dst, a_ea, a_src = a32[:, :D], a32[:, D:D + Da], a32[:, D + Da:]
    wd = torch.einsum("nhd,hd->nh", nf32, a_dst)
    ws = torch.einsum("nhd,hd->nh", nf32, a_src)
    vc = torch.cat([v.float(), c.float().reshape(1, H)], dim=0)
    out, m, den = dense_gat_fwd(planes, wd.contiguous(), ws.contiguous(),
                                nf32.reshape(N, H * D).contiguous(),
                                vc.contiguous(), negative_slope)
    out = out.reshape(N, H, D).to(node_feats_h.dtype)
    if not return_attention:
        return out, None
    src_l, dst_l = src.long(), dst.long()
    w_ea = edge_attr.float() @ a_ea.T
    den_s = torch.where(den == 0.0, torch.ones_like(den), den)
    z = F.leaky_relu(wd[dst_l] + ws[src_l] + w_ea, negative_slope)
    expo = torch.where(edge_mask.float()[:, None] > 0, z - m[dst_l],
                       torch.full_like(z, float("-inf")))
    p = torch.exp(expo) / den_s[dst_l]
    attn = torch.zeros((N, H), dtype=torch.float32, device=wd.device)
    return out, attn.index_add(0, src_l, p)
