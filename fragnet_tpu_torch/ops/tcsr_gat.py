"""Fused TCSR GAT pass — counterpart of fragnet_tpu/ops/pallas_gat.py.

One GAT pass (math contract: ops/segment.py:gat_attention_pass) over the
TCSR layout of ops/tcsr.py, in three parts:

  * ``prologue`` — the per-node and per-edge logit terms (pallas_gat.py:
    471-479): w_dst = nf·a_dst, w_src = nf·a_src per head, w_ea = ea·a_ea;
  * ``tcsr_gat_fwd`` — the forward kernel (csrc/tcsr_gat_fwd.cu, which
    replaces pallas_gat.py:_fwd_kernel): segment-softmax aggregation per
    destination tile, self-loops folded in analytically; emits out, m, den.
    ``tcsr_gat_fwd_plain`` is the same function in plain PyTorch;
  * the summed-attention-by-source epilogue (pallas_gat.py:598-622),
    rebuilt from (m, den) with torch ops, only when asked for.

A CUDA tensor goes through the kernel or the call raises; only CPU tensors
take the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fragnet_tpu_torch.ops import _cuda
from fragnet_tpu_torch.ops.tcsr import TileMeta

_NEG = -1e30
_VP = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _cuda.CudaKernel(
    "tcsr_gat_fwd.cu", "tcsr_gat_fwd",
    [_VP] * 11 + [_I] * 6 + [ctypes.c_float, _VP])

# shared memory a block may use (H100: 227 KB); the kernel's block size and
# widest row (csrc/tcsr_gat_fwd.cu kThreads, 32 * kMaxCols)
_SMEM_LIMIT = 232448
_THREADS = 512
_MAX_HD = 256


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


def tcsr_gat_fwd(wn, nf, w_ea, src, dst, emask, meta: TileMeta,
                 self_loops: bool, slope: float = 0.2):
    """Forward kernel wrapper: (out (N, H*D), m (N, H), den (N, H)) f32.

    ``wn`` (N, 2H) f32, ``nf`` (N, H*D) f32, ``w_ea`` (E, H) f32, ``src`` /
    ``dst`` (E,) int32, ``emask`` (E,) f32; ``meta`` holds ``ew_blk`` and
    ``cw`` (n_tiles,) int32 tensors on the same device."""
    if nf.device.type == "cpu":
        return tcsr_gat_fwd_plain(wn, nf, w_ea, src, dst, emask, meta,
                                  self_loops, slope)
    if nf.device.type != "cuda":
        raise ValueError(f"no tcsr_gat_fwd kernel for device {nf.device}")
    N, HD = nf.shape
    H = wn.shape[1] // 2
    E = src.shape[0]
    tn, te = meta.tn, meta.te
    if H <= 0 or HD % H or N % tn or E % te:
        raise ValueError(f"tcsr_gat_fwd: bad shapes N={N} HD={HD} H={H} "
                         f"E={E} tn={tn} te={te}")
    n_tiles = N // tn
    dev = nf.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("wn", wn, f32, (N, 2 * H)), ("nf", nf, f32, (N, HD)),
            ("w_ea", w_ea, f32, (E, H)), ("src", src, i32, (E,)),
            ("dst", dst, i32, (E,)), ("emask", emask, f32, (E,)),
            ("ew_blk", meta.ew_blk, i32, (n_tiles,)),
            ("cw", meta.cw, i32, (n_tiles,))):
        _cuda.check(t, name, dt, shape, dev)
    smem = 4 * (tn * HD + 2 * tn * H + _THREADS * (H + 2))
    if HD > _MAX_HD or smem > _SMEM_LIMIT:
        raise ValueError(f"tcsr_gat_fwd: tile of {tn} x {HD} needs {smem} B "
                         f"of shared memory (limit {_SMEM_LIMIT}) and "
                         f"H*D <= {_MAX_HD}")
    out = torch.empty((N, HD), dtype=f32, device=dev)
    m = torch.empty((N, H), dtype=f32, device=dev)
    den = torch.empty((N, H), dtype=f32, device=dev)
    P = _cuda.ptr
    KERNEL.launch(P(wn), P(nf), P(w_ea), P(src), P(dst), P(emask),
                  P(meta.ew_blk), P(meta.cw), P(out), P(m), P(den),
                  n_tiles, tn, te, H, HD // H, int(bool(self_loops)),
                  ctypes.c_float(slope), _cuda.stream_ptr(dev))
    return out, m, den


def attention_by_source(wn, w_ea, src, dst, emask, m, den, self_loops: bool,
                        slope: float = 0.2) -> torch.Tensor:
    """Summed final probabilities by SOURCE (gat2.py:165-167), rebuilt from
    the kernel's softmax state (pallas_gat.py:598-622)."""
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

    Returns ``(out (N,H,D), attn_by_src (N,H) or None)``; the attention
    vector is computed only when ``return_attention``."""
    N, H, D = node_feats_h.shape
    wn, w_ea = prologue(node_feats_h, edge_attr, attn_vec)
    emask = edge_mask.float().contiguous()
    out, m, den = tcsr_gat_fwd(
        wn.contiguous(), node_feats_h.float().reshape(N, H * D).contiguous(),
        w_ea.contiguous(), src, dst, emask, meta, self_loops, negative_slope)
    out = out.reshape(N, H, D).to(node_feats_h.dtype)
    if not return_attention:
        return out, None
    return out, attention_by_source(wn, w_ea, src, dst, emask, m, den,
                                    self_loops, negative_slope)
