"""FragNetLayer — the four-level attention layer as an ``nn.Module``
(counterpart of fragnet_tpu/model/layers.py).

Re-designs fragnet/model/gat/gat2.py:40-330 (FragNetLayerA.forward): five
passes (bond-graph GAT → atom-graph GAT with self-loops → atom→frag pooling
→ fconn-graph GAT → frag-graph GAT) over static-shape padded tensors. Every
GAT pass goes through ``_gat_dispatch``: the dense planes kernel
(ops/dense_gat.py), the dense-attr kernel (same module), or the fused TCSR
kernel (ops/tcsr_gat.py) as the kernel policy and the batch's metadata
select, else the ELL pass (ops/ell.py, torch ops on any device, as the JAX
package runs it in XLA) when FragNetLayer's batch carries neighbour tables
(``spec_for(..., ell=True)``), else — on the CPU only — the segment path
(ops/segment.py). A
layer built with an ``EPContext`` runs edge-partitioned (dist/
edge_partition.py): each rank passes its shard of every level's edges to
the K3 pass (ops/tcsr_gat.py:tcsr_gat_pass_ep) when the batch carries
EPTileMeta, else to the segment EP pass (ops/segment.py:
gat_attention_pass with ``ep``, torch ops on any device, as the JAX
package runs it in XLA), node state replicated. The attention vectors are
computed only when asked for. ``LayerHooks`` (the
interpretability masks, interp/) zero rows of the bond, atom and fconn
passes' outputs, whichever kernel ran the pass. The bond, atom and
fragment passes are methods of ``_BondAtomPasses``, which FragNetLayer and
the gat2_lite and gat2_edge layers (model/variants.py) build on.

``dtype`` is the compute type of FragNetLayer (the JAX package's
``FragNetLayer.dtype``, model/layers.py:228-264): f32, or bf16 to halve the
node-feature bytes the kernels read. Parameters stay f32 (Adam updates
them, as optax does); every Linear runs as flax's ``Dense(dtype=dt)`` —
input, weight and bias cast to dt (``_linear_dt``) — the layer's inputs
and masks are cast to dt, the logits, softmax and the kernels' sums stay
f32 (ops/), and ``_fold_planes`` applies the embed in dt and folds in f32.

Parameter names are the reference torch names (gat2.py): projection_b/a/fb,
edge_attr_bond_embed, edge_attr_fbond_embed and the attention vectors
a_b/a/f/f_a_b. The reference also constructs modules that never affect the
forward (atom_embed, frag_embed, ... gat2.py:64-85); this layer does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.dist.edge_partition import shard_rows
from fragnet_tpu_torch.ops.dense_gat import (dense_attr_gat_pass,
                                             dense_gat_pass)
from fragnet_tpu_torch.ops.ell import ell_gat_pass
from fragnet_tpu_torch.ops.segment import gat_attention_pass, segment_sum
from fragnet_tpu_torch.ops.tcsr import EPTileMeta, TileMeta
from fragnet_tpu_torch.ops.tcsr_gat import tcsr_gat_pass, tcsr_gat_pass_ep


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Per-level dense-kernel strategy (the JAX package's KernelPolicy):

    * ``bond``: "planes" (host-precomputed value-plane kernel) or "tcsr".
      "attr" is REFUSED: the dense-attr kernel hung the TPU at bond-level
      shapes (BASELINE.md r4 experiment log — "parked, never enable").
    * ``fc``: "planes" | "attr" | "tcsr".
    * ``attr``: atom/frag levels use the dense-attr kernel instead of TCSR.

    A level whose batch carries no planes for the selected dense kernel
    goes to the TCSR kernel, as in the JAX package."""

    bond: str = "planes"
    fc: str = "planes"
    attr: bool = False

    def __post_init__(self):
        if self.bond == "attr":
            raise ValueError(
                "kernel.bond='attr' is refused: the dense-attr kernel HUNG "
                "the device at bond-level shapes (see BASELINE.md, r4 "
                "on-device experiments: 'parked — never enable'). Use "
                "'planes' or 'tcsr'.")
        if self.bond not in ("planes", "tcsr"):
            raise ValueError(f"kernel.bond={self.bond!r} (planes|tcsr)")
        if self.fc not in ("planes", "attr", "tcsr"):
            raise ValueError(f"kernel.fc={self.fc!r} (planes|attr|tcsr)")


def torch_linear_init_(w: torch.Tensor, fan_in: int,
                       generator: Optional[torch.Generator]) -> None:
    """torch nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = math.sqrt(3.0 * (1.0 / 3.0) / fan_in)
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def xavier_gain_(w: torch.Tensor, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator],
                 gain: float = 1.414) -> None:
    """xavier_uniform with gain 1.414 (reference gat2.py:111-115), as the
    JAX package's variance_scaling(2·1.414², fan_avg, uniform); ``gain``
    1 is its ``xavier_uniform`` (variance_scaling(2, fan_avg, uniform))."""
    bound = math.sqrt(3.0 * 2.0 * gain ** 2 / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def _linear(d_in: int, d_out: int, init: str,
            generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    if init == "xavier":
        xavier_gain_(lin.weight, d_in, d_out, generator)
    else:
        torch_linear_init_(lin.weight, d_in, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


def _attn_param(H: int, width: int,
                generator: Optional[torch.Generator]) -> nn.Parameter:
    p = nn.Parameter(torch.empty(H, width))
    xavier_gain_(p, H, width, generator)
    return p


def _gat_dispatch(
    nf: torch.Tensor,            # (N, H, Dp) projected node features
    ea: torch.Tensor,            # (E, Da) per-edge attrs (embedded/dynamic)
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    avec: torch.Tensor,          # (H, 2*Dp + Da) attention vector
    *,
    num_nodes: int,
    tm: Optional[TileMeta],
    dp: Optional[torch.Tensor],  # dense planes
    mode: str,                   # "planes" | "attr" | "tcsr"
    fold=None,                   # (v, c) folded edge-attr term (planes mode)
    self_loops: bool = False,
    seg=None,                    # (src, dst, attr, mask) for the ELL and
                                 # segment paths (the atom level appends
                                 # explicit self-loop rows there)
    need_attn: bool = False,
    ep=None,                     # EPContext: edge-partitioned pass
    nbr=None,                    # (nbr_edge, nbr_mask) ELL tables or None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One GAT pass through whichever kernel the batch metadata + policy
    select (the JAX package's ladder, fragnet_tpu/model/layers.py:171-190):
    under ``ep`` the K3 pass on this rank's edge shard when ``tm`` is
    EPTileMeta, else the segment EP pass (``seg`` or this rank's edges;
    its collectives combine the shards); else
    the dense planes kernel, the dense-attr kernel over the adjacency plane
    (``dp`` itself at R = 0, else its first tn rows of each tile), else the
    fused TCSR kernel, else the ELL pass over ``nbr`` (any device), else —
    for CPU tensors only — the segment path. A CUDA tensor with none of
    these raises. Math contract for
    every branch: ops/segment.py:gat_attention_pass (reference
    gat2.py:137-169)."""
    if ep is not None:
        if isinstance(tm, EPTileMeta):
            return tcsr_gat_pass_ep(nf, ea, src, dst, mask, avec, tm,
                                    ep.rank, ep.group, self_loops=self_loops,
                                    return_attention=need_attn)
        return _segment_pass(nf, avec, num_nodes, seg or (src, dst, ea, mask),
                             need_attn, ep)
    if mode == "planes" and dp is not None and fold is not None:
        v, c = fold
        return dense_gat_pass(nf, dp, v, c, ea, src, dst, mask, avec,
                              return_attention=need_attn)
    if mode == "attr" and dp is not None and isinstance(tm, TileMeta):
        tn = dp.shape[2]
        adj = dp if dp.shape[1] == tn else dp[:, :tn, :]
        return dense_attr_gat_pass(nf, ea, src, dst, mask, avec, adj, tm,
                                   self_loops=self_loops,
                                   return_attention=need_attn)
    if isinstance(tm, TileMeta):
        return tcsr_gat_pass(nf, ea, src, dst, mask, avec, tm,
                             self_loops=self_loops,
                             return_attention=need_attn)
    if nbr is not None:
        xsrc, _xdst, xattr, _xmask = seg or (src, dst, ea, mask)
        return ell_gat_pass(nf, xattr, xsrc, nbr[0], nbr[1], avec,
                            want_attn_by_src=need_attn,
                            num_src_nodes=num_nodes)
    if nf.device.type != "cpu":
        raise RuntimeError(
            f"GAT pass on {nf.device} without TCSR tile metadata, dense "
            f"planes or ELL tables: the segment path runs on the CPU only; "
            f"build the batch with a TCSR spec (spec_for(..., tcsr=True)) "
            f"or ELL tables (spec_for(..., ell=True))")
    return _segment_pass(nf, avec, num_nodes, seg or (src, dst, ea, mask),
                         need_attn)


def _segment_pass(nf, avec, num_nodes: int, seg, need_attn: bool, ep=None):
    """The segment path over ``seg`` = (src, dst, attr, mask), the attrs
    broadcast over the heads; edge-partitioned under ``ep``."""
    xsrc, xdst, xattr, xmask = seg
    H = nf.shape[1]
    attr_h = xattr[:, None, :].expand(xattr.shape[0], H, xattr.shape[1])
    return gat_attention_pass(nf, attr_h, xsrc, xdst, avec, num_nodes,
                              edge_mask=xmask, ep=ep, need_attn=need_attn)


def _self_loop_rows(src, dst, ea, mask, n: int, on: bool = True):
    """(src, dst, attr, mask) with a self-loop row per node appended after
    the edges (gat2.py:179-185): zero attributes, mask 1 — or 0 where
    ``on`` is false (an edge-partitioned rank other than 0: the loops count
    once over the ranks)."""
    sl = torch.arange(n, dtype=src.dtype, device=src.device)
    return (torch.cat([src, sl]), torch.cat([dst, sl]),
            torch.cat([ea, ea.new_zeros((n, ea.shape[1]))]),
            torch.cat([mask, mask.new_full((n,), 1.0 if on else 0.0)]))


def _linear_dt(lin: nn.Linear, x: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """``lin`` applied as flax's ``Dense(dtype=dt)``: input, weight and bias
    cast to ``dt``, the result in ``dt``; autograd carries the gradients
    back to the f32 parameters. In f32 the module itself."""
    if dt == lin.weight.dtype:
        return lin(x.to(dt))
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


def _fold_planes(emb: nn.Linear, raw_dim: int, avec: torch.Tensor,
                 dp0: int, dt: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an edge-attr embed Linear + the a_ea slice of the attention
    vector into the (v (R, H), c (H,)) rank terms the planes kernel consumes
    — basis-applied through the SAME module in the compute type ``dt``,
    then folded in f32, as the JAX package does (layers.py:201-213)."""
    H = avec.shape[0]
    dev = avec.device
    bias_row = _linear_dt(emb, torch.zeros((1, raw_dim), dtype=dt,
                                           device=dev), dt)
    Wt = _linear_dt(emb, torch.eye(raw_dim, dtype=dt, device=dev),
                    dt) - bias_row  # (R, Dp)
    a_ea = avec[:, dp0:2 * dp0].float()
    v = Wt.float() @ a_ea.T
    c = (bias_row.float() @ a_ea.T).reshape(H)
    return v, c


def _zero_rows(x: torch.Tensor, *idx) -> torch.Tensor:
    """Zero the rows of x named by each of ``idx`` (an int or an integer
    tensor of row indices; None adds nothing). A row outside [0, N) — −1,
    the disabled mark — is a no-op, as the JAX package's one-hot is (torch
    would wrap a negative index to the end). Sync-free: out-of-range rows
    land in a spare row that is dropped."""
    parts = [torch.as_tensor(i, device=x.device).reshape(-1).long()
             for i in idx if i is not None]
    if not parts:
        return x
    N = x.shape[0]
    rows = torch.cat(parts)
    rows = torch.where((rows >= 0) & (rows < N), rows, N)
    keep = x.new_ones((N + 1,)).index_fill_(0, rows, 0.0)[:N]
    return x * keep[:, None]


def _pair_rows(first) -> Optional[torch.Tensor]:
    """Rows (i, i+1) for the entry i of ``first``; i < 0 gives none (the
    JAX package's bond_mask = −1 zeroes row 0, see LayerHooks)."""
    if first is None:
        return None
    first = torch.as_tensor(first).reshape(-1).long()
    first = torch.where(first < 0, -2, first)  # both rows out of range
    return torch.cat([first, first + 1])


@dataclasses.dataclass(frozen=True)
class LayerHooks:
    """Interpretability masks (the JAX package's LayerHooks), applied to a
    pass's outputs before the next pass takes them as edge attributes and
    before the edge masks multiply. The reference's fields, each an int or
    a 0-d integer tensor (−1 = disabled):

    * bond_mask:      zero bond-feature rows i, i+1 (gat2.py:171-177)
    * frag_bond_mask: zero fconn rows 2k, 2k+1      (gat2.py:274-278)
    * atom_mask:      zero atom row i               (gat2.py:227-232)
    * atom_zero_vec:  (A,) float mask; 1 zeroes that atom's hidden state —
      the multi-atom form of fragment attribution
      (vizualize/model_attr.py:115-133 zeroes whole-fragment atom sets)

    and the explicit form the replica batches of interp/attribution.py
    use, one masked entity per replica: ``bond_rows``, ``fconn_rows``,
    ``atom_rows``, integer tensors of the rows to zero, as they are.

    bond_mask = −1 is a no-op here; the JAX package zeroes bond row 0 for
    it (its pair is [−1, 0])."""

    bond_mask: Optional[object] = None
    frag_bond_mask: Optional[object] = None
    atom_mask: Optional[object] = None
    atom_zero_vec: Optional[torch.Tensor] = None
    bond_rows: Optional[torch.Tensor] = None
    fconn_rows: Optional[torch.Tensor] = None
    atom_rows: Optional[torch.Tensor] = None

    def bond_pair(self) -> Optional[torch.Tensor]:
        return _pair_rows(self.bond_mask)

    def fconn_pair(self) -> Optional[torch.Tensor]:
        if self.frag_bond_mask is None:
            return None
        k = torch.as_tensor(self.frag_bond_mask).long()
        return _pair_rows(torch.where(k < 0, -1, 2 * k))


@dataclasses.dataclass
class LayerAttn:
    atoms: torch.Tensor   # (A, H) summed attention by source
    frags: torch.Tensor   # (F, H)
    bonds: torch.Tensor   # (E, H)
    fbonds: torch.Tensor  # (C, H)


class _BondAtomPasses(nn.Module):
    """The bond-graph and atom-graph GAT passes of FragNetLayer (passes 1
    and 2, gat2.py:137-224) with their parameters — edge_attr_bond_embed,
    projection_b, a_b, projection_a, a — and the fragment-level pass
    (pass 5) as a method over a given attention vector. FragNetLayer and
    the gat2_lite / gat2_edge layers (model/variants.py) build on it.

    ``takes_ell``: whether the passes take a batch's ELL tables
    (FragNetLayer's, whose JAX counterpart reaches the ELL branch of its
    dispatch; the JAX package's variants run their passes on the segment
    path, so theirs do not)."""

    def __init__(self, atom_in: int, atom_out: int, edge_in: int,
                 edge_out: int, bond_edge_in: int, num_heads: int,
                 policy: KernelPolicy, generator: Optional[torch.Generator],
                 ep=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = num_heads
        self.num_heads = H
        self.dtype = dtype
        self.atom_out = atom_out
        self.edge_out = edge_out
        self.policy = policy
        self.ep = ep
        eph = edge_out // H
        aph = atom_out // H
        g = generator
        self.edge_attr_bond_embed = _linear(bond_edge_in, eph, "torch", g)
        self.projection_b = _linear(edge_in, eph * H, "xavier", g)
        self.a_b = _attn_param(H, 3 * eph, g)
        self.projection_a = _linear(atom_in, aph * H, "torch", g)
        self.a = _attn_param(H, 2 * aph + edge_out, g)

    takes_ell = False

    def _nbr(self, batch, level: str):
        """``level``'s (nbr_edge, nbr_mask) for the ELL branch, or None."""
        edge = getattr(batch, f"{level}_nbr_edge")
        if not self.takes_ell or edge is None:
            return None
        return edge, getattr(batch, f"{level}_nbr_mask")

    @obs.spanned("fragnet.gat.bond")
    def bond_pass(self, nf_bonds, batch, need_attn: bool = False,
                  hooks: Optional[LayerHooks] = None):
        """Pass 1, the bond-graph GAT (gat2.py:137-169): (new bond
        features (E, edge_out), masked, the hooks' rows zeroed; attention
        by source or None)."""
        hooks = hooks or LayerHooks()
        H, pol, ep, dt = self.num_heads, self.policy, self.ep, self.dtype
        edge_out_ph = self.edge_out // H
        E = nf_bonds.shape[0]
        ea_b = _linear_dt(self.edge_attr_bond_embed, batch.ea_bonds,
                          dt)                                    # (EB, Dp)
        nf_b = _linear_dt(self.projection_b, nf_bonds, dt).reshape(
            E, H, edge_out_ph)
        fold_b = None
        if ep is None and pol.bond == "planes" and batch.dp_bond is not None:
            # raw bond-graph edge attr is the 1-dim cos-angle → rank-1 fold
            fold_b = _fold_planes(self.edge_attr_bond_embed,
                                  batch.ea_bonds.shape[1], self.a_b,
                                  edge_out_ph, dt)
        bond_out, attn_bonds = _gat_dispatch(
            nf_b, ea_b, batch.bg_src, batch.bg_dst, batch.bg_mask, self.a_b,
            num_nodes=E, tm=batch.tm_bond, dp=batch.dp_bond, mode=pol.bond,
            fold=fold_b, need_attn=need_attn, ep=ep,
            nbr=self._nbr(batch, "bg"))
        new_bond_features = _zero_rows(bond_out.reshape(E, -1),
                                       hooks.bond_pair(), hooks.bond_rows)
        return new_bond_features * batch.edge_mask.to(dt)[:, None], attn_bonds

    @obs.spanned("fragnet.gat.atom")
    def atom_pass(self, x_atoms, new_bond_features, batch,
                  need_attn: bool = False,
                  hooks: Optional[LayerHooks] = None):
        """Pass 2, the atom-graph GAT with self-loops (gat2.py:178-224),
        the bond features as edge attributes: (new atom features (A,
        atom_out), masked, the hooks' rows zeroed; attention by source or
        None)."""
        hooks = hooks or LayerHooks()
        H, pol, ep = self.num_heads, self.policy, self.ep
        edge_mask = batch.edge_mask
        A = x_atoms.shape[0]
        # self-loops appended after real edges, zero edge attrs
        # (gat2.py:179-185); the kernel folds them in analytically, so the
        # appended arrays are built only for the ELL and segment paths (the
        # atom table's ids E + i name the appended rows)
        seg = None
        ea_a, mask_a = new_bond_features, edge_mask
        if ep is not None:
            # this rank's slice of the replicated bond features (and their
            # mask, in the compute type); K3 folds the self-loops in its
            # combine, the segment pass takes them as rows on rank 0 only
            Es = batch.edge_src.shape[0]
            ea_a = shard_rows(new_bond_features, ep, Es)
            mask_a = shard_rows(edge_mask.to(self.dtype), ep, Es)
            if not isinstance(batch.tm_atom, EPTileMeta):
                seg = _self_loop_rows(batch.edge_src, batch.edge_dst, ea_a,
                                      mask_a, A, on=ep.rank == 0)
        elif batch.tm_atom is None:
            seg = _self_loop_rows(batch.edge_src, batch.edge_dst,
                                  new_bond_features, edge_mask, A)
        nf_a = _linear_dt(self.projection_a, x_atoms, self.dtype).reshape(
            A, H, self.atom_out // H)
        atom_out_feats, attn_atoms = _gat_dispatch(
            nf_a, ea_a, batch.edge_src, batch.edge_dst, mask_a, self.a,
            num_nodes=A, tm=batch.tm_atom, dp=batch.dp_atom,
            mode="attr" if pol.attr else "tcsr", self_loops=True, seg=seg,
            need_attn=need_attn, ep=ep, nbr=self._nbr(batch, "atom"))
        x_atoms_new = _zero_rows(atom_out_feats.reshape(A, -1),
                                 hooks.atom_mask, hooks.atom_rows)
        if hooks.atom_zero_vec is not None:
            x_atoms_new = x_atoms_new * (1.0 - hooks.atom_zero_vec)[:, None]
        return x_atoms_new * batch.atom_mask.to(self.dtype)[:, None], \
            attn_atoms

    @obs.spanned("fragnet.gat.frag")
    def frag_pass(self, x_frags, ea_f, avec, batch, need_attn: bool = False,
                  self_loops: bool = False):
        """Pass 5, the fragment-graph GAT over edge attributes ``ea_f`` (C,
        edge_out) with attention vector ``avec`` (gat2.py:283-316): the
        fragment features enter per head WITHOUT projection. With
        ``self_loops`` each fragment also attends to itself with zero edge
        attributes (gat2_edge's add_frag_self_loops). Returns (new fragment
        features (F, atom_out), masked; attention by source or None)."""
        F_ = x_frags.shape[0]
        nf_f = x_frags.reshape(F_, self.num_heads, -1)
        mask_f, ep, seg = batch.fconn_mask, self.ep, None
        if ep is not None:
            Cs = batch.frag_src.shape[0]
            ea_f = shard_rows(ea_f, ep, Cs)
            mask_f = shard_rows(mask_f.to(self.dtype), ep, Cs)
            if self_loops and not isinstance(batch.tm_frag, EPTileMeta):
                seg = _self_loop_rows(batch.frag_src, batch.frag_dst, ea_f,
                                      mask_f, F_, on=ep.rank == 0)
        elif self_loops and batch.tm_frag is None:
            seg = _self_loop_rows(batch.frag_src, batch.frag_dst, ea_f,
                                  mask_f, F_)
        frag_out, attn_frags = _gat_dispatch(
            nf_f, ea_f, batch.frag_src, batch.frag_dst, mask_f, avec,
            num_nodes=F_, tm=batch.tm_frag, dp=batch.dp_frag,
            mode="attr" if self.policy.attr else "tcsr",
            self_loops=self_loops, seg=seg, need_attn=need_attn, ep=ep,
            nbr=None if self_loops else self._nbr(batch, "frag"))
        frag_mask = batch.frag_mask.to(self.dtype)
        return frag_out.reshape(F_, -1) * frag_mask[:, None], attn_frags


class FragNetLayer(_BondAtomPasses):
    """One four-level message-passing layer, computing in ``dtype`` (f32
    or bf16; parameters f32, logits and softmax f32). With ``ep`` (an
    EPContext) it runs edge-partitioned: the batch holds this rank's slice
    of the edge fields (dist/edge_partition.py:ep_local_batch) and every GAT
    pass is the K3 pass (f32 or bf16). A batch with ELL tables and no
    kernel metadata runs every pass as the ELL pass (``takes_ell``)."""

    takes_ell = True

    def __init__(self, atom_in: int = 128, atom_out: int = 128,
                 edge_in: int = 128, edge_out: int = 128,
                 fedge_in: int = 128, bond_edge_in: int = 1,
                 fbond_edge_in: int = 6, num_heads: int = 4,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None, ep=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(atom_in, atom_out, edge_in, edge_out, bond_edge_in,
                         num_heads, policy, generator, ep, dtype)
        H = num_heads
        eph = edge_out // H
        aph = atom_out // H
        g = generator
        self.edge_attr_fbond_embed = _linear(fbond_edge_in, eph, "torch", g)
        self.projection_fb = _linear(fedge_in, eph * H, "torch", g)
        self.f_a_b = _attn_param(H, 3 * eph, g)
        self.f = _attn_param(H, 2 * aph + edge_out, g)

    @obs.spanned("fragnet.gat.fconn")
    def fconn_pass(self, nf_fbonds, batch, need_attn: bool,
                   hooks: LayerHooks):
        """Pass 4, the fconn-graph GAT (gat2.py:238-278): (new fconn
        features (C, edge_out), masked, the hooks' rows zeroed; attention
        by source or None)."""
        H, pol, ep, dt = self.num_heads, self.policy, self.ep, self.dtype
        edge_out_ph = self.edge_out // H
        C = nf_fbonds.shape[0]
        ea_fb = _linear_dt(self.edge_attr_fbond_embed, batch.ea_fbonds, dt)
        nf_fb = _linear_dt(self.projection_fb, nf_fbonds, dt).reshape(
            C, H, edge_out_ph)
        fold_f = None
        if ep is None and pol.fc == "planes" and batch.dp_fc is not None:
            # raw fconn attrs are the 6-dim connection one-hot sums → rank-6
            fold_f = _fold_planes(self.edge_attr_fbond_embed,
                                  batch.ea_fbonds.shape[1], self.f_a_b,
                                  edge_out_ph, dt)
        fbond_out, attn_fbonds = _gat_dispatch(
            nf_fb, ea_fb, batch.fc_src, batch.fc_dst, batch.fc_mask,
            self.f_a_b, num_nodes=C, tm=batch.tm_fc, dp=batch.dp_fc,
            mode=pol.fc, fold=fold_f, need_attn=need_attn, ep=ep,
            nbr=self._nbr(batch, "fc"))
        new_fbond_features = _zero_rows(fbond_out.reshape(C, -1),
                                        hooks.fconn_pair(), hooks.fconn_rows)
        return new_fbond_features * batch.fconn_mask.to(dt)[:, None], \
            attn_fbonds

    def forward(self, x_atoms, nf_bonds, nf_fbonds, batch,
                need_attn: bool = False,
                hooks: Optional[LayerHooks] = None):
        hooks = hooks or LayerHooks()
        # the layer's inputs in the compute type (layers.py:256-264)
        x_atoms, nf_bonds, nf_fbonds = (x.to(self.dtype) for x in
                                        (x_atoms, nf_bonds, nf_fbonds))

        # ---- pass 1: bond-graph GAT (gat2.py:137-169) --------------------
        new_bond_features, attn_bonds = self.bond_pass(nf_bonds, batch,
                                                       need_attn, hooks)
        # ---- pass 2: atom-graph GAT with self-loops (gat2.py:178-224) ----
        x_atoms_new, attn_atoms = self.atom_pass(x_atoms, new_bond_features,
                                                 batch, need_attn, hooks)

        # ---- pass 3: atom → fragment pooling (gat2.py:234) ----------------
        # incoming fragment state is recomputed from atoms every layer (the
        # reference overwrites its x_frags argument)
        F_ = batch.x_frags.shape[0]
        x_frags = segment_sum(x_atoms_new, batch.atom_to_frag, F_)

        # ---- pass 4: fconn-graph GAT (gat2.py:238-278) --------------------
        new_fbond_features, attn_fbonds = self.fconn_pass(nf_fbonds, batch,
                                                          need_attn, hooks)

        # ---- pass 5: frag-graph GAT (gat2.py:283-316) ---------------------
        x_frags_new, attn_frags = self.frag_pass(
            x_frags, new_fbond_features, self.f, batch, need_attn)

        attn = None
        if need_attn:
            attn = LayerAttn(atoms=attn_atoms, frags=attn_frags,
                             bonds=attn_bonds, fbonds=attn_fbonds)
        return (x_atoms_new, x_frags_new, new_bond_features,
                new_fbond_features, attn)
