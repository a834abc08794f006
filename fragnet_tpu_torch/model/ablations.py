"""The ablation family: the reference's v1 GAT and its GCN / GIN baselines
(counterpart of fragnet_tpu/model/ablations.py).

* ``gat`` — fragnet/model/gat/gat.py:11-133: a 3-head GAT over the bond
  graph (attention over [h_dst ‖ cos-angle ‖ h_src]) whose new bond
  features reach only an edge embedding that is computed and unused (the
  reference's quirk, gat.py:92), a GCN-normalized (deg^-1/2 symmetric)
  atom pass, and fragment state recomputed from atoms, summed over
  fragment neighbours and put through frag_mlp. Every layer re-reads the
  RAW bond-graph node features (gat.py:160-180).
* ``gcn`` — fragnet/model/gcn/gcn.py:11-96: no bond graph; the GCN atom
  pass with self-loops and the fragment MLP. gcn2's layer
  (model/variants.py) is the same.
* ``gcn3`` — fragnet/model/gcn/gcn3.py:11-116 (GIN): the bond graph
  aggregated additively (edge attribute embedding + source features, no
  attention) over self-loops that carry cos-angle 1.5 (gcn3.py:52-55),
  then an additive atom pass, message = edge attribute + h_src.

The v1 bond GAT has H = 3 heads of ``edge_in // 3`` = 5 columns (gat.py:
33) and a raw 1-dim edge attribute. The TCSR kernels take head widths
that are multiples of 4 with a power-of-two quarter, so each head is
zero-padded to 8 columns (in the projected features and in the dst and
src slices of ``a_b``) on every device: the zero columns add exact zeros
to every logit, the padded output columns are sliced off, and their
gradient is dropped. The pass runs on the TCSR kernel whatever
``kernel.bond`` says (K4/K5 take H in {1, 2, 4, 8} only). The GCN and GIN
aggregations are torch ops on every device, as the JAX package runs them
in XLA (no Pallas kernel exists for them).

Modules that never affect the forward in the reference (frag_embed,
frag_message_mlp, atom_mlp, bias — gat.py:18-31) are not created; the
computed-but-unused edge embeddings are, so that the JAX package's
parameters carry over strictly. Parameter names: v1's layers are
``pretrain.layer{i+1}`` (the reference's fixed attributes, the JAX
package's ``_torch_key_to_flax_gat1``), gcn's and gcn3's
``pretrain.layers.{i}`` as gcn2's; the head is ``lin1`` / ``out``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fragnet_tpu_torch.model.heads import pool_graphs
from fragnet_tpu_torch.model.layers import _attn_param, _gat_dispatch, _linear
from fragnet_tpu_torch.ops.segment import segment_sum


def _kernel_head_width(d: int) -> int:
    """The least head width >= ``d`` the TCSR kernels take: a multiple of
    4 whose quarter is a power of two (ops/tcsr_gat.py:_check_bwd)."""
    q = 1
    while 4 * q < d:
        q *= 2
    return 4 * q


def _atom_self_loops(batch, A: int):
    """(src, dst, mask) of the atom graph with a self-loop per atom slot
    appended after the real edges (gat.py:86-91)."""
    sl = torch.arange(A, dtype=batch.edge_src.dtype,
                      device=batch.edge_src.device)
    return (torch.cat([batch.edge_src, sl]), torch.cat([batch.edge_dst, sl]),
            torch.cat([batch.edge_mask, batch.edge_mask.new_ones((A,))]))


def gcn_atom_pass(x, src, dst, e_mask, atom_mask):
    """Symmetric-degree-normalized sum aggregation (gat.py:93-101): each
    edge's message x[src] · deg(src)^-1/2 · deg(dst)^-1/2, the degrees
    counted over the source side."""
    A = x.shape[0]
    deg = segment_sum(e_mask, src, A)
    dis = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                      torch.zeros_like(deg))
    norm = dis.index_select(0, src) * dis.index_select(0, dst) * e_mask
    msg = x.index_select(0, src) * norm[:, None]
    return segment_sum(msg, dst, A) * atom_mask[:, None]


def frag_neighbor_mlp(x_atoms_new, batch, frag_mlp: nn.Module):
    """Fragment state from atoms → sum over fragment neighbours →
    ``frag_mlp`` (gat.py:104-111)."""
    F_ = batch.x_frags.shape[0]
    x_frags = segment_sum(x_atoms_new, batch.atom_to_frag, F_)
    fmsg = x_frags.index_select(0, batch.frag_src) * batch.fconn_mask[:, None]
    frag_sum = segment_sum(fmsg, batch.frag_dst, F_)
    return frag_mlp(frag_sum) * batch.frag_mask[:, None]


def _frag_mlp(width: int, generator: Optional[torch.Generator]):
    """frag_mlp: width → 2·width → ReLU → width; entries .0 and .2 are the
    reference's names."""
    return nn.Sequential(_linear(width, 2 * width, "torch", generator),
                         nn.ReLU(),
                         _linear(2 * width, width, "torch", generator))


class FragNetLayerV1(nn.Module):
    """gat.py:11-113 — the 3-head bond GAT (on the TCSR kernel, heads
    zero-padded), the GCN atom pass and the fragment MLP. Returns (atoms,
    fragments)."""

    def __init__(self, atom_in: int = 167, atom_out: int = 128,
                 edge_in: int = 17, edge_out: int = 128, num_heads: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_heads = num_heads
        self.head_dim = edge_in // num_heads  # gat.py:33 overwrite
        width = self.head_dim * num_heads
        self.projection_b = _linear(edge_in, width, "xavier", g)
        self.a_b = _attn_param(num_heads, 2 * self.head_dim + 1, g)
        # edge_out: the constructor-time width of the unused edge_embed
        self.edge_embed = _linear(width, edge_out, "torch", g)
        self.atom_embed = _linear(atom_in, atom_out, "torch", g)
        self.frag_mlp = _frag_mlp(atom_out, g)

    def bond_pass(self, nf_bonds, batch):
        """The bond-graph GAT, each head zero-padded from ``head_dim`` to
        the kernels' width and sliced back: new bond features (E, H ·
        head_dim), masked. The TCSR kernel runs it when the batch carries
        ``tm_bond``; without it, the segment path (CPU only)."""
        H, D = self.num_heads, self.head_dim
        Dp = _kernel_head_width(D)
        E = nf_bonds.shape[0]
        nf_b = F.pad(self.projection_b(nf_bonds).reshape(E, H, D),
                     (0, Dp - D))
        a, pad = self.a_b, self.a_b.new_zeros((H, Dp - D))
        avec = torch.cat([a[:, :D], pad, a[:, D:D + 1], a[:, D + 1:], pad],
                         dim=1)
        out, _ = _gat_dispatch(nf_b, batch.ea_bonds, batch.bg_src,
                               batch.bg_dst, batch.bg_mask, avec,
                               num_nodes=E, tm=batch.tm_bond, dp=None,
                               mode="tcsr")
        return out[:, :, :D].reshape(E, H * D) * batch.edge_mask[:, None]

    def forward(self, x_atoms, nf_bonds, batch):
        # computed as the reference computes them (gat.py:92); neither the
        # bond features nor their embedding reaches the outputs
        self.edge_embed(self.bond_pass(nf_bonds, batch))
        src, dst, e_mask = _atom_self_loops(batch, x_atoms.shape[0])
        x_atoms_new = gcn_atom_pass(self.atom_embed(x_atoms), src, dst,
                                    e_mask, batch.atom_mask)
        return x_atoms_new, frag_neighbor_mlp(x_atoms_new, batch,
                                              self.frag_mlp)


class FragNetLayerGCN(nn.Module):
    """gcn.py:11-75, and gcn2's layer (variants.py:224-291): the GCN atom
    pass with self-loops and the fragment MLP. Returns (atoms,
    fragments)."""

    def __init__(self, atom_in: int = 167, atom_out: int = 128,
                 edge_in: int = 17, edge_out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.atom_embed = _linear(atom_in, atom_out, "torch", g)
        self.edge_embed = _linear(edge_in, edge_out, "torch", g)
        self.frag_mlp = _frag_mlp(atom_out, g)

    def forward(self, x_atoms, batch):
        # computed and unused, as in the reference (gcn.py:47, gcn2.py:45)
        self.edge_embed(batch.edge_attr)
        src, dst, e_mask = _atom_self_loops(batch, x_atoms.shape[0])
        x_atoms_new = gcn_atom_pass(self.atom_embed(x_atoms), src, dst,
                                    e_mask, batch.atom_mask)
        return x_atoms_new, frag_neighbor_mlp(x_atoms_new, batch,
                                              self.frag_mlp)


def gin_bond_pass(ea_emb, nf_b, batch):
    """The GIN bond aggregation (gcn3.py:52-74): each bond sums, over its
    bond-graph in-edges and a self-loop, the edge attribute's embedding
    plus the source's features. ``ea_emb`` (EB + E, D): the embedded
    cos-angles, then the self-loops' 1.5; ``nf_b`` (E, D)."""
    E = nf_b.shape[0]
    slb = torch.arange(E, dtype=batch.bg_src.dtype, device=nf_b.device)
    bsrc = torch.cat([batch.bg_src, slb])
    bdst = torch.cat([batch.bg_dst, slb])
    b_mask = torch.cat([batch.bg_mask, batch.edge_mask])
    msg = (ea_emb + nf_b.index_select(0, bsrc)) * b_mask[:, None]
    return segment_sum(msg, bdst, E) * batch.edge_mask[:, None]


def gin_atom_pass(x, new_bond_features, batch):
    """The GIN atom aggregation (gcn3.py:85-97): message = edge attribute
    + h_src over the atom graph with self-loops, whose attributes are 0."""
    A = x.shape[0]
    src, dst, e_mask = _atom_self_loops(batch, A)
    e_attr = torch.cat([new_bond_features, new_bond_features.new_zeros(
        (A, new_bond_features.shape[1]))])
    msg = (e_attr + x.index_select(0, src)) * e_mask[:, None]
    return segment_sum(msg, dst, A) * batch.atom_mask[:, None]


class FragNetLayerGIN(nn.Module):
    """gcn3.py:11-116 — additive (GIN-style) bond and atom aggregation.
    Returns (atoms, fragments)."""

    def __init__(self, atom_in: int = 167, atom_out: int = 128,
                 edge_in: int = 17, edge_out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.edge_attr_bond_embed = _linear(1, edge_out, "torch", g)
        self.edge_embed = _linear(edge_in, edge_out, "torch", g)
        self.atom_embed = _linear(atom_in, atom_out, "torch", g)
        self.frag_mlp = _frag_mlp(atom_out, g)

    def forward(self, x_atoms, nf_bonds, batch):
        # the bond graph's self-loops carry cos-angle 1.5 (gcn3.py:52-55)
        ea = torch.cat([batch.ea_bonds, batch.ea_bonds.new_full(
            (nf_bonds.shape[0], 1), 1.5)])
        new_bond_features = gin_bond_pass(self.edge_attr_bond_embed(ea),
                                          self.edge_embed(nf_bonds), batch)
        x_atoms_new = gin_atom_pass(self.atom_embed(x_atoms),
                                    new_bond_features, batch)
        return x_atoms_new, frag_neighbor_mlp(x_atoms_new, batch,
                                              self.frag_mlp)


class _AblationEncoder(nn.Module):
    """The shared stack (gat.py:160-180): dropout on the raw atom features,
    ReLU between layers (no dropout there), the raw bond-graph node
    features re-fed to every layer."""

    def __init__(self, kind: str = "gat", num_layer: int = 4,
                 drop_ratio: float = 0.15, emb_dim: int = 128,
                 atom_features: int = 167, edge_features: int = 17,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in ("gat", "gcn", "gcn3"):
            raise ValueError(f"unknown ablation {kind!r} (gat|gcn|gcn3)")
        self.kind = kind
        self.drop = nn.Dropout(drop_ratio)
        cls = {"gat": FragNetLayerV1, "gcn": FragNetLayerGCN,
               "gcn3": FragNetLayerGIN}[kind]
        layers = [cls(atom_in=atom_features if i == 0 else emb_dim,
                      atom_out=emb_dim, edge_in=edge_features,
                      edge_out=emb_dim, generator=generator)
                  for i in range(num_layer)]
        self.num_layer = num_layer
        if kind == "gat":  # the reference's fixed attributes layer1..layerN
            for i, layer in enumerate(layers):
                self.add_module(f"layer{i + 1}", layer)
        else:
            self.layers = nn.ModuleList(layers)

    def stack(self):
        """The layers, in order."""
        if self.kind == "gat":
            return [getattr(self, f"layer{i + 1}")
                    for i in range(self.num_layer)]
        return list(self.layers)

    def forward(self, batch):
        x_atoms = self.drop(batch.x_atoms)
        for layer in self.stack():
            if self.kind == "gcn":
                x_atoms, x_frags = layer(x_atoms, batch)
            else:
                x_atoms, x_frags = layer(x_atoms, batch.nf_bonds, batch)
            x_atoms, x_frags = torch.relu(x_atoms), torch.relu(x_frags)
        return x_atoms, x_frags


class _AblationFineTune(nn.Module):
    """The shared finetune model (gat.py:216-242, gcn.py:141-170,
    gcn3.py:216-246): pooled atoms ‖ fragments → dropout → lin1 (2·emb →
    2·emb) → ReLU → dropout → out. Its dropout rate is 0.15 whatever
    ``drop_ratio`` says (the encoder's input dropout takes that)."""

    def __init__(self, kind: str = "gat", n_classes: int = 1,
                 num_layer: int = 4, drop_ratio: float = 0.15,
                 emb_dim: int = 128, atom_features: int = 167,
                 edge_features: int = 17,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pretrain = _AblationEncoder(kind, num_layer, drop_ratio,
                                         emb_dim, atom_features,
                                         edge_features, generator)
        self.drop = nn.Dropout(0.15)
        self.lin1 = _linear(2 * emb_dim, 2 * emb_dim, "torch", generator)
        self.out = _linear(2 * emb_dim, n_classes, "torch", generator)

    def forward(self, batch):
        x = self.drop(pool_graphs(*self.pretrain(batch), batch))
        x = self.drop(torch.relu(self.lin1(x)))
        return self.out(x).float()


def FragNetFineTuneV1(**kw) -> _AblationFineTune:
    return _AblationFineTune(kind="gat", **kw)


def FragNetFineTuneGCNv1(**kw) -> _AblationFineTune:
    return _AblationFineTune(kind="gcn", **kw)


def FragNetFineTuneGIN(**kw) -> _AblationFineTune:
    return _AblationFineTune(kind="gcn3", **kw)
