"""The model variants gat2_lite, gat2_edge and gcn2 (counterpart of
fragnet_tpu/model/variants.py; reference train/finetune/finetune_gat2.py:
92-211).

* Lite (gat2_lite.py): the bond and atom passes of gat2's layer; fragments
  are still pooled from atoms each layer (gat2_lite.py:140) but receive no
  message passing.
* Edge (gat2_edge.py): as lite, then the fragment graph attends over the
  transformed raw connection features (cnx_attr_transform, gat2_edge.py:
  34,142-145) instead of the learned fconn line graph. Its fragment pass
  has gat2's pass 5 shapes, so it runs on the same kernels.
* GCN (gcn/gcn2.py): no attention; a symmetric-degree-normalized atom
  convolution (self-loops included), a fragment neighbour sum and
  frag_mlp — the layer of model/ablations.py's gcn. Its edge embedding
  is built and applied but unused in the message (gcn2.py:45-56 quirk).

The GAT passes are FragNetLayer's own (model/layers.py:_BondAtomPasses):
the same kernels, parameter names and policy. The GCN aggregations are
torch ops on every device (the JAX package runs them in XLA; no Pallas
kernel exists for them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fragnet_tpu_torch.model.ablations import FragNetLayerGCN
from fragnet_tpu_torch.model.finetune import make_fthead
from fragnet_tpu_torch.model.heads import pool_graphs
from fragnet_tpu_torch.model.layers import (KernelPolicy, _BondAtomPasses,
                                            _attn_param, _linear)
from fragnet_tpu_torch.ops.segment import segment_sum


class FragNetLayerLite(_BondAtomPasses):
    """gat2_lite's layer: bond pass, atom pass, atom → fragment sum.
    Returns (atoms, fragments, bond features)."""

    def forward(self, x_atoms, nf_bonds, batch):
        new_bond_features, _ = self.bond_pass(nf_bonds, batch)
        x_atoms_new, _ = self.atom_pass(x_atoms, new_bond_features, batch)
        x_frags = segment_sum(x_atoms_new, batch.atom_to_frag,
                              batch.x_frags.shape[0])
        return x_atoms_new, x_frags, new_bond_features


class FragNetLayerEdge(FragNetLayerLite):
    """gat2_edge's layer: lite's, then the fragment pass over
    cnx_attr_transform(cnx_attr) with attention vector ``f``. With
    ``add_frag_self_loops`` each fragment also attends to itself with a
    zero edge attribute (a field the JAX build_model never sets)."""

    def __init__(self, atom_in: int, atom_out: int, edge_in: int,
                 edge_out: int, cnx_in: int = 6, bond_edge_in: int = 1,
                 num_heads: int = 4, add_frag_self_loops: bool = False,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__(atom_in, atom_out, edge_in, edge_out, bond_edge_in,
                         num_heads, policy, generator)
        self.add_frag_self_loops = add_frag_self_loops
        self.cnx_attr_transform = _linear(cnx_in, edge_out, "torch",
                                          generator)
        self.f = _attn_param(num_heads, 2 * (atom_out // num_heads)
                             + edge_out, generator)

    def forward(self, x_atoms, nf_bonds, batch):
        x_atoms_new, x_frags, new_bond_features = super().forward(
            x_atoms, nf_bonds, batch)
        cnx = self.cnx_attr_transform(batch.cnx_attr)
        x_frags_new, _ = self.frag_pass(x_frags, cnx, self.f, batch,
                                        self_loops=self.add_frag_self_loops)
        return x_atoms_new, x_frags_new, new_bond_features


class _VariantEncoder(nn.Module):
    """The variants' stack (FragNetLite / FragNetEdge / FragNetGCN):
    dropout on the raw atom features, ReLU + dropout between layers on
    every stream; the bond features evolve layer to layer (lite, edge)."""

    def __init__(self, layers, drop_ratio: float):
        super().__init__()
        self.drop = nn.Dropout(drop_ratio)
        self.layers = nn.ModuleList(layers)

    def forward(self, batch):
        drop = self.drop
        x_atoms = drop(batch.x_atoms)
        edge_f = batch.nf_bonds
        for layer in self.layers:
            gcn = isinstance(layer, FragNetLayerGCN)
            if gcn:
                x_atoms, x_frags = layer(x_atoms, batch)
            else:
                x_atoms, x_frags, edge_f = layer(x_atoms, edge_f, batch)
            x_atoms = torch.relu(drop(x_atoms))
            x_frags = torch.relu(drop(x_frags))
            if not gcn:
                edge_f = torch.relu(drop(edge_f))
        return x_atoms, x_frags


def _variant_layers(kind: str, num_layer: int, emb_dim: int,
                    atom_features: int, edge_features: int, fedge_in: int,
                    num_heads: int, add_frag_self_loops: bool,
                    policy: KernelPolicy,
                    generator: Optional[torch.Generator]):
    out = []
    for i in range(num_layer):
        a_in = atom_features if i == 0 else emb_dim
        e_in = edge_features if i == 0 else emb_dim
        if kind == "gcn2":
            out.append(FragNetLayerGCN(a_in, emb_dim, edge_features, emb_dim,
                                       generator=generator))
        elif kind == "gat2_edge":
            out.append(FragNetLayerEdge(
                a_in, emb_dim, e_in, emb_dim, cnx_in=fedge_in,
                num_heads=num_heads, add_frag_self_loops=add_frag_self_loops,
                policy=policy, generator=generator))
        else:
            out.append(FragNetLayerLite(a_in, emb_dim, e_in, emb_dim, 1,
                                        num_heads, policy, generator))
    return out


class _PooledHead(nn.Module):
    """The variants' finetune model (variants.py:298-330): the encoder
    ``pretrain``, masked sum-pools of atoms and fragments by graph, then
    the FTHead ``fthead`` with the JAX package's per-head arguments.
    Parameters are drawn from ``generator`` on the CPU."""

    kind = ""

    def __init__(self, n_classes: int = 1, atom_features: int = 167,
                 frag_features: int = 167, edge_features: int = 17,
                 fedge_in: int = 6, fbond_edge_in: int = 6,
                 num_layer: int = 4, num_heads: int = 4,
                 drop_ratio: float = 0.15, h1: int = 256, h2: int = 256,
                 h3: int = 256, h4: int = 256, act: str = "celu",
                 emb_dim: int = 128, fthead: str = "FTHead3",
                 add_frag_self_loops: bool = False,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None):
        # add_frag_self_loops: gat2_edge's layer field, unused by the others
        super().__init__()
        self.pretrain = _VariantEncoder(_variant_layers(
            self.kind, num_layer, emb_dim, atom_features, edge_features,
            fedge_in, num_heads, add_frag_self_loops, policy, generator),
            drop_ratio)
        self.fthead = make_fthead(fthead, 2 * emb_dim, n_classes, h1, h2, h3,
                                  h4, drop_ratio, act, generator)

    def forward(self, batch):
        x_atoms, x_frags = self.pretrain(batch)
        return self.fthead(pool_graphs(x_atoms, x_frags, batch)).float()


class FragNetFineTuneLite(_PooledHead):
    """gat2_lite (gat2_lite.py)."""

    kind = "gat2_lite"


class FragNetFineTuneEdge(_PooledHead):
    """gat2_edge (gat2_edge.py); ``add_frag_self_loops`` as its layer's."""

    kind = "gat2_edge"


class FragNetFineTuneGCN(_PooledHead):
    """gcn2 (gcn/gcn2.py); ``num_heads`` and the kernel policy are taken
    for a uniform constructor and unused."""

    kind = "gcn2"
