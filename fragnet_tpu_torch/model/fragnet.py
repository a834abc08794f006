"""FragNet encoder — stack of FragNetLayers with the reference's dataflow
(fragnet/model/gat/gat2.py:333-442; counterpart of
fragnet_tpu/model/fragnet.py):

  * dropout on the raw one-hot inputs (gat2.py:396-397 — reference quirk,
    kept for parity);
  * layer 0 consumes raw features; layers 1..L−1 feed the evolving
    edge/fedge features back as both line-graph node features and edge attrs
    (gat2.py:420-434);
  * ReLU + dropout between layers, applied to all four streams.

``ep`` (an EPContext, dist/edge_partition.py) builds edge-partitioned
layers (the JAX package's ``ep_axis``); ``dtype`` (f32 or bf16) is every
layer's compute type (the JAX package's ``FragNet.dtype``), and the four
streams leave the encoder in it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from fragnet_tpu_torch.model.layers import (FragNetLayer, KernelPolicy,
                                            LayerHooks)


class FragNet(nn.Module):
    def __init__(self, num_layer: int = 4, drop_ratio: float = 0.15,
                 emb_dim: int = 128, atom_features: int = 167,
                 frag_features: int = 167, edge_features: int = 17,
                 fedge_in: int = 6, fbond_edge_in: int = 6,
                 num_heads: int = 4, policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None, ep=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop = nn.Dropout(drop_ratio)
        self.layers = nn.ModuleList([
            FragNetLayer(
                atom_in=atom_features if i == 0 else emb_dim,
                atom_out=emb_dim,
                edge_in=edge_features if i == 0 else emb_dim,
                edge_out=emb_dim,
                fedge_in=fedge_in if i == 0 else emb_dim,
                bond_edge_in=1,
                fbond_edge_in=fbond_edge_in,
                num_heads=num_heads,
                policy=policy,
                generator=generator,
                ep=ep,
                dtype=dtype,
            )
            for i in range(num_layer)
        ])

    def forward(self, batch, return_attentions: bool = False,
                hooks: Optional[List[LayerHooks]] = None):
        """``hooks``: one LayerHooks per layer (interp/), or None."""
        act = torch.relu
        drop = self.drop
        x_atoms = drop(batch.x_atoms)
        edge_f, fedge_f = batch.nf_bonds, batch.nf_fbonds
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            # the returned attention vectors are the last layer's
            x_atoms, x_frags, edge_f, fedge_f, attn = layer(
                x_atoms, edge_f, fedge_f, batch,
                need_attn=return_attentions and i == last,
                hooks=hooks[i] if hooks else None)
            x_atoms = act(drop(x_atoms))
            x_frags = act(drop(x_frags))
            edge_f = act(drop(edge_f))
            fedge_f = act(drop(fedge_f))
        if return_attentions:
            return x_atoms, x_frags, edge_f, fedge_f, attn
        return x_atoms, x_frags, edge_f, fedge_f
