"""Finetune models: encoder → masked sum-pool (atoms & frags by graph) →
concat (FragNetFineTuneBase, the encoder-only module of the DTA and CDRP
models) → FTHead (FragNetFineTune). Reference: gat2.py:758-826
(FragNetFineTune) and train/finetune/finetune_dta.py:64-106
(FragNetFineTuneBase); counterpart of fragnet_tpu/model/finetune.py."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from fragnet_tpu_torch.model.fragnet import FragNet
from fragnet_tpu_torch.model.heads import FTHEADS, pool_graphs
from fragnet_tpu_torch.model.layers import KernelPolicy, LayerHooks


def make_fthead(fthead: str, in_dim: int, n_classes: int, h1: int, h2: int,
                h3: int, h4: int, drop_ratio: float, act: str,
                generator: Optional[torch.Generator]) -> nn.Module:
    """The FTHead ``fthead`` over an ``in_dim``-wide representation, with
    the arguments the JAX package's FragNetFineTune (and _PooledHead of
    its variants) gives each head."""
    cls = FTHEADS[fthead]
    g = generator
    if fthead in ("FTHead1", "FTHead2"):
        return cls(in_dim, n_classes=n_classes, generator=g)
    if fthead == "FTHead3":
        return cls(in_dim, h1=h1, h2=h2, h3=h3, h4=h4, drop_ratio=drop_ratio,
                   n_classes=n_classes, act=act, generator=g)
    if fthead == "FTHead4":
        return cls(in_dim, h1=h1, act=act, n_classes=n_classes,
                   drop_ratio=drop_ratio, generator=g)
    return cls(in_dim, h1=h1, h2=h2, drop_ratio=drop_ratio,
               n_classes=n_classes, act=act, generator=g)


class FragNetFineTuneBase(nn.Module):
    """Encoder + pooling: ``encode`` returns the (G, 2·emb) graph
    representation, pooled atoms ‖ pooled fragments. The encoder is
    ``pretrain``, as in the JAX module. Parameters are drawn from
    ``generator`` (a seeded ``torch.Generator``) on the CPU; move the
    module to its device afterwards. ``ep`` (an EPContext) makes the
    encoder edge-partitioned; the parameters are the same. ``dtype`` (f32
    or bf16) is the encoder's compute type; the pooling promotes to f32
    (the masks are f32), so the representation is f32."""

    def __init__(self, num_layer: int = 4, drop_ratio: float = 0.15,
                 num_heads: int = 4, emb_dim: int = 128,
                 atom_features: int = 167, frag_features: int = 167,
                 edge_features: int = 17, fedge_in: int = 6,
                 fbond_edge_in: int = 6,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None, ep=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pretrain = FragNet(
            num_layer=num_layer, drop_ratio=drop_ratio, emb_dim=emb_dim,
            atom_features=atom_features, frag_features=frag_features,
            edge_features=edge_features, fedge_in=fedge_in,
            fbond_edge_in=fbond_edge_in, num_heads=num_heads, policy=policy,
            generator=generator, ep=ep, dtype=dtype)

    def encode(self, batch, hooks: Optional[List[LayerHooks]] = None,
               return_attentions: bool = False):
        """``hooks``: one LayerHooks per encoder layer (interp/), or None;
        with ``return_attentions`` the last layer's LayerAttn comes too."""
        out = self.pretrain(batch, return_attentions=return_attentions,
                            hooks=hooks)
        rep = pool_graphs(out[0], out[1], batch)
        return (rep, out[4]) if return_attentions else rep

    def forward(self, batch):
        return self.encode(batch)


class FragNetFineTune(FragNetFineTuneBase):
    """The flagship finetune model (gat2.py:758-826): FragNetFineTuneBase's
    representation through the FTHead ``fthead``, which runs in f32 whatever
    the encoder's ``dtype`` (the JAX head is a Dense with dtype None over
    the f32 pooled representation)."""

    def __init__(self, n_classes: int = 1, atom_features: int = 167,
                 frag_features: int = 167, edge_features: int = 17,
                 fedge_in: int = 6, fbond_edge_in: int = 6,
                 num_layer: int = 4, num_heads: int = 4,
                 drop_ratio: float = 0.15, h1: int = 256, h2: int = 256,
                 h3: int = 256, h4: int = 256, act: str = "celu",
                 emb_dim: int = 128, fthead: str = "FTHead3",
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None, ep=None,
                 dtype: torch.dtype = torch.float32):
        g = generator
        super().__init__(
            num_layer=num_layer, drop_ratio=drop_ratio, num_heads=num_heads,
            emb_dim=emb_dim, atom_features=atom_features,
            frag_features=frag_features, edge_features=edge_features,
            fedge_in=fedge_in, fbond_edge_in=fbond_edge_in, policy=policy,
            generator=g, ep=ep, dtype=dtype)
        # over pooled atoms ‖ pooled frags
        self.fthead = make_fthead(fthead, 2 * emb_dim, n_classes, h1, h2, h3,
                                  h4, drop_ratio, act, g)

    def forward(self, batch, return_attentions: bool = False,
                hooks: Optional[List[LayerHooks]] = None):
        """``hooks``: one LayerHooks per encoder layer (interp/), or None;
        with ``return_attentions`` the last layer's LayerAttn comes too."""
        out = self.encode(batch, hooks=hooks,
                          return_attentions=return_attentions)
        if return_attentions:
            return self.fthead(out[0]).float(), out[1]
        return self.fthead(out).float()
