"""Pretrain models: the FragNet encoder + the PretrainTask geometric head,
and the masked variants (counterpart of fragnet_tpu/model/pretrain.py;
reference model/gat/pretrain_heads.py:105-236 and gat2_pretrain.py).

The masks are drawn from a ``torch.Generator`` seeded with ``mask_seed``
(one per device, made on first use) and applied in train mode only; they
are not the JAX package's bits (its 'mask' RNG stream), so parity checks
run in eval mode.

``dtype`` (f32 or bf16) is the encoder's compute type (the JAX package's
``FragNetPreTrain.dtype``); the head's Linears have f32 parameters and no
dtype of their own, so, as flax's ``Dense(dtype=None)`` promotes a bf16
input, the head computes in f32 on the widened encoder outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from fragnet_tpu_torch.model.fragnet import FragNet
from fragnet_tpu_torch.model.heads import PretrainTask
from fragnet_tpu_torch.model.layers import KernelPolicy


class FragNetPreTrain(nn.Module):
    """Encoder + 4-target geometric head (pretrain_heads.py:105-131). Its
    parameters are ``pretrain.*`` (the encoder, as in FragNetFineTune) and
    ``head.*``. Drawn from ``generator`` on the CPU; move the module to its
    device afterwards."""

    def __init__(self, num_layer: int = 4, drop_ratio: float = 0.15,
                 num_heads: int = 4, emb_dim: int = 128,
                 atom_features: int = 167, frag_features: int = 167,
                 edge_features: int = 17, fedge_in: int = 6,
                 fbond_edge_in: int = 6,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pretrain = FragNet(
            num_layer=num_layer, drop_ratio=drop_ratio, emb_dim=emb_dim,
            atom_features=atom_features, frag_features=frag_features,
            edge_features=edge_features, fedge_in=fedge_in,
            fbond_edge_in=fbond_edge_in, num_heads=num_heads, policy=policy,
            generator=generator, dtype=dtype)
        self.head = PretrainTask(dim_in=emb_dim, dim_out=1,
                                 generator=generator)
        self.policy = policy

    def forward(self, batch):
        x_atoms, x_frags, e_edge, _ = self.pretrain(batch)
        return self.head(x_atoms, x_frags, e_edge, batch)


class _Masks:
    """One seeded ``torch.Generator`` per device."""

    def __init__(self, seed: int):
        self.seed = seed
        self._gens: Dict[torch.device, torch.Generator] = {}

    def get(self, device: torch.device) -> torch.Generator:
        g = self._gens.get(device)
        if g is None:
            g = torch.Generator(device=device).manual_seed(self.seed)
            self._gens[device] = g
        return g


class FragNetPreTrainMasked(FragNetPreTrain):
    """Masks 15% of atom *embeddings* after encoding (gat2_pretrain.py:
    47-52), in train mode."""

    def __init__(self, *args, mask_ratio: float = 0.15, mask_seed: int = 0,
                 **kw):
        super().__init__(*args, **kw)
        self.mask_ratio = mask_ratio
        self._masks = _Masks(mask_seed)

    def forward(self, batch):
        x_atoms, x_frags, e_edge, _ = self.pretrain(batch)
        if self.training:
            dev = x_atoms.device
            keep = torch.rand((x_atoms.shape[0], 1), device=dev,
                              generator=self._masks.get(dev)) \
                < (1.0 - self.mask_ratio)
            x_atoms = x_atoms * keep.to(x_atoms.dtype)
        return self.head(x_atoms, x_frags, e_edge, batch)


def mask_atom_features(generator: torch.Generator, x_atoms: torch.Tensor,
                       ratio: float = 0.3) -> torch.Tensor:
    """Input-level atom feature masking to −1 (reference data.py:1189-1193):
    each row is masked with probability ``ratio``, drawn from ``generator``
    (on ``x_atoms``'s device)."""
    rand = torch.rand((x_atoms.shape[0], 1), device=x_atoms.device,
                      generator=generator)
    return torch.where(rand < ratio, torch.full_like(x_atoms, -1.0), x_atoms)


class FragNetPreTrainMasked2(FragNetPreTrain):
    """Masks 30% of RAW atom input features to −1 before the encoder
    (pretrain_heads.py:219-228), in train mode; padded rows stay zero via
    the downstream atom_mask."""

    def __init__(self, *args, input_mask_ratio: float = 0.3,
                 mask_seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.input_mask_ratio = input_mask_ratio
        self._masks = _Masks(mask_seed)

    def forward(self, batch):
        if self.training:
            x = batch.x_atoms
            batch = dataclasses.replace(batch, x_atoms=mask_atom_features(
                self._masks.get(x.device), x, self.input_mask_ratio))
        x_atoms, x_frags, e_edge, _ = self.pretrain(batch)
        return self.head(x_atoms, x_frags, e_edge, batch)
