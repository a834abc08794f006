"""Cancer drug response prediction (CDRP) model (counterpart of
fragnet_tpu/model/cdrp.py).

Reference: fragnet/model/cdrp/model.py — drug encoder + gene-expression MLP
(903 → 1024 → 256 → 64 → 256, ReLU after EVERY layer incl. the last,
MLP:6-22) → concat → 2-layer head (:25-43). Parameter names are the
reference's (``drug_model.pretrain.*``, ``cell_model.predictor.{0..3}``,
``fc1``, ``fc2``), which fragnet_tpu/train/checkpoint.py's ``cdrp`` mapper
reads. The MLP and the head are torch ops on every device (XLA in the JAX
package; no Pallas kernel exists for them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from fragnet_tpu_torch.model.finetune import FragNetFineTuneBase
from fragnet_tpu_torch.model.heads import _dense
from fragnet_tpu_torch.model.layers import KernelPolicy


class GeneMLP(nn.Module):
    def __init__(self, gene_dim: int = 903,
                 hidden_dims: Sequence[int] = (1024, 256, 64),
                 out_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [gene_dim] + list(hidden_dims) + [out_dim]
        self.predictor = nn.ModuleList([
            _dense(widths[i], widths[i + 1], generator)
            for i in range(len(widths) - 1)])

    def forward(self, v):
        for lin in self.predictor:
            v = torch.relu(lin(v))
        return v


class CDRPModel(nn.Module):
    def __init__(self, num_layer: int = 4, num_heads: int = 4,
                 drop_ratio: float = 0.15, emb_dim: int = 128,
                 atom_features: int = 167, frag_features: int = 167,
                 edge_features: int = 17, fedge_in: int = 6,
                 fbond_edge_in: int = 6, gene_dim: int = 903,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.drug_model = FragNetFineTuneBase(
            num_layer=num_layer, num_heads=num_heads, drop_ratio=drop_ratio,
            emb_dim=emb_dim, atom_features=atom_features,
            frag_features=frag_features, edge_features=edge_features,
            fedge_in=fedge_in, fbond_edge_in=fbond_edge_in, policy=policy,
            generator=g)
        self.cell_model = GeneMLP(gene_dim=gene_dim, generator=g)
        self.fc1 = _dense(2 * emb_dim + 256, 128, g)
        self.fc2 = _dense(128, 1, g)

    def forward(self, batch):
        drug_enc = self.drug_model.encode(batch)
        cell_enc = self.cell_model(batch.gene_expr.float())
        return self.fc2(self.fc1(torch.cat([drug_enc, cell_enc], dim=1)))
