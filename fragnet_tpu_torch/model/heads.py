"""Prediction heads FTHead1–5 (gat2.py:569-751) and the geometric
pretraining head PretrainTask (pretrain_heads.py:8-102); counterpart of
fragnet_tpu/model/heads.py. Linear layers use the torch default weight
init and zero biases, as the JAX package's Dense layers do."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.model.layers import torch_linear_init_
from fragnet_tpu_torch.ops.segment import segment_sum


def pool_graphs(x_atoms, x_frags, batch) -> torch.Tensor:
    """The (G, 2·emb) graph representation every head reads: masked
    sum-pools of the atom and fragment features by graph, atoms ‖
    fragments."""
    G = batch.y.shape[0]
    return torch.cat([
        segment_sum(x_atoms, batch.atom_batch, G, mask=batch.atom_mask),
        segment_sum(x_frags, batch.frag_batch, G, mask=batch.frag_mask)],
        dim=1)


def make_activation(name: str) -> Callable:
    """The nine activation choices of FTHead3/4/5 (gat2.py:600-622).
    torch RReLU at eval uses slope (lower+upper)/2 = (1/8 + 1/3)/2."""
    table = {
        "relu": F.relu,
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "celu": F.celu,
        "selu": F.selu,
        "rrelu": lambda x: F.leaky_relu(x, (1.0 / 8 + 1.0 / 3) / 2),
        "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
        "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    }
    if name == "prelu":
        return nn.PReLU(init=0.25)
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


def _dense(d_in: int, d_out: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    torch_linear_init_(lin.weight, d_in, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class _MLPHead(nn.Module):
    """in_dim -> dims[0] -> ... -> dims[-1]; activation(dropout(linear))
    between all but the final layer (the FTHead2/3/5 predictor loop,
    gat2.py:745-749)."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 drop_ratio: float = 0.2, act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_dim] + list(dims)
        self.predictor = nn.ModuleList([
            _dense(widths[i], widths[i + 1], generator)
            for i in range(len(dims))])
        self.drop = nn.Dropout(drop_ratio)
        self.act = make_activation(act)

    def forward(self, x):
        for lin in self.predictor[:-1]:
            x = self.act(self.drop(lin(x)))
        return self.predictor[-1](x)


class FTHead1(nn.Module):
    """2-layer head: dropout→lin1→relu→dropout→out (gat2.py:569-588)."""

    def __init__(self, in_dim: int, h1: int = 128, drop_ratio: float = 0.2,
                 n_classes: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop = nn.Dropout(drop_ratio)
        self.lin1 = _dense(in_dim, h1, generator)
        self.out = _dense(h1, n_classes, generator)

    def forward(self, enc):
        x = self.drop(enc)
        x = torch.relu(self.lin1(x))
        return self.out(self.drop(x))


class FTHead2(_MLPHead):
    """Fixed 1024/1024/512 relu head with dropout 0.1 (gat2.py:728-751)."""

    def __init__(self, in_dim: int, n_classes: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, [1024, 1024, 512, n_classes], 0.1, "relu",
                         generator)


class FTHead3(_MLPHead):
    """h1–h4 + activation choice (gat2.py:678-725) — the production head."""

    def __init__(self, in_dim: int, h1: int = 128, h2: int = 1024,
                 h3: int = 1024, h4: int = 512, drop_ratio: float = 0.2,
                 n_classes: int = 1, act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, [h1, h2, h3, h4, n_classes], drop_ratio,
                         act, generator)


class FTHead4(nn.Module):
    """Single hidden layer + activation choice (gat2.py:640-675)."""

    def __init__(self, in_dim: int, h1: int = 128, act: str = "relu",
                 n_classes: int = 1, drop_ratio: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop = nn.Dropout(drop_ratio)
        self.act = make_activation(act)
        self.dense = _dense(in_dim, h1, generator)
        self.out_proj = _dense(h1, n_classes, generator)

    def forward(self, x):
        x = self.act(self.dense(self.drop(x)))
        return self.out_proj(self.drop(x))


class FTHead5(_MLPHead):
    """h1, h2 two-hidden-layer variant (gat2.py:591-637)."""

    def __init__(self, in_dim: int, h1: int = 128, h2: int = 1024,
                 drop_ratio: float = 0.2, n_classes: int = 1,
                 act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, [h1, h2, n_classes], drop_ratio, act,
                         generator)


FTHEADS = {
    "FTHead1": FTHead1,
    "FTHead2": FTHead2,
    "FTHead3": FTHead3,
    "FTHead4": FTHead4,
    "FTHead5": FTHead5,
}


class _HalvingMLP(nn.ModuleList):
    """dim_in → dim_in/2 → ... → dim_out ladder used by each PretrainTask
    sub-head (pretrain_heads.py:27-57); the Linear layers are its entries,
    so their names are the reference's ``{k}.weight``/``{k}.bias``.
    ``pre_activation``: the bond-length head activates before each linear."""

    def __init__(self, dim_in: int, dim_out: int = 1, L: int = 2,
                 pre_activation: bool = False,
                 generator: Optional[torch.Generator] = None):
        widths = [dim_in] + [dim_in // 2 ** (l + 1) for l in range(L)]
        super().__init__([_dense(widths[l], widths[l + 1], generator)
                          for l in range(L)]
                         + [_dense(widths[L], dim_out, generator)])
        self.pre_activation = pre_activation

    def forward(self, x):
        *hidden, last = self  # (slicing a ModuleList calls __init__)
        if self.pre_activation:
            for lin in hidden:
                x = lin(F.relu(x))
            return last(F.relu(x))
        for lin in hidden:
            x = F.relu(lin(x))
        return last(x)


class PretrainTask(nn.Module):
    """UniMol-style geometric pretraining head (pretrain_heads.py:8-102):
    bond-length head on [h_src ‖ h_dst ‖ e], bond-angle head on atoms,
    dihedral head on edges, graph-level energy head on the pooled concat.
    Returns (bond length (E, 1), bond angle (A, 1), dihedral (E, 1),
    energy (G, 1))."""

    def __init__(self, dim_in: int = 128, dim_out: int = 1, L: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.bl_reduce_layer = _dense(3 * dim_in, dim_in, g)
        self.bl_layers = _HalvingMLP(dim_in, dim_out, L, True, g)
        self.ba_layers = _HalvingMLP(dim_in, dim_out, L, generator=g)
        self.da_layers = _HalvingMLP(dim_in, dim_out, L, generator=g)
        self.FC_layers = _HalvingMLP(2 * dim_in, dim_out, L, generator=g)

    @obs.spanned("fragnet.model.head")
    def forward(self, x_atoms, x_frags, edge_attr, batch):
        # a bf16 encoder's outputs widened: the Linears' f32 parameters
        # promote them, as flax's Dense(dtype=None) does
        x_atoms, x_frags, edge_attr = (x.float() for x in
                                       (x_atoms, x_frags, edge_attr))
        # index_select, not x[idx]: its backward is one index_add_, where
        # advanced indexing's is a sorting scatter (8.7 of 16.3 ms of device
        # time in a batch-512 step on the H100, chip_smoke.py)
        pair = torch.cat([x_atoms.index_select(0, batch.edge_src),
                          x_atoms.index_select(0, batch.edge_dst),
                          edge_attr], dim=1)
        bl = self.bl_layers(self.bl_reduce_layer(pair))
        ba = self.ba_layers(x_atoms)
        da = self.da_layers(edge_attr)
        energy = self.FC_layers(pool_graphs(x_atoms, x_frags, batch))
        return bl, ba, da, energy
