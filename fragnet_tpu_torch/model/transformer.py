"""The finetune models on the gat2 encoder with transformer post-processing
(reference gat2.py:832-1106); counterpart of fragnet_tpu/model/transformer.py.

* ``TransformerConv`` (PyG ``TransformerConv``: heads concatenated, root
  skip, no edge attributes): a query·key logit per edge, a segment softmax
  over each edge's target, a segment sum of the weighted values.
* ``MultiheadAttention``: the flat node batch is scattered into a dense
  (G, S, 3·emb) layout per molecule (``_dense_mol_layout``), attention runs
  as two batched matmuls under a key-validity mask, and the result is
  gathered back to the flat layout.
* ``EncoderBlock`` / ``TransformerEncoder`` (post-norm) and the models
  ``FragNetFineTuneTransformer``, ``FragNetFineTuneTransformer2`` and
  ``FragNetFineTuneMultiTask``.

On every device these run as torch ops (ops/segment.py, ``torch.einsum``),
as the JAX package runs them in XLA: the JAX package has no Pallas kernel
for them. The encoder's GAT passes take the kernels as in FragNetFineTune.
``dtype`` (f32 or bf16) is the encoder's compute type; the post-processing
runs in the promoted type, f32, as the JAX modules' Dense layers (dtype
None, f32 parameters) promote a bf16 input.
Parameters use the reference torch names (``lin_query``, ``qkv_proj``,
``norm1``, ``linear_net.0``, ``ms_heads.{i}``, ...) and are drawn from
``generator`` on the CPU, each with the JAX package's initializer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from fragnet_tpu_torch.model.fragnet import FragNet
from fragnet_tpu_torch.model.heads import _dense, pool_graphs
from fragnet_tpu_torch.model.layers import KernelPolicy, xavier_gain_
from fragnet_tpu_torch.ops.segment import segment_softmax, segment_sum

# a masked key's logit: exp(logit − row max) is exactly 0 in f32 for any
# row with a valid key, as with −inf, and a row with none stays finite
# (uniform, then zeroed), so its backward is finite too
_MASKED_LOGIT = -1e9


def _xavier_dense(d_in: int, d_out: int,
                  generator: Optional[torch.Generator]) -> nn.Linear:
    """A Linear with the JAX package's ``xavier_uniform`` kernel init
    (xavier gain 1) and zero bias: MultiheadAttention's projections."""
    lin = nn.Linear(d_in, d_out)
    xavier_gain_(lin.weight, d_in, d_out, generator, gain=1.0)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class TransformerConv(nn.Module):
    """PyG-semantics graph transformer convolution (heads concatenated,
    root skip): out_i = W_skip x_i + Σ_j softmax_j((W_q x_i · W_k x_j)/√D)
    W_v x_j over the unmasked edges j → i, zero on masked nodes."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        width = heads * out_channels
        self.lin_query = _dense(in_channels, width, generator)
        self.lin_key = _dense(in_channels, width, generator)
        self.lin_value = _dense(in_channels, width, generator)
        self.lin_skip = _dense(in_channels, width, generator)

    def forward(self, x, src, dst, edge_mask, node_mask):
        H, D = self.heads, self.out_channels
        N = x.shape[0]
        q = self.lin_query(x).view(N, H, D)
        k = self.lin_key(x).view(N, H, D)
        v = self.lin_value(x).view(N, H, D)
        # index_select: its backward is one index_add_ (model/heads.py)
        v_src = v.index_select(0, src)
        logits = (q.index_select(0, dst) * k.index_select(0, src)).sum(-1) \
            / math.sqrt(D)  # (E, H)
        probs = segment_softmax(logits, dst, N, mask=edge_mask)
        agg = segment_sum(probs[..., None] * v_src, dst, N).view(N, H * D)
        return (self.lin_skip(x) + agg) * node_mask[:, None]


def _dense_mol_layout(batch_ids, node_mask, num_graphs: int, seq_len: int):
    """Each node's slot in a (G, S, ...) layout: (graph id, position,
    valid). A molecule's real nodes are contiguous and in graph order
    (padding rows may lie between molecules, as in tile-aligned batches),
    so a node's position is the count of real nodes before it less its
    molecule's first. Padded nodes and nodes past ``seq_len`` are not
    valid and go to the overflow row G, position clipped into [0, S)."""
    real = (node_mask > 0).long()
    g = torch.where(real > 0, batch_ids.long(),
                    torch.full_like(real, num_graphs))
    counts = real.new_zeros(num_graphs + 1).index_add_(0, g, real)
    starts = torch.cumsum(counts, 0) - counts
    prefix = torch.cumsum(real, 0) - real  # real nodes before each node
    pos = prefix - starts[g]
    valid = (real > 0) & (pos < seq_len)
    g = torch.where(valid, g, torch.full_like(g, num_graphs))
    return g, pos.clamp(0, seq_len - 1), valid


class MultiheadAttention(nn.Module):
    """Per-molecule dense self-attention (gat2.py:926-986): the flat batch
    scattered into (G + 1, S, 3·emb) — row G takes the nodes that are not
    valid and is dropped — then batched matmuls with a key-validity
    mask. A molecule with no valid node (a padding graph) gets zero
    attention and zero values."""

    def __init__(self, input_dim: int = 128, embed_dim: int = 128,
                 num_heads: int = 8, max_seq_len: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.max_seq_len = max_seq_len
        self.qkv_proj = _xavier_dense(input_dim, 3 * embed_dim, generator)
        self.o_proj = _xavier_dense(embed_dim, embed_dim, generator)

    def forward(self, x, batch_ids, node_mask, num_graphs: int):
        H, E, S, G = (self.num_heads, self.embed_dim, self.max_seq_len,
                      num_graphs)
        Dh = E // H
        qkv = self.qkv_proj(x)  # (N, 3E)
        g, pos, valid = _dense_mol_layout(batch_ids, node_mask, G, S)
        slot = g * S + pos  # unique for valid nodes; the rest in row G
        vmask = valid.to(qkv.dtype)
        dense = qkv.new_zeros(((G + 1) * S, 3 * E)).index_copy(
            0, slot, qkv * vmask[:, None])
        key_mask = vmask.new_zeros((G + 1) * S).index_copy(
            0, slot, vmask)[:G * S].view(G, 1, 1, S) > 0
        qkv_h = dense[:G * S].view(G, S, H, 3 * Dh).transpose(1, 2)
        q, k, v = qkv_h.split(Dh, dim=-1)  # (G, H, S, Dh)
        logits = torch.einsum("ghsd,ghtd->ghst", q, k) * Dh ** -0.5
        attn = torch.softmax(logits.masked_fill(~key_mask, _MASKED_LOGIT),
                             dim=-1)
        attn = attn.masked_fill(~key_mask, 0.0)
        vals = torch.einsum("ghst,ghtd->ghsd", attn, v)
        vals = vals.transpose(1, 2).reshape(G * S, E)
        # back to the flat layout; nodes that are not valid get zeros
        flat = vals.index_select(0, g.clamp(max=G - 1) * S + pos) \
            * vmask[:, None]
        return self.o_proj(flat) * node_mask[:, None]


class EncoderBlock(nn.Module):
    """Post-norm transformer block (gat2.py:989-1028): attention, residual,
    norm1, the feed-forward ``linear_net`` (Linear, Dropout, ReLU, Linear),
    residual, norm2. LayerNorm eps is 1e-6, flax's default, which the JAX
    package uses (torch's default is 1e-5)."""

    def __init__(self, input_dim: int = 128, num_heads: int = 8,
                 dim_feedforward: int = 256, dropout: float = 0.0,
                 max_seq_len: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(input_dim, input_dim, num_heads,
                                            max_seq_len, generator)
        self.linear_net = nn.Sequential(
            _dense(input_dim, dim_feedforward, generator),
            nn.Dropout(dropout), nn.ReLU(),
            _dense(dim_feedforward, input_dim, generator))
        self.norm1 = nn.LayerNorm(input_dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(input_dim, eps=1e-6)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, batch_ids, node_mask, num_graphs: int):
        x = self.norm1(x + self.dropout(
            self.self_attn(x, batch_ids, node_mask, num_graphs)))
        x = self.norm2(x + self.dropout(self.linear_net(x)))
        return x * node_mask[:, None]


class TransformerEncoder(nn.Module):
    """A stack of EncoderBlocks (gat2.py:1031-1045)."""

    def __init__(self, num_layers: int = 6, input_dim: int = 128,
                 num_heads: int = 8, dim_feedforward: int = 256,
                 dropout: float = 0.0, max_seq_len: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList([
            EncoderBlock(input_dim, num_heads, dim_feedforward, dropout,
                         max_seq_len, generator)
            for _ in range(num_layers)])

    def forward(self, x, batch_ids, node_mask, num_graphs: int):
        for layer in self.layers:
            x = layer(x, batch_ids, node_mask, num_graphs)
        return x


def _encoder(num_layer, drop_ratio, num_heads, emb_dim, atom_features,
             frag_features, edge_features, fedge_in, fbond_edge_in, policy,
             generator, dtype) -> FragNet:
    return FragNet(num_layer=num_layer, drop_ratio=drop_ratio,
                   emb_dim=emb_dim, atom_features=atom_features,
                   frag_features=frag_features, edge_features=edge_features,
                   fedge_in=fedge_in, fbond_edge_in=fbond_edge_in,
                   num_heads=num_heads, policy=policy, generator=generator,
                   dtype=dtype)


def _promoted(*xs):
    """The encoder's outputs in the type a Dense with f32 parameters
    promotes them to (f32), where the post-processing runs."""
    return tuple(x.to(torch.promote_types(x.dtype, torch.float32))
                 for x in xs)


class FragNetFineTuneTransformer(nn.Module):
    """FragNet encoder + TransformerConv post-processing + lin1/out
    (gat2.py:832-890). The reference applies ``atom_transformer`` to both
    levels (gat2.py:877-878): with ``compat_shared_transformer`` (the
    default) ``frag_transformer``'s parameters exist for the checkpoint's
    names and are not computed; without it the fragment level uses them."""

    def __init__(self, n_classes: int = 1, num_layer: int = 4,
                 drop_ratio: float = 0.15, h1: int = 256, num_heads: int = 4,
                 emb_dim: int = 128, transformer_heads: int = 1,
                 atom_features: int = 167, frag_features: int = 167,
                 edge_features: int = 17, fedge_in: int = 6,
                 fbond_edge_in: int = 6,
                 compat_shared_transformer: bool = True,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = generator
        self.pretrain = _encoder(num_layer, drop_ratio, num_heads, emb_dim,
                                 atom_features, frag_features, edge_features,
                                 fedge_in, fbond_edge_in, policy, g, dtype)
        self.atom_transformer = TransformerConv(emb_dim, emb_dim,
                                                transformer_heads, g)
        self.frag_transformer = TransformerConv(emb_dim, emb_dim,
                                                transformer_heads, g)
        self.lin1 = _dense(2 * transformer_heads * emb_dim, h1, g)
        self.out = _dense(h1, n_classes, g)
        self.dropout = nn.Dropout(drop_ratio)
        self.compat_shared_transformer = compat_shared_transformer

    def forward(self, batch):
        x_atoms, x_frags = _promoted(*self.pretrain(batch)[:2])
        x_atoms = self.atom_transformer(x_atoms, batch.edge_src,
                                        batch.edge_dst, batch.edge_mask,
                                        batch.atom_mask)
        frag_conv = (self.atom_transformer if self.compat_shared_transformer
                     else self.frag_transformer)
        x_frags = frag_conv(x_frags, batch.frag_src, batch.frag_dst,
                            batch.fconn_mask, batch.frag_mask)
        x = self.dropout(pool_graphs(x_atoms, x_frags, batch))
        x = self.dropout(torch.relu(self.lin1(x)))
        return self.out(x).float()


class FragNetFineTuneTransformer2(nn.Module):
    """FragNet encoder + a dense per-molecule TransformerEncoder on each of
    the atom and fragment levels + lin1/out (gat2.py:1048-1106)."""

    def __init__(self, n_classes: int = 1, num_layer: int = 4,
                 drop_ratio: float = 0.15, h1: int = 256, num_heads: int = 4,
                 emb_dim: int = 128, num_attn_layer2: int = 6,
                 num_attn_heads2: int = 4, drop_ratio2: float = 0.3,
                 max_seq_len: int = 64, atom_features: int = 167,
                 frag_features: int = 167, edge_features: int = 17,
                 fedge_in: int = 6, fbond_edge_in: int = 6,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = generator
        self.pretrain = _encoder(num_layer, drop_ratio, num_heads, emb_dim,
                                 atom_features, frag_features, edge_features,
                                 fedge_in, fbond_edge_in, policy, g, dtype)
        kw = dict(num_layers=num_attn_layer2, input_dim=emb_dim,
                  num_heads=num_attn_heads2, dim_feedforward=2 * emb_dim,
                  dropout=drop_ratio2, max_seq_len=max_seq_len, generator=g)
        self.transformer = TransformerEncoder(**kw)
        self.transformer2 = TransformerEncoder(**kw)
        self.lin1 = _dense(2 * emb_dim, h1, g)
        self.out = _dense(h1, n_classes, g)
        self.dropout = nn.Dropout(drop_ratio)

    def forward(self, batch):
        x_atoms, x_frags = _promoted(*self.pretrain(batch)[:2])
        G = batch.y.shape[0]
        x_atoms = self.transformer(x_atoms, batch.atom_batch,
                                   batch.atom_mask, G)
        x_frags = self.transformer2(x_frags, batch.frag_batch,
                                    batch.frag_mask, G)
        x = self.dropout(pool_graphs(x_atoms, x_frags, batch))
        x = self.dropout(torch.relu(self.lin1(x)))
        return self.out(x).float()


class FragNetFineTuneMultiTask(nn.Module):
    """FragNet encoder + a shared trunk (dropout, lin1 2·emb → 2·emb, ReLU,
    dropout) + one Linear head per task (gat2.py:893-923; the reference's
    forward names a trunk its base never defines, and the JAX package
    builds the evident one, as here). Returns (G, n_tasks · n_classes):
    with n_classes 1 the masked multi-task losses' layout (the JAX
    package's ``flatten_output=True``, the form it trains)."""

    def __init__(self, n_classes: int = 1, n_multi_task_heads: int = 2,
                 num_layer: int = 4, num_heads: int = 4,
                 drop_ratio: float = 0.15, emb_dim: int = 128,
                 atom_features: int = 167, frag_features: int = 167,
                 edge_features: int = 17, fedge_in: int = 6,
                 fbond_edge_in: int = 6,
                 policy: KernelPolicy = KernelPolicy(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = generator
        self.pretrain = _encoder(num_layer, drop_ratio, num_heads, emb_dim,
                                 atom_features, frag_features, edge_features,
                                 fedge_in, fbond_edge_in, policy, g, dtype)
        self.lin1 = _dense(2 * emb_dim, 2 * emb_dim, g)
        self.ms_heads = nn.ModuleList([
            _dense(2 * emb_dim, n_classes, g)
            for _ in range(n_multi_task_heads)])
        self.dropout = nn.Dropout(drop_ratio)

    def forward(self, batch):
        x_atoms, x_frags, _, _ = self.pretrain(batch)
        x = self.dropout(pool_graphs(x_atoms, x_frags, batch))
        x = self.dropout(torch.relu(self.lin1(x)))
        return torch.cat([h(x) for h in self.ms_heads], dim=1).float()
