"""Drug–target affinity (DTA) models (counterpart of
fragnet_tpu/model/dta.py).

Reference: fragnet/model/dta/model.py — DTAModel (FragNet drug encoder +
BERT-style protein transformer, :83-104) and DTAModel2 (GraphDTA-style CNN
protein encoder, :107-146). Parameters use the reference torch names that
fragnet_tpu/train/checkpoint.py:import_dta_state_dict reads:
``drug_model.pretrain.*``; the transformer's ``target_model.emb.*`` and
``target_model.encoder.layer.{i}.*`` (DeepTTC's BERT layout, LayerNorms with
``gamma`` / ``beta``); the CNN's ``embedding_xt``, ``conv_xt_1`` and
``fc1_xt`` at the top level of the model; ``fc1`` / ``fc2``. A third
protein encoder, "moonlight" (``model/moonlight.py``; no counterpart in
the JAX package), is the Moonlight-16B-A3B block as a causal tower under
``target_model.*``, pooled by the masked mean over the residues: the
first row that BERT's pooling takes sees only itself under a causal mask.

The protein encoders and the heads are torch ops on every device, as the
JAX package runs them in XLA (no Pallas kernel exists for them); the drug
encoder's GAT passes take the kernels as in FragNetFineTune. The attention
is written as flax's ``MultiHeadDotProductAttention`` computes it: q / √Dh,
the logits, masked keys filled with the f32 minimum, softmax, dropout on
the weights. A padding graph's protein row is all padding, so every key is
masked: its weights come out uniform and finite, as in flax.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.model.finetune import FragNetFineTuneBase
from fragnet_tpu_torch.model.heads import _dense
from fragnet_tpu_torch.model.layers import KernelPolicy
from fragnet_tpu_torch.model.moonlight import MoonlightConfig, MoonlightTower


def _lecun_normal_(layer: nn.Module, fan_in: int,
                   generator: Optional[torch.Generator]) -> nn.Module:
    """flax's default kernel init (lecun_normal: a normal truncated at ±2σ,
    of variance 1/fan_in) for ``layer``'s weight, and a zero bias."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


def _lecun_dense(d_in: int, d_out: int,
                 generator: Optional[torch.Generator]) -> nn.Linear:
    return _lecun_normal_(nn.Linear(d_in, d_out), d_in, generator)


def _embedding(n: int, dim: int,
               generator: Optional[torch.Generator]) -> nn.Embedding:
    """An Embedding with flax's default init (normal, variance 1/dim)."""
    emb = nn.Embedding(n, dim)
    with torch.no_grad():
        emb.weight.normal_(0.0, math.sqrt(1.0 / dim), generator=generator)
    return emb


class LayerNorm(nn.Module):
    """LayerNorm with DeepTTC's parameter names ``gamma`` / ``beta``; eps
    1e-12 as in the protein transformer."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, self.gamma.shape, self.gamma, self.beta,
                            self.eps)


class _SelfAttention(nn.Module):
    """The q, k, v projections (BERT's ``attention.self``)."""

    def __init__(self, emb_dim: int, generator):
        super().__init__()
        self.query = _lecun_dense(emb_dim, emb_dim, generator)
        self.key = _lecun_dense(emb_dim, emb_dim, generator)
        self.value = _lecun_dense(emb_dim, emb_dim, generator)


class _DenseNorm(nn.Module):
    """A Linear then a LayerNorm of the residual sum (BERT's
    ``attention.output`` and ``output``)."""

    def __init__(self, dense: nn.Linear):
        super().__init__()
        self.dense = dense
        self.LayerNorm = LayerNorm(dense.out_features)


class _Attention(nn.Module):
    def __init__(self, emb_dim: int, generator):
        super().__init__()
        self.self = _SelfAttention(emb_dim, generator)
        self.output = _DenseNorm(_lecun_dense(emb_dim, emb_dim, generator))


class _Intermediate(nn.Module):
    def __init__(self, emb_dim: int, intermediate: int, generator):
        super().__init__()
        self.dense = _dense(emb_dim, intermediate, generator)


class _EncoderLayer(nn.Module):
    """One BERT encoder block (fragnet_tpu/model/dta.py:_EncoderLayer):
    attention, dropout, residual, LayerNorm; the ReLU feed-forward,
    dropout, residual, LayerNorm."""

    def __init__(self, emb_dim: int, n_heads: int, intermediate: int,
                 dropout: float, generator=None):
        super().__init__()
        if emb_dim % n_heads:
            raise ValueError(f"emb_dim {emb_dim} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads = n_heads
        self.attention = _Attention(emb_dim, generator)
        self.intermediate = _Intermediate(emb_dim, intermediate, generator)
        self.output = _DenseNorm(_dense(intermediate, emb_dim, generator))
        self.attn_drop = nn.Dropout(dropout)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, key_mask):
        """x (B, L, E); key_mask (B, L) bool, True at real positions."""
        B, L, E = x.shape
        H = self.n_heads
        Dh = E // H
        sa = self.attention.self
        q = sa.query(x).view(B, L, H, Dh) / math.sqrt(Dh)
        k = sa.key(x).view(B, L, H, Dh)
        v = sa.value(x).view(B, L, H, Dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~key_mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
        w = self.attn_drop(torch.softmax(logits, dim=-1))
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, E)
        out = self.attention.output
        x = out.LayerNorm(x + self.drop(out.dense(a)))
        h = torch.relu(self.intermediate.dense(x))
        out = self.output
        return out.LayerNorm(x + self.drop(out.dense(h)))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, emb_dim: int, max_len: int,
                 dropout: float, generator):
        super().__init__()
        self.word_embeddings = _embedding(vocab_size, emb_dim, generator)
        self.position_embeddings = _embedding(max_len, emb_dim, generator)
        self.LayerNorm = LayerNorm(emb_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.word_embeddings(tokens) + self.position_embeddings(pos)[None]
        return self.dropout(self.LayerNorm(x))


class _Encoder(nn.Module):
    def __init__(self, n_layers: int, emb_dim: int, n_heads: int,
                 intermediate: int, dropout: float, generator):
        super().__init__()
        self.layer = nn.ModuleList([
            _EncoderLayer(emb_dim, n_heads, intermediate, dropout, generator)
            for _ in range(n_layers)])


class ProteinTransformer(nn.Module):
    """BERT-style encoder over integer-encoded protein sequences (B, L);
    returns the first residue's row (B, emb) (dta/model.py:50-81). The key
    mask is ``tokens != 0``; query rows are not masked. The JAX module
    scans one layer over depth; here the layers are an ``nn.ModuleList``."""

    def __init__(self, vocab_size: int = 26, emb_dim: int = 128,
                 n_layers: int = 8, n_heads: int = 8,
                 intermediate: int = 512, max_len: int = 1000,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb = _Embeddings(vocab_size, emb_dim, max_len, dropout,
                               generator)
        self.encoder = _Encoder(n_layers, emb_dim, n_heads, intermediate,
                                dropout, generator)

    def forward(self, tokens):
        key_mask = tokens != 0
        x = self.emb(tokens)
        for layer in self.encoder.layer:
            x = layer(x, key_mask)
        return x[:, 0]


def protein_cnn(tokens, embedding_xt, conv_xt_1, fc1_xt):
    """GraphDTA's protein CNN (dta/model.py:107-146): embed (B, L, emb),
    convolve over the embedding axis with the L positions as input
    channels (B, n_filters, emb − k + 1), flatten in that order, project."""
    x = conv_xt_1(embedding_xt(tokens))
    return fc1_xt(x.reshape(x.shape[0], -1))


def _cnn_modules(vocab_size, emb_dim, seq_len, n_filters, kernel_size,
                 out_dim, generator):
    conv = _lecun_normal_(nn.Conv1d(seq_len, n_filters, kernel_size),
                          seq_len * kernel_size, generator)
    return (_embedding(vocab_size, emb_dim, generator), conv,
            _dense(n_filters * (emb_dim - kernel_size + 1), out_dim,
                   generator))


class ProteinCNN(nn.Module):
    """GraphDTA-style protein CNN over (B, seq_len) tokens; ``seq_len`` is
    the Conv1d's input channels (the JAX module infers it from its
    input)."""

    def __init__(self, vocab_size: int = 26, emb_dim: int = 300,
                 seq_len: int = 1000, n_filters: int = 32,
                 kernel_size: int = 8, out_dim: int = 300,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_xt, self.conv_xt_1, self.fc1_xt = _cnn_modules(
            vocab_size, emb_dim, seq_len, n_filters, kernel_size, out_dim,
            generator)

    def forward(self, tokens):
        return protein_cnn(tokens, self.embedding_xt, self.conv_xt_1,
                           self.fc1_xt)


class DTAModel(nn.Module):
    """FragNet drug encoder + protein encoder → concat → fc1 → fc2
    (dta/model.py:83-104). ``protein_encoder`` "transformer" (DTAModel;
    width 128), "cnn" (DTAModel2; width 300, its modules at the top
    level of the model, as the reference keeps them) or "moonlight"
    (``MoonlightTower`` of the ``moonlight`` config; width hidden_size)."""

    def __init__(self, num_layer: int = 4, num_heads: int = 4,
                 drop_ratio: float = 0.15, emb_dim: int = 128,
                 atom_features: int = 167, frag_features: int = 167,
                 edge_features: int = 17, fedge_in: int = 6,
                 fbond_edge_in: int = 6,
                 protein_encoder: str = "transformer",
                 protein_vocab_size: int = 26, protein_layers: int = 8,
                 protein_heads: int = 8, protein_intermediate: int = 512,
                 protein_max_len: int = 1000,
                 moonlight: Optional[MoonlightConfig] = None,
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
        self.protein_encoder = protein_encoder
        if protein_encoder == "transformer":
            self.target_model = ProteinTransformer(
                vocab_size=protein_vocab_size, emb_dim=128,
                n_layers=protein_layers, n_heads=protein_heads,
                intermediate=protein_intermediate, max_len=protein_max_len,
                generator=g)
            target_dim = 128
        elif protein_encoder == "cnn":
            self.embedding_xt, self.conv_xt_1, self.fc1_xt = _cnn_modules(
                26, 300, protein_max_len, 32, 8, 300, g)
            target_dim = 300
        elif protein_encoder == "moonlight":
            self.target_model = MoonlightTower(moonlight or MoonlightConfig(),
                                               generator=g)
            target_dim = self.target_model.config.hidden_size
        else:
            raise ValueError(f"unknown protein_encoder {protein_encoder!r} "
                             f"(transformer|cnn|moonlight)")
        self.fc1 = _dense(2 * emb_dim + target_dim, 128, g)
        self.fc2 = _dense(128, 1, g)

    @obs.spanned("fragnet.model.protein")
    def encode_target(self, tokens):
        if self.protein_encoder in ("transformer", "moonlight"):
            return self.target_model(tokens)
        return protein_cnn(tokens, self.embedding_xt, self.conv_xt_1,
                           self.fc1_xt)

    def forward(self, batch):
        with obs.span("fragnet.model.drug"):
            drug_enc = self.drug_model.encode(batch)
        target = self.encode_target(batch.protein)
        with obs.span("fragnet.model.head"):
            return self.fc2(self.fc1(torch.cat([drug_enc, target], dim=1)))
