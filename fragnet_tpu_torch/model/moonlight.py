"""The Moonlight-16B-A3B block (DeepSeek-V3's, at width 2048) as a protein
tower for DTA: ``MoonlightTower`` reads integer-encoded residues (B, L), id
0 padding after each sequence, and returns the masked mean of its last
normalized hidden states over the real residues (B, hidden_size).

Source: https://huggingface.co/moonshotai/Moonlight-16B-A3B (config.json;
model_type deepseek_v3, whose modeling code the layers follow):

* ``embed_tokens``, then each decoder layer ``x += o_proj(MLA(
  input_layernorm(x)))``, ``x += MLP(post_attention_layernorm(x))``, then
  ``norm``; RMSNorm with eps ``rms_norm_eps``.
* MLA without a q LoRA: ``q = q_proj(h)`` per head [nope | rope];
  ``kv_a_proj_with_mqa(h)`` = [c_kv | k_pe], k_pe shared by the heads;
  ``kv_b_proj(kv_a_layernorm(c_kv))`` per head [k_nope | v]; RoPE (θ =
  ``rope_theta``, positions 0..L−1, no scaling) on the rope halves after
  de-interleaving their (2i, 2i+1) pairs, as the published
  ``apply_rotary_pos_emb`` does, then ``rotate_half``; logits ·
  (nope + rope)^−½, causal, softmax, no dropout.
* The first ``first_k_dense_replace`` layers' MLP is a dense SwiGLU
  (``intermediate_size``); the others are ``MoE``: a sigmoid router over
  ``n_routed_experts`` that chooses ``num_experts_per_tok`` by score +
  ``e_score_correction_bias`` (``noaux_tc`` with one group), weights the
  chosen scores normalized to sum 1 (+ 1e−20) times
  ``routed_scaling_factor``, SwiGLU experts of ``moe_intermediate_size``
  and ``n_shared_experts`` shared experts as one SwiGLU of that many
  times the width. After each training forward the correction bias moves
  by ``BIAS_UPDATE_SPEED`` (noaux_tc's γ) against each expert's load, as
  DeepSeek-V3's auxiliary-loss-free balancing does.

An expert layer is told which experts it holds (``experts_held``, the
chip's share of an expert-parallel deployment): it routes every token over
all the experts and computes only its own experts' part, which, with the
shared experts, is what goes on to the next layer. Padding tokens are
routed nowhere. The routing's data movement is ``ops/moe.py``; the expert
matrix products are f32 ``torch.mm`` on each held expert's contiguous
slice of the sorted rows, the one read-back of the experts' row counts a
layer cutting the slices. MLA is torch ops. Parameter names follow the
published checkpoint's (``layers.{i}.self_attn.q_proj``,
``layers.{i}.mlp.experts.{e}.gate_proj``, ...).

Departures from the published model, for a protein tower: the vocabulary
is the 25 residue letters and the padding id (no text tokens, no LM
head); the output is the masked mean; the correction bias's update speed
γ is not in the config and counts this card's tokens
(``BIAS_UPDATE_SPEED`` says why it is 30 times DeepSeek-V3's); there is
no sequence-level auxiliary loss (its weight is not in the config
either); the router's top-k comes sorted by biased score, so the combine
sums a token's experts in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.ops import moe as moe_ops


# noaux_tc's γ: 30 times DeepSeek-V3's 0.001 (arXiv:2412.19437; not in
# config.json). On a randomly initialised tower, whose routes Adam moves
# faster than a trained one's, 0.001 let the 8 held experts' share of the
# tokens drift from 0.8x to 1.4x in 25 steps, and the step time with it;
# biases balanced once and then held spread the step time 0.6% by seed.
BIAS_UPDATE_SPEED = 0.03

# config.json's keys whose published value is the only one this tower
# implements, and the γ above; a configuration that sets another is refused
FIXED = {"q_lora_rank": None, "rope_scaling": None, "scoring_func": "sigmoid",
         "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
         "norm_topk_prob": True, "attention_bias": False, "hidden_act": "silu",
         "moe_layer_freq": 1, "bias_update_speed": BIAS_UPDATE_SPEED}


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """The tower's sizes, under config.json's keys; the defaults are the
    published ones, with the residue vocabulary and every expert held.
    ``experts_held``: a count n (experts 0..n−1) or the ids held."""

    vocab_size: int = 26
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    experts_held: Union[int, Tuple[int, ...], None] = None

    @classmethod
    def from_dict(cls, d) -> "MoonlightConfig":
        """The keys of ``d`` this class knows; raises where a key of
        ``FIXED`` has another value (config.json's other keys say nothing
        of the tower's shape and are left out)."""
        d = dict(d)
        other = {k: d[k] for k in FIXED if k in d and d[k] != FIXED[k]}
        if other:
            raise ValueError(f"MoonlightTower does not implement {other}")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if isinstance(kw.get("experts_held"), (list, tuple)):
            kw["experts_held"] = tuple(int(e) for e in kw["experts_held"])
        return cls(**kw)

    @property
    def held(self) -> Tuple[int, ...]:
        h = self.experts_held
        if h is None:
            return tuple(range(self.n_routed_experts))
        if isinstance(h, int):
            return tuple(range(h))
        return tuple(h)

    def check(self) -> None:
        """Raise on sizes this tower cannot run."""
        held = self.held
        if len(set(held)) != len(held) or not held or any(
                not 0 <= e < self.n_routed_experts for e in held):
            raise ValueError(f"experts_held {self.experts_held!r}: distinct "
                             f"ids in [0, {self.n_routed_experts})")
        if not 1 <= self.num_experts_per_tok <= min(moe_ops.MAX_K,
                                                     self.n_routed_experts):
            raise ValueError(f"num_experts_per_tok "
                             f"{self.num_experts_per_tok}: 1 to "
                             f"{moe_ops.MAX_K}")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")


def _linear(d_in: int, d_out: int, generator) -> nn.Linear:
    """A bias-free Linear drawn from normal(0, 0.02) (the published
    initializer_range)."""
    lin = nn.Linear(d_in, d_out, bias=False)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=generator)
    return lin


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps))


def rope_tables(L: int, dim: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (L, dim) of positions 0..L−1, each frequency twice
    ([f | f]), in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.float32) / dim))
    t = torch.arange(L, device=device, dtype=torch.float32)
    emb = torch.cat([torch.outer(t, inv)] * 2, dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., L, d): the (2i, 2i+1) pairs de-interleaved into halves,
    then x·cos + rotate_half(x)·sin."""
    *lead, L, d = x.shape
    x = x.reshape(*lead, L, d // 2, 2).transpose(-1, -2).reshape(*lead, L, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


class MLA(nn.Module):
    """Multi-head latent attention without a q LoRA."""

    def __init__(self, c: MoonlightConfig, generator):
        super().__init__()
        H = c.num_attention_heads
        self.H, self.nope, self.rope = H, c.qk_nope_head_dim, c.qk_rope_head_dim
        self.v_dim, self.kv_rank = c.v_head_dim, c.kv_lora_rank
        self.scale = (self.nope + self.rope) ** -0.5
        D = c.hidden_size
        self.q_proj = _linear(D, H * (self.nope + self.rope), generator)
        self.kv_a_proj_with_mqa = _linear(D, self.kv_rank + self.rope,
                                          generator)
        self.kv_a_layernorm = RMSNorm(self.kv_rank, c.rms_norm_eps)
        self.kv_b_proj = _linear(self.kv_rank, H * (self.nope + self.v_dim),
                                 generator)
        self.o_proj = _linear(H * self.v_dim, D, generator)

    def forward(self, h, cos, sin, future):
        """h (B, L, D); ``future`` (L, L) bool, True above the diagonal."""
        B, L, _ = h.shape
        H = self.H
        q = self.q_proj(h).view(B, L, H, -1).transpose(1, 2)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(h).split(
            [self.kv_rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
            B, L, H, -1).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, None], cos, sin).expand(B, H, L, self.rope)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        s = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
        o = torch.matmul(p, v).transpose(1, 2).reshape(B, L, H * self.v_dim)
        return self.o_proj(o)


class SwiGLU(nn.Module):
    """down_proj(silu(gate_proj(x)) · up_proj(x))."""

    def __init__(self, d: int, inner: int, generator):
        super().__init__()
        self.gate_proj = _linear(d, inner, generator)
        self.up_proj = _linear(d, inner, generator)
        self.down_proj = _linear(inner, d, generator)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEGate(nn.Module):
    """The sigmoid router: (idx (T, K) chosen experts, sorted by score +
    bias; w (T, K) their weights)."""

    def __init__(self, c: MoonlightConfig, generator):
        super().__init__()
        self.top_k = c.num_experts_per_tok
        self.scaling = c.routed_scaling_factor
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts,
                                               c.hidden_size))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
        # moved by MoE.balance after each training forward, not by gradients
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(c.n_routed_experts))

    def forward(self, h):
        scores = torch.sigmoid(F.linear(h, self.weight))
        idx = torch.topk(scores.detach() + self.e_score_correction_bias,
                         self.top_k, dim=-1).indices
        w = scores.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.scaling


class MoE(nn.Module):
    """The expert layer of one chip: the router over every expert, the
    held experts' part of the routed output, and the shared experts."""

    def __init__(self, c: MoonlightConfig, generator):
        super().__init__()
        self.held = c.held
        self.gate = MoEGate(c, generator)
        self.experts = nn.ModuleDict({
            str(e): SwiGLU(c.hidden_size, c.moe_intermediate_size, generator)
            for e in self.held})
        self.shared_experts = SwiGLU(
            c.hidden_size, c.moe_intermediate_size * c.n_shared_experts,
            generator)
        local_of = torch.full((c.n_routed_experts,), -1, dtype=torch.long)
        local_of[list(self.held)] = torch.arange(len(self.held))
        self.register_buffer("local_of", local_of, persistent=False)

    def balance(self, idx, real) -> None:
        """noaux_tc's balancing: each expert's correction bias stepped by γ
        against the sign of its load over the real tokens' choices ``idx``
        (T, K) less the mean load. On the device, no read-back (a float
        scatter of whole counts, exact in any order)."""
        load = torch.zeros(self.gate.weight.shape[0], device=idx.device)
        load.scatter_add_(0, idx.reshape(-1),
                          real.to(load.dtype).repeat_interleave(idx.shape[1]))
        self.gate.e_score_correction_bias.sub_(
            BIAS_UPDATE_SPEED * torch.sign(load - load.mean()))

    def routed(self, h, real):
        """The held experts' weighted part (T, D) for h (T, D) and the
        real-token mask (T,). In training, the correction bias is then
        balanced on this forward's loads, for the next."""
        with obs.span("fragnet.protein.moe.route"):
            idx, w = self.gate(h)
            if self.training:
                with torch.no_grad():
                    self.balance(idx, real)
            r = moe_ops.plan_routes(idx, self.local_of, len(self.held), real)
            A = len(r.tok)
            obs.count("fragnet.protein.moe.rows", h.shape[0])
            obs.count("fragnet.protein.moe.assignments", A)
            obs.count("fragnet.protein.moe.tokens_held", r.tokens_held)
            obs.count("fragnet.protein.moe.load_max", max(r.counts))
            obs.count("fragnet.protein.moe.load_mean", A / len(self.held))
            obs.count("fragnet.protein.moe.readbacks", 1)
            xs = moe_ops.dispatch(h, r.tok, r.pos)
        with obs.span("fragnet.protein.moe.experts"):
            ys = torch.cat([self.experts[str(e)](x) for e, x in
                            zip(self.held, xs.split(r.counts))])
        with obs.span("fragnet.protein.moe.combine"):
            return moe_ops.combine(ys, w, r.pos)

    def forward(self, x, real):
        """x (B, L, D), real (B, L) bool → (B, L, D)."""
        B, L, D = x.shape
        h = x.reshape(B * L, D)
        out = self.routed(h, real.reshape(-1))
        with obs.span("fragnet.protein.moe.shared"):
            shared = self.shared_experts(h)
        return (out + shared).view(B, L, D)


class DecoderLayer(nn.Module):
    def __init__(self, c: MoonlightConfig, dense: bool, generator):
        super().__init__()
        self.self_attn = MLA(c, generator)
        self.dense = dense
        self.mlp = (SwiGLU(c.hidden_size, c.intermediate_size, generator)
                    if dense else MoE(c, generator))
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden_size,
                                                c.rms_norm_eps)

    def forward(self, x, real, cos, sin, future):
        with obs.span("fragnet.protein.attn"):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin, future)
        h = self.post_attention_layernorm(x)
        return x + (self.mlp(h) if self.dense else self.mlp(h, real))


class MoonlightTower(nn.Module):
    """(B, L) residue ids → (B, hidden_size): the masked mean of the last
    normalized hidden states over ``tokens != 0`` (a row with no residue
    gives zeros)."""

    def __init__(self, config: MoonlightConfig = MoonlightConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        config.check()
        self.config = c = config
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        with torch.no_grad():
            self.embed_tokens.weight.normal_(0.0, 0.02, generator=generator)
        self.layers = nn.ModuleList([
            DecoderLayer(c, i < c.first_k_dense_replace, generator)
            for i in range(c.num_hidden_layers)])
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)

    def forward(self, tokens):
        B, L = tokens.shape
        real = tokens != 0
        c = self.config
        cos, sin = rope_tables(L, c.qk_rope_head_dim, c.rope_theta,
                               tokens.device)
        future = torch.ones(L, L, dtype=torch.bool,
                            device=tokens.device).triu(1)
        x = self.embed_tokens(tokens.long())
        for layer in self.layers:
            x = layer(x, real, cos, sin, future)
        x = self.norm(x)
        m = real.unsqueeze(-1).to(x.dtype)
        return (x * m).sum(1) / m.sum(1).clamp(min=1.0)


def moe_layers(tower: MoonlightTower) -> Dict[int, MoE]:
    """The tower's expert layers by index."""
    return {i: layer.mlp for i, layer in enumerate(tower.layers)
            if not layer.dense}
