"""Plain-torch reference of the Moonlight-16B-A3B protein tower in DTA, for
the CPU tests of ``fragnet_tpu_torch/model/moonlight.py``.

Written from the published equations (Moonlight-16B-A3B's config.json,
model_type deepseek_v3: DeepSeek-V3's RMSNorm, MLA without a q LoRA, RoPE
on de-interleaved pairs, SwiGLU, the sigmoid ``noaux_tc`` router and the
shared experts), in float32 torch operations on a dict of weights keyed
by the program's parameter names. It imports neither JAX nor anything of
the port, and runs with TF32 off (``tf32_off``).

Departures from the published model, each the program's too: the
vocabulary is the 25 residue letters and the padding id 0; there is no LM
head, the tower's output is the mean of its last normalized hidden states
over the real residues; the correction bias moves by the configuration's
γ, ``bias_update_speed`` (``balance``; γ is not in config.json); there is
no sequence-level auxiliary loss; the router's top-k is taken sorted.

The chip's share of the experts: ``held`` names the experts whose part of
each routed output is computed; the others' part is left out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(L: int, dim: int, theta: float, device):
    """cos, sin (L, dim): position t's angles t·θ^(−2i/dim), each twice."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.float32) / dim))
    ang = torch.outer(torch.arange(L, device=device, dtype=torch.float32),
                      inv)
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rotate(x, cos, sin):
    """The published apply_rotary_pos_emb on one tensor (..., L, d)."""
    *lead, L, d = x.shape
    x = x.reshape(*lead, L, d // 2, 2).transpose(-1, -2).reshape(*lead, L, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def mla(w: W, pre: str, h, c: Dict, cos, sin):
    B, L, _ = h.shape
    H = c["num_attention_heads"]
    nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    r = c["kv_lora_rank"]
    q = F.linear(h, w[f"{pre}.q_proj.weight"]).view(B, L, H, nope + rd)
    q = q.transpose(1, 2)
    kv_a = F.linear(h, w[f"{pre}.kv_a_proj_with_mqa.weight"])
    c_kv, k_pe = kv_a[..., :r], kv_a[..., r:]
    kv = F.linear(rms_norm(c_kv, w[f"{pre}.kv_a_layernorm.weight"],
                           c["rms_norm_eps"]),
                  w[f"{pre}.kv_b_proj.weight"]).view(B, L, H, nope + vd)
    kv = kv.transpose(1, 2)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], dim=-1)
    k_pe = rotate(k_pe[:, None], cos, sin).expand(B, H, L, rd)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    s = torch.matmul(q, k.transpose(-1, -2)) * (nope + rd) ** -0.5
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    o = torch.matmul(p, v).transpose(1, 2).reshape(B, L, H * vd)
    return F.linear(o, w[f"{pre}.o_proj.weight"])


def swiglu(w: W, pre: str, x):
    g = F.linear(x, w[f"{pre}.gate_proj.weight"])
    u = F.linear(x, w[f"{pre}.up_proj.weight"])
    return F.linear(F.silu(g) * u, w[f"{pre}.down_proj.weight"])


def router(w: W, bias: torch.Tensor, pre: str, h, c: Dict):
    """(idx (T, K) chosen by score + bias, sorted; their weights)."""
    s = torch.sigmoid(F.linear(h, w[f"{pre}.gate.weight"]))
    idx = torch.topk(s.detach() + bias, c["num_experts_per_tok"],
                     dim=-1).indices
    g = s.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) \
        * c["routed_scaling_factor"]


def routed(w: W, pre: str, h, real, idx, g, held: Sequence[int]):
    """The held experts' part: each expert on its tokens' rows in token
    order; then for each token its held choices in ranked order, out +=
    weight · expert(h)."""
    out = torch.zeros_like(h)
    chosen = idx.masked_fill(~real[:, None], -1)
    toks, ys = {}, {}
    for e in held:
        toks[e] = torch.nonzero((chosen == e).any(1)).view(-1)
        ys[e] = swiglu(w, f"{pre}.experts.{e}", h[toks[e]])
    for k in range(idx.shape[1]):
        for e in held:
            sel = torch.nonzero(chosen[:, k] == e).view(-1)
            at = torch.searchsorted(toks[e], sel)
            out = out.index_put((sel,), out[sel] + g[sel, k, None]
                                * ys[e][at])
    return out


def moe(w: W, bias: torch.Tensor, pre: str, x, real, c: Dict,
        held: Sequence[int]):
    """(the layer's output (B, L, D), its choices (B·L, K))."""
    B, L, D = x.shape
    h = x.reshape(B * L, D)
    r = real.reshape(-1)
    idx, g = router(w, bias, pre, h, c)
    out = routed(w, pre, h, r, idx, g, held) \
        + swiglu(w, f"{pre}.shared_experts", h)
    return out.view(B, L, D), idx


def tower(w: W, biases: W, tokens, c: Dict, held: Sequence[int],
          pre: str = "target_model") -> Tuple[torch.Tensor, List]:
    """(the masked mean (B, hidden), the choices of each expert layer)."""
    B, L = tokens.shape
    real = tokens != 0
    cos, sin = rope(L, c["qk_rope_head_dim"], c["rope_theta"], tokens.device)
    x = w[f"{pre}.embed_tokens.weight"][tokens.long()]
    eps = c["rms_norm_eps"]
    choices = []
    for i in range(c["num_hidden_layers"]):
        lp = f"{pre}.layers.{i}"
        x = x + mla(w, f"{lp}.self_attn",
                    rms_norm(x, w[f"{lp}.input_layernorm.weight"], eps), c,
                    cos, sin)
        h = rms_norm(x, w[f"{lp}.post_attention_layernorm.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(w, f"{lp}.mlp", h)
        else:
            m, idx = moe(w, biases[f"{lp}.mlp.gate.e_score_correction_bias"],
                         f"{lp}.mlp", h, real, c, held)
            x = x + m
            choices.append(idx)
    x = rms_norm(x, w[f"{pre}.norm.weight"], eps)
    m = real.unsqueeze(-1).float()
    return (x * m).sum(1) / m.sum(1).clamp(min=1.0), choices


def balance(biases: W, choices: List, tokens, c: Dict,
            pre: str = "target_model") -> W:
    """noaux_tc's update after a training forward: each expert layer's
    bias less γ · sign(load − mean load), the loads counted over the real
    tokens' choices (``choices``: the layers' (B·L, K), in order)."""
    real = (tokens != 0).reshape(-1)
    out = dict(biases)
    first = c["first_k_dense_replace"]
    for i, idx in enumerate(choices):
        key = f"{pre}.layers.{first + i}.mlp.gate.e_score_correction_bias"
        load = torch.bincount(idx[real].reshape(-1),
                              minlength=out[key].shape[0]).float()
        out[key] = out[key] - c["bias_update_speed"] * torch.sign(
            load - load.mean())
    return out


def dta_forward(w: W, drug, protein):
    """(G,) affinity in standardized units: drug ‖ protein → fc1 → fc2."""
    x = torch.cat([drug, protein], dim=1)
    x = F.linear(x, w["fc1.weight"], w["fc1.bias"])
    return F.linear(x, w["fc2.weight"], w["fc2.bias"])[:, 0]


def dta_loss(pred, y, mean: float, sdev: float):
    """The standardized mean squared error (sdev already holds + 1e-5)."""
    return torch.mean((pred - (y - mean) / sdev) ** 2)


def adam(w: W, grads: W, state: Dict, lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> W:
    """One Adam update (Kingma & Ba; bias corrections in the step size and
    eps added to the corrected root): the new weights."""
    state["t"] = t = state.get("t", 0) + 1
    out = {}
    for k, p in w.items():
        g = grads[k]
        m = state.setdefault(("m", k), torch.zeros_like(p))
        v = state.setdefault(("v", k), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt() / math.sqrt(1 - b2 ** t) + eps
        out[k] = (p - (lr / (1 - b1 ** t)) * m / denom).detach()
    return out
