"""The plain reference of the DTA model with the Moonlight-16B-A3B protein
tower (dta-fragnet-moonlight), in float32 torch operations: the tower
written from the published equations (Moonlight-16B-A3B's config.json,
model_type deepseek_v3: RMSNorm, MLA without a q LoRA, RoPE on
de-interleaved pairs, SwiGLU, the sigmoid ``noaux_tc`` router, the shared
experts), the drug encoder and the head of ``model.py``. It imports
nothing of the program, and reads TF32 from torch's flags, which the
benchmark sets off (the control turns them on).

Departures from the published model, each the program's too: the
vocabulary is the 25 residue letters and the padding id 0; no LM head, the
tower's output is the mean of its last normalized hidden states over the
real residues; the correction bias moved after each step by the
configuration's γ, ``bias_update_speed`` (``balance``; γ is not in
config.json), from the biases that ``setup_biases`` balances at the first
weights; no sequence-level auxiliary loss; the router's top-k taken
sorted. Of the experts, those in ``held`` (the
card's share) add their part; the others' part is left out.

``step_grads`` gives one training step's loss and gradients with the
tower run over micro-batches of the pairs, so that a batch of 32 pairs
of 1000 residues fits beside the benchmark's copies of the weights: the
tower's outputs at the whole batch without autograd (and each expert
layer's choices, for the comparison of routes), the drug encoder and the
head with autograd to the tower's outputs, then each micro-batch's tower
again with autograd, fed its share of that gradient. The tower draws no
random numbers, so the drug encoder's dropout draws the program's masks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref

W = Dict[str, torch.Tensor]
PRE = "target_model"


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


def router(w: W, bias: torch.Tensor, pre: str, h, c: Dict, idx=None):
    """(idx (T, K) chosen by score + bias, sorted, unless given; their
    weights)."""
    s = torch.sigmoid(F.linear(h, w[f"{pre}.gate.weight"]))
    if idx is None:
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
        held: Sequence[int], idx=None):
    """(the layer's output (B, L, D), its choices (B·L, K)); ``idx`` given
    holds the choices instead of the router's."""
    B, L, D = x.shape
    h = x.reshape(B * L, D)
    r = real.reshape(-1)
    idx, g = router(w, bias, pre, h, c, idx)
    out = routed(w, pre, h, r, idx, g, held) \
        + swiglu(w, f"{pre}.shared_experts", h)
    return out.view(B, L, D), idx


def held_of(c: Dict) -> Tuple[int, ...]:
    h = c.get("experts_held")
    if h is None:
        return tuple(range(c["n_routed_experts"]))
    return tuple(range(h)) if isinstance(h, int) else tuple(h)


def tower(w: W, biases: W, tokens, c: Dict, pre: str = PRE, routes=None
          ) -> Tuple[torch.Tensor, List]:
    """(the masked mean (B, hidden), the choices of each expert layer);
    ``routes``, one (B·L, K) tensor an expert layer, holds the choices
    instead of the routers'."""
    B, L = tokens.shape
    held = held_of(c)
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
                         f"{lp}.mlp", h, real, c, held,
                         None if routes is None else routes[len(choices)])
            x = x + m
            choices.append(idx)
    x = rms_norm(x, w[f"{pre}.norm.weight"], eps)
    m = real.unsqueeze(-1).float()
    return (x * m).sum(1) / m.sum(1).clamp(min=1.0), choices


def balance(biases: W, choices: List, tokens, c: Dict,
            pre: str = PRE, step: Optional[float] = None) -> W:
    """noaux_tc's update after a training forward: each expert layer's
    bias less γ · sign(load − mean load), the loads counted over the real
    tokens' choices (``choices``: the layers' (B·L, K), in order); γ is
    ``step`` where given, else the configuration's."""
    real = (tokens != 0).reshape(-1)
    out = dict(biases)
    first = c["first_k_dense_replace"]
    gamma = c["bias_update_speed"] if step is None else step
    for i, idx in enumerate(choices):
        key = f"{pre}.layers.{first + i}.mlp.gate.e_score_correction_bias"
        load = torch.bincount(idx[real].reshape(-1),
                              minlength=out[key].shape[0]).float()
        out[key] = out[key] - gamma * torch.sign(load - load.mean())
    return out


# setup_biases: sign steps of 0.05 shrinking by 0.85 each round (reaching
# ±0.33 in score units, whose spread is ~0.2), 30 rounds
SETUP_STEP, SETUP_DECAY, SETUP_ROUNDS = 0.05, 0.85, 30


def setup_biases(w: W, tokens, c: Dict, pre: str = PRE) -> W:
    """The correction biases a deployment's balancing leaves at ``w``:
    from 0, each round the tower's choices over the real residues of
    ``tokens`` step each expert's bias against its load (``balance``), by
    a step that shrinks each round."""
    E = c["n_routed_experts"]
    biases = {f"{pre}.layers.{i}.mlp.gate.e_score_correction_bias":
              torch.zeros(E, device=tokens.device)
              for i in range(c["first_k_dense_replace"],
                             c["num_hidden_layers"])}
    step = SETUP_STEP
    with torch.no_grad():
        for _ in range(SETUP_ROUNDS):
            _, choices = tower(w, biases, tokens, c, pre)
            biases = balance(biases, choices, tokens, c, pre, step)
            step *= SETUP_DECAY
    return biases


def head_loss(w: W, b: ref.Batch, protein: torch.Tensor, cfg: Dict, stats,
              training: bool):
    """The standardized loss from the drug encoder (dropout drawn here)
    and the tower's outputs ``protein`` (G, hidden)."""
    m = cfg["model"]
    xa, xf, _, _ = ref.encoder(w, "drug_model.pretrain", b, m["num_layer"],
                               m["num_heads"], m["drop_ratio"], training)
    rep = torch.cat([ref.pool_graphs(b, xa, xf), protein], dim=1)
    out = ref._lin(w, "fc2", ref._lin(w, "fc1", rep))[:, 0]
    mean, sdev = stats
    return torch.mean((out - (b.y - mean) / sdev) ** 2)


def step_grads(w: W, biases: W, b: ref.Batch, cfg: Dict, stats,
               micro: int) -> Tuple[float, W, List[torch.Tensor]]:
    """(loss, gradient of every leaf of ``w``, each expert layer's choices
    at the whole batch) of one training step, the tower over micro-batches
    of ``micro`` pairs, each with the whole batch's choices (the routes
    are a function of the rows, so they are the same; taken over, they
    do not move at a near-tie with the micro-batches' other rounding)."""
    tower_keys = [k for k in w if k.startswith(PRE + ".")]
    rest_keys = [k for k in w if not k.startswith(PRE + ".")]
    with torch.no_grad():
        prot, choices = tower(w, biases, b.protein, cfg)
    prot = prot.requires_grad_()
    leaves = {k: w[k].detach().requires_grad_() for k in rest_keys}
    loss = head_loss(leaves, b, prot, cfg, stats, True)
    g = torch.autograd.grad(loss, [leaves[k] for k in rest_keys] + [prot],
                            allow_unused=True)
    grads = {k: (x if x is not None else torch.zeros_like(w[k]))
             for k, x in zip(rest_keys, g[:-1])}
    d_prot = g[-1]
    del g, leaves, prot
    acc = {k: torch.zeros_like(w[k]) for k in tower_keys}
    B, L = b.protein.shape
    for s in range(0, B, micro):
        tl = {k: w[k].detach().requires_grad_() for k in tower_keys}
        routes = [c.view(B, L, -1)[s:s + micro].reshape(-1, c.shape[1])
                  for c in choices]
        out, _ = tower(tl, biases, b.protein[s:s + micro], cfg,
                       routes=routes)
        part = torch.autograd.grad(out, [tl[k] for k in tower_keys],
                                   grad_outputs=d_prot[s:s + micro],
                                   allow_unused=True)
        for k, x in zip(tower_keys, part):
            if x is not None:
                acc[k] += x
        del out, part, tl
    grads.update(acc)
    return float(loss.detach()), grads, choices


def reference_steps(w0: W, biases: W, batches: Sequence[ref.Batch],
                    seeds: Sequence[int], cfg: Dict, stats, micro: int):
    """The reference's steps from ``w0``: (losses, first gradient, weights
    after the last step, the first step's choices)."""
    w = {k: v.clone() for k, v in w0.items()}
    state: Dict = {}
    losses, first, first_choices = [], None, None
    for k, (b, s) in enumerate(zip(batches, seeds)):
        torch.manual_seed(s)
        loss, g, choices = step_grads(w, biases, b, cfg, stats, micro)
        losses.append(loss)
        if k == 0:
            first = {n: x.clone() for n, x in g.items()}
            first_choices = choices
        w = ref.adam(w, g, state, cfg["optimizer"])
        biases = balance(biases, choices, b.protein, cfg)
        del g
    return losses, first, w, first_choices
