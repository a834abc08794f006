"""The work of the Moonlight-16B-A3B protein tower (dta-fragnet-moonlight)
from a batch's real shapes, and the least time the H100 could take for its
token dispatch and combine.

Model operations (2 per multiply-add) count the real residues only and the
real assignments to the experts held here: each layer's MLA projections
per residue, its causal attention over each sequence's real prefix
(query · key over nope + rope, probabilities · value), the dense layer's
SwiGLU, and in each MoE layer the router, the shared experts per residue
and one expert SwiGLU per held assignment. Padding rows, which the program
also computes, are work the inputs do not need.

The dispatch and combine kernels (csrc/moe_route.cu) move bytes: with T
token rows of width D, K slots a token, A held assignments and U tokens
with one held, each input read once and each output written once, f32 and
int32 alike (4 bytes):

* gather:            tok (A), U rows of x read; A rows written;
* combine:           pos (T·K), A weights and A rows read; T rows written;
* gather backward:   the combine unweighted: pos, A rows read, T written;
* combine backward:  pos, A weights, U rows of d_out, A rows of y read;
                     A rows of d_y and T·K of d_w written.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from perfbench.costs import flops

# NVIDIA H100 SXM data sheet: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12


def tower_forward(lengths: Sequence[int], assignments: float,
                  c: Dict) -> float:
    """The tower's forward over sequences of ``lengths`` real residues,
    with ``assignments`` real assignments to held experts over all its MoE
    layers."""
    L = np.asarray(lengths, np.float64)
    n, D, H = float(L.sum()), c["hidden_size"], c["num_attention_heads"]
    nope, rope, v = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"])
    r = c["kv_lora_rank"]
    proj = 2 * n * (D * H * (nope + rope) + D * (r + rope)
                    + r * H * (nope + v) + H * v * D)
    pairs = float((L * (L + 1) / 2).sum())       # causal: keys ≤ the query
    attn = 2 * pairs * H * (nope + rope + v)
    layers = c["num_hidden_layers"]
    dense = c["first_k_dense_replace"]
    moe = layers - dense
    per_moe = (2 * n * D * c["n_routed_experts"]
               + 2 * n * 3 * D * c["moe_intermediate_size"]
               * c["n_shared_experts"])
    return (layers * (proj + attn)
            + dense * 2 * n * 3 * D * c["intermediate_size"]
            + moe * per_moe
            + assignments * 2 * 3 * D * c["moe_intermediate_size"])


def dta_forward(counts: Dict[str, int], lengths: Sequence[int],
                assignments: float, cfg: Dict) -> float:
    """The drug encoder, its pooling, the tower and the head."""
    m = cfg["model"]
    emb = m["emb_dim"]
    fc1 = cfg["head"]["fc1"]
    head = 2 * counts["graphs"] * ((2 * emb + cfg["hidden_size"]) * fc1
                                   + fc1)
    return (flops.encoder_forward(counts, m["num_layer"], emb,
                                  m["num_heads"])
            + 2 * counts["atom"] * emb + 2 * counts["frag"] * emb
            + tower_forward(lengths, assignments, cfg) + head)


def kernel_bytes(T: float, A: float, U: float, D: int, K: int
                 ) -> Dict[str, float]:
    """Bytes of each of one MoE layer's launches (see the module's note),
    by kernel: ``gather``, ``combine`` (weighted), ``gather_bwd`` (the
    combine unweighted) and ``combine_bwd``."""
    row = 4 * D
    return {"gather": float(4 * A + U * row + A * row),
            "combine": float(4 * T * K + 4 * A + A * row + T * row),
            "gather_bwd": float(4 * T * K + A * row + T * row),
            "combine_bwd": float(4 * T * K + 4 * A + U * row + 2 * A * row
                                 + 4 * T * K)}


def route_bytes(T: float, A: float, U: float, D: int, K: int) -> float:
    """Bytes of one MoE layer's gather, combine and both backwards; the
    counts may be sums over layers and steps."""
    return sum(kernel_bytes(T, A, U, D, K).values())


def route_bound_ms(T: float, A: float, U: float, D: int, K: int) -> float:
    return 1e3 * route_bytes(T, A, U, D, K) / HBM_BYTES_PER_S

