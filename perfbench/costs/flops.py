"""Model operations of one batch, counted from its real shapes: the
Linears (2 per multiply-add), each GAT pass's per-edge logit dot over
[h_dst ‖ e ‖ h_src] and weighted sum, the heads, and the protein encoder
over the real residues only (padding is work that the inputs do not
need). A training step counts 3 × the forward; screening the forward.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# the float32 rate of one NVIDIA H100 SXM outside the tensor cores (data
# sheet, dense)
F32_PEAK = 67e12


def real_counts(graphs: Sequence) -> Dict[str, int]:
    """Real nodes and edges of each level of a batch of MolGraphs."""
    s = lambda k: int(sum(getattr(g, k) for g in graphs))
    return {"graphs": len(graphs), "atom": s("n_atoms"), "bond": s("n_edges"),
            "frag": s("n_frags"), "fc": s("n_fconn"), "e_atom": s("n_edges"),
            "e_bond": s("n_bg_edges"), "e_frag": s("n_fconn"),
            "e_fc": s("n_fc_edges")}


def _gat(edges: int, nodes_out: int, h: int, d: int, da: int) -> float:
    """Logit dots, a softmax (~5 per edge and head) and the weighted
    sum."""
    return edges * h * (2 * (2 * d + da) + 5 + 2 * d) + nodes_out * h * d


def encoder_forward(c: Dict[str, int], layers: int, emb: int, h: int,
                    atom_in: int = 167, bond_in: int = 17,
                    fc_in: int = 6, bond_attr: int = 1,
                    fc_attr: int = 6) -> float:
    d = emb // h
    total = 0.0
    for i in range(layers):
        a_in = atom_in if i == 0 else emb
        b_in = bond_in if i == 0 else emb
        f_in = fc_in if i == 0 else emb
        total += 2 * c["bond"] * b_in * emb + 2 * c["e_bond"] * bond_attr * d
        total += _gat(c["e_bond"], c["bond"], h, d, d)
        total += 2 * c["atom"] * a_in * emb
        total += _gat(c["e_atom"] + c["atom"], c["atom"], h, d, emb)
        total += c["atom"] * emb                                 # pooling
        total += 2 * c["fc"] * f_in * emb + 2 * c["e_fc"] * fc_attr * d
        total += _gat(c["e_fc"], c["fc"], h, d, d)
        total += _gat(c["e_frag"], c["frag"], h, d, emb)
    return total


def _ladder(rows: int, d_in: int) -> float:
    return 2 * rows * (d_in * (d_in // 2) + (d_in // 2) * (d_in // 4)
                       + d_in // 4)


def pretrain_forward(c: Dict[str, int], layers: int, emb: int,
                     h: int) -> float:
    head = (2 * c["bond"] * 3 * emb * emb + _ladder(c["bond"], emb)
            + _ladder(c["atom"], emb) + _ladder(c["bond"], emb)
            + _ladder(c["graphs"], 2 * emb))
    return encoder_forward(c, layers, emb, h) + head


def protein_forward(lengths: np.ndarray, layers: int, emb: int,
                    ffn: int) -> float:
    """The BERT encoder over each sequence's real residues."""
    L = np.asarray(lengths, np.float64)
    per_layer = (2 * L * 4 * emb * emb + 2 * L * 2 * emb * ffn
                 + 2 * 2 * L * L * emb)
    return float(layers * per_layer.sum())


def dta_forward(c: Dict[str, int], lengths: np.ndarray, cfg: Dict) -> float:
    m, p = cfg["model"], cfg["protein"]
    emb = m["emb_dim"]
    head = 2 * c["graphs"] * (3 * emb * 128 + 128)
    return (encoder_forward(c, m["num_layer"], emb, m["num_heads"])
            + 2 * c["atom"] * emb + 2 * c["frag"] * emb
            + protein_forward(lengths, p["layers"], p["hidden"], p["ffn"])
            + head)
