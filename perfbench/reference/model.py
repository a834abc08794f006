"""The plain reference of the benchmark's two models, in float32 torch
operations with no kernel, cache or packing, written from the published
architecture (FragNet, arXiv:2410.12156, gat2.py's four-level layer and
the UniMol-style geometric head of pretrain_heads.py; the DTA model of
fragnet/model/dta/model.py with DeepTTC's BERT protein encoder).

It takes the molecules' arrays, the weights (a dict of tensors keyed by
the reference's parameter names) and the labels, all made by the
benchmark, and imports nothing of the program. Each GAT pass is the
textbook form over the real edges only: logits ``leaky_relu([h_dst ‖ e ‖
h_src]·a, 0.2)``, a softmax over each destination's incoming edges, and
the probability-weighted sum of the source rows.

Node tensors keep the padded row counts and places of ``layout.py``:
dropout draws its mask over every padded row, so with the generator in
the same state the reference draws the program's masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import layout

W = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Batch:
    """One batch on the device: padded node rows, real edges only."""

    n_graphs: int
    rows: Dict[str, int]        # padded rows per node axis
    x_atoms: torch.Tensor       # (A, 167)
    nf_bonds: torch.Tensor      # (E, 17)
    nf_fbonds: torch.Tensor     # (C, 6)
    atom_rows: torch.Tensor     # real atoms' rows
    bond_rows: torch.Tensor
    frag_rows: torch.Tensor
    fc_rows: torch.Tensor
    a_src: torch.Tensor         # atom graph: real edges (bond rows in order)
    a_dst: torch.Tensor
    b_src: torch.Tensor         # bond line graph
    b_dst: torch.Tensor
    b_attr: torch.Tensor        # (EB, 1)
    f_src: torch.Tensor         # fragment graph (edges = fc rows in order)
    f_dst: torch.Tensor
    c_src: torch.Tensor         # fragment-connection line graph
    c_dst: torch.Tensor
    c_attr: torch.Tensor        # (EC, 6)
    atom_to_frag: torch.Tensor  # per real atom
    atom_graph: torch.Tensor    # per real atom
    frag_graph: torch.Tensor    # per real fragment
    y: torch.Tensor             # (G,)
    bnd_lngth: Optional[torch.Tensor] = None  # per real bond
    dh_angl: Optional[torch.Tensor] = None
    bnd_angl: Optional[torch.Tensor] = None   # per real atom
    protein: Optional[torch.Tensor] = None    # (G, L) int64


def make_batch(graphs: Sequence, rows: Dict[str, int], tn: Dict[str, int],
               device, proteins: Optional[np.ndarray] = None,
               labels: Optional[np.ndarray] = None) -> Batch:
    """The reference's batch of ``graphs`` (in order), its node rows at
    the aligned places that ``layout`` works out. ``labels`` replace the
    graphs' own y (the DTA pairs' affinities)."""
    off = {ax: layout.aligned_starts(layout.counts(graphs, ax), tn[ax])
           for ax in layout.AXES}
    for ax in layout.AXES:
        if off[ax][-1] > rows[ax]:
            raise ValueError(f"{ax}: {off[ax][-1]} rows exceed {rows[ax]}")

    def place(ax, field_len):
        return np.concatenate([off[ax][i] + np.arange(n)
                               for i, n in enumerate(field_len)])

    na = layout.counts(graphs, "atom")
    ne = layout.counts(graphs, "bond")
    nf = layout.counts(graphs, "frag")
    nc = layout.counts(graphs, "fc")
    ar, br, fr, cr = (place("atom", na), place("bond", ne),
                      place("frag", nf), place("fc", nc))

    def cat(name, axis=0):
        return np.concatenate([getattr(g, name) for g in graphs], axis=axis)

    def shift(idx, ax, per):
        return idx + np.repeat(off[ax][:-1], per)

    ei = cat("edge_index", 1)
    eib = cat("ei_bonds", 1)
    nbg = np.array([g.n_bg_edges for g in graphs])
    fi = cat("frag_index", 1)
    eif = cat("ei_fbonds", 1)
    nfc = np.array([g.n_fc_edges for g in graphs])

    def padded(n, x, at):
        out = np.zeros((n, x.shape[1]), np.float32)
        out[at] = x
        return out

    G = len(graphs)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                    device=device)
    ti = lambda a: t(np.asarray(a, np.int64), torch.int64)
    y = labels if labels is not None else np.array(
        [float(g.y.reshape(-1)[0]) for g in graphs])
    b = Batch(
        n_graphs=G, rows=dict(rows),
        x_atoms=t(padded(rows["atom"], cat("x_atoms"), ar)),
        nf_bonds=t(padded(rows["bond"], cat("nf_bonds"), br)),
        nf_fbonds=t(padded(rows["fc"], cat("nf_fbonds"), cr)),
        atom_rows=ti(ar), bond_rows=ti(br), frag_rows=ti(fr), fc_rows=ti(cr),
        a_src=ti(shift(ei[0], "atom", ne)), a_dst=ti(shift(ei[1], "atom", ne)),
        b_dst=ti(shift(eib[0], "bond", nbg)),
        b_src=ti(shift(eib[1], "bond", nbg)),
        b_attr=t(cat("ea_bonds")),
        f_src=ti(shift(fi[0], "frag", nc)), f_dst=ti(shift(fi[1], "frag", nc)),
        c_dst=ti(shift(eif[0], "fc", nfc)), c_src=ti(shift(eif[1], "fc", nfc)),
        c_attr=t(cat("ea_fbonds")),
        atom_to_frag=ti(shift(cat("atom_to_frag"), "frag", na)),
        atom_graph=ti(np.repeat(np.arange(G), na)),
        frag_graph=ti(np.repeat(np.arange(G), nf)),
        y=t(np.asarray(y, np.float32)),
    )
    if graphs[0].bnd_lngth is not None:
        b.bnd_lngth = t(cat("bnd_lngth").reshape(-1))
        b.dh_angl = t(cat("dh_angl").reshape(-1))
        b.bnd_angl = t(cat("bnd_angl").reshape(-1))
    if proteins is not None:
        b.protein = ti(proteins)
    return b


def drop(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    return F.dropout(x, p, True) if training and p > 0 else x


def gat(nf: torch.Tensor, ea: torch.Tensor, src: torch.Tensor,
        dst: torch.Tensor, a: torch.Tensor, n: int) -> torch.Tensor:
    """One GAT pass: ``nf`` (n, H, D), ``ea`` (edges, Da) shared by the
    heads, ``a`` (H, 2D + Da) over [h_dst ‖ e ‖ h_src]; (n, H, D)."""
    H, D = nf.shape[1], nf.shape[2]
    Da = ea.shape[1]
    w_dst = (nf * a[None, :, :D]).sum(-1)
    w_src = (nf * a[None, :, D + Da:]).sum(-1)
    w_e = ea @ a[:, D:D + Da].T
    logit = F.leaky_relu(w_dst[dst] + w_e + w_src[src], 0.2)
    top = torch.full((n, H), -torch.inf, device=nf.device).scatter_reduce(
        0, dst[:, None].expand(-1, H), logit.detach(), "amax",
        include_self=True)
    ex = torch.exp(logit - top[dst])
    den = torch.zeros((n, H), device=nf.device).index_add(0, dst, ex)
    p = ex / den[dst]
    return torch.zeros_like(nf).index_add(0, dst, p[..., None] * nf[src])


def _lin(w: W, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def _layer(w: W, pre: str, b: Batch, xa, eb, fb, H: int):
    """One four-level layer: bond graph, atom graph with self-loops,
    atoms pooled into fragments, fragment-connection graph, fragment
    graph. Returns the new (atoms, fragments, bonds, connections)."""
    A, E, Fr, C = (b.rows[k] for k in layout.AXES)
    eb_p = _lin(w, f"{pre}.projection_b", eb)
    nb = gat(eb_p.view(E, H, -1), _lin(w, f"{pre}.edge_attr_bond_embed",
                                       b.b_attr),
             b.b_src, b.b_dst, w[f"{pre}.a_b"], E).reshape(E, -1)
    bond = torch.zeros_like(nb)
    bond[b.bond_rows] = nb[b.bond_rows]

    xa_p = _lin(w, f"{pre}.projection_a", xa).view(A, H, -1)
    loops = b.atom_rows
    src = torch.cat([b.a_src, loops])
    dst = torch.cat([b.a_dst, loops])
    ea = torch.cat([bond[b.bond_rows],
                    bond.new_zeros((loops.shape[0], bond.shape[1]))])
    na = gat(xa_p, ea, src, dst, w[f"{pre}.a"], A).reshape(A, -1)
    atoms = torch.zeros_like(na)
    atoms[b.atom_rows] = na[b.atom_rows]

    frags_in = torch.zeros((Fr, atoms.shape[1]), device=atoms.device
                           ).index_add(0, b.atom_to_frag, atoms[b.atom_rows])

    fb_p = _lin(w, f"{pre}.projection_fb", fb)
    nc = gat(fb_p.view(C, H, -1), _lin(w, f"{pre}.edge_attr_fbond_embed",
                                       b.c_attr),
             b.c_src, b.c_dst, w[f"{pre}.f_a_b"], C).reshape(C, -1)
    conn = torch.zeros_like(nc)
    conn[b.fc_rows] = nc[b.fc_rows]

    nfr = gat(frags_in.view(Fr, H, -1), conn[b.fc_rows], b.f_src, b.f_dst,
              w[f"{pre}.f"], Fr).reshape(Fr, -1)
    frags = torch.zeros_like(nfr)
    frags[b.frag_rows] = nfr[b.frag_rows]
    return atoms, frags, bond, conn


def encoder(w: W, pre: str, b: Batch, n_layers: int, H: int, p: float,
            training: bool):
    """The FragNet encoder: dropout on the raw atom features, then each
    layer with ReLU after dropout on all four streams."""
    xa = drop(b.x_atoms, p, training)
    eb, fb = b.nf_bonds, b.nf_fbonds
    for i in range(n_layers):
        xa, xf, eb, fb = _layer(w, f"{pre}.layers.{i}", b, xa, eb, fb, H)
        xa = torch.relu(drop(xa, p, training))
        xf = torch.relu(drop(xf, p, training))
        eb = torch.relu(drop(eb, p, training))
        fb = torch.relu(drop(fb, p, training))
    return xa, xf, eb, fb


def pool_graphs(b: Batch, xa, xf) -> torch.Tensor:
    """(G, 2·emb): atoms and fragments summed by molecule."""
    G = b.n_graphs
    pa = torch.zeros((G, xa.shape[1]), device=xa.device).index_add(
        0, b.atom_graph, xa[b.atom_rows])
    pf = torch.zeros((G, xf.shape[1]), device=xf.device).index_add(
        0, b.frag_graph, xf[b.frag_rows])
    return torch.cat([pa, pf], dim=1)


def _ladder(w: W, pre: str, x, pre_act: bool) -> torch.Tensor:
    """The halving MLP d → d/2 → d/4 → 1; the bond-length ladder applies
    ReLU before each Linear, the others after each hidden one."""
    for i in range(2):
        x = _lin(w, f"{pre}.{i}", torch.relu(x)) if pre_act \
            else torch.relu(_lin(w, f"{pre}.{i}", x))
    return _lin(w, f"{pre}.2", torch.relu(x) if pre_act else x)


def pretrain_loss(w: W, b: Batch, cfg: Dict, training: bool):
    """The four-target geometric loss: bond length, bond angle, dihedral
    (mean squared errors over the real bonds / atoms) and energy (over the
    molecules)."""
    m = cfg["model"]
    xa, xf, eb, _ = encoder(w, "pretrain", b, m["num_layer"],
                            m["num_heads"], m["drop_ratio"], training)
    bond = eb[b.bond_rows]
    pair = torch.cat([xa[b.a_src], xa[b.a_dst], bond], dim=1)
    bl = _ladder(w, "head.bl_layers",
                 _lin(w, "head.bl_reduce_layer", pair), True)[:, 0]
    ba = _ladder(w, "head.ba_layers", xa[b.atom_rows], False)[:, 0]
    da = _ladder(w, "head.da_layers", bond, False)[:, 0]
    en = _ladder(w, "head.FC_layers", pool_graphs(b, xa, xf), False)[:, 0]
    mse = lambda x, y: torch.mean((x - y) ** 2)
    return (mse(bl, b.bnd_lngth) + mse(ba, b.bnd_angl)
            + mse(da, b.dh_angl) + mse(en, b.y))


def _layer_norm(w: W, pre: str, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{pre}.gamma"],
                        w[f"{pre}.beta"], 1e-12)


def protein_encoder(w: W, pre: str, tokens, cfg: Dict, training: bool):
    """The BERT protein encoder: embeddings, then each layer's masked
    self-attention and ReLU feed-forward, each followed by dropout, the
    residual sum and LayerNorm; the first position's row."""
    p = cfg["protein"]["dropout"]
    H = cfg["protein"]["heads"]
    B, L = tokens.shape
    x = w[f"{pre}.emb.word_embeddings.weight"][tokens] \
        + w[f"{pre}.emb.position_embeddings.weight"][:L][None]
    x = drop(_layer_norm(w, f"{pre}.emb.LayerNorm", x), p, training)
    keep = tokens != 0
    for i in range(cfg["protein"]["layers"]):
        lp = f"{pre}.encoder.layer.{i}"
        E = x.shape[-1]
        Dh = E // H
        q = _lin(w, f"{lp}.attention.self.query", x).view(B, L, H, Dh) \
            / math.sqrt(Dh)
        k = _lin(w, f"{lp}.attention.self.key", x).view(B, L, H, Dh)
        v = _lin(w, f"{lp}.attention.self.value", x).view(B, L, H, Dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        s = s.masked_fill(~keep[:, None, None, :], torch.finfo(s.dtype).min)
        a = drop(torch.softmax(s, dim=-1), p, training)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, L, E)
        x = _layer_norm(w, f"{lp}.attention.output.LayerNorm",
                        x + drop(_lin(w, f"{lp}.attention.output.dense", o),
                                 p, training))
        h = torch.relu(_lin(w, f"{lp}.intermediate.dense", x))
        x = _layer_norm(w, f"{lp}.output.LayerNorm",
                        x + drop(_lin(w, f"{lp}.output.dense", h), p,
                                 training))
    return x[:, 0]


def dta_forward(w: W, b: Batch, cfg: Dict, training: bool) -> torch.Tensor:
    """(G,) affinity in standardized units: the drug's pooled encoding ‖
    the protein's, then two Linears."""
    m = cfg["model"]
    xa, xf, _, _ = encoder(w, "drug_model.pretrain", b, m["num_layer"],
                           m["num_heads"], m["drop_ratio"], training)
    rep = torch.cat([pool_graphs(b, xa, xf),
                     protein_encoder(w, "target_model", b.protein, cfg,
                                     training)], dim=1)
    return _lin(w, "fc2", _lin(w, "fc1", rep))[:, 0]


def label_stats(labels: np.ndarray):
    """(mean, population std + 1e-5) of the training labels."""
    y = np.asarray(labels, np.float64)
    return float(y.mean()), float(y.std()) + 1e-5


def dta_loss(w: W, b: Batch, cfg: Dict, stats, training: bool):
    mean, sdev = stats
    out = dta_forward(w, b, cfg, training)
    return torch.mean((out - (b.y - mean) / sdev) ** 2)


def adam(w: W, grads: W, state: Dict, opt: Dict) -> W:
    """One Adam update (Kingma & Ba, with the bias corrections folded into
    the step size and eps added to the corrected root): new weights."""
    state["t"] = t = state.get("t", 0) + 1
    b1, b2, lr, eps = opt["b1"], opt["b2"], opt["lr"], opt["eps"]
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
