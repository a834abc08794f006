"""Molecule renderings: 2D depiction + heat-map overlays for the four
interpretability levels.

Replaces the reference's RDKit drawing stack (fragnet/vizualize/viz.py:67-309,
790-898) with a self-contained matplotlib renderer: 2D coordinates from a
planar force layout of the heavy-atom graph, atoms colored by weight
(or seismic-diverging for signed contributions), bonds as segments.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fragnet_tpu_torch.chem.mol import Molecule


def layout_2d(mol: Molecule, seed: int = 0, iters: int = 400) -> np.ndarray:
    """Deterministic 2D coordinates for depiction: spring layout on heavy
    atoms with ideal bond length 1.0, ring-aware initialization."""
    heavy = [a.idx for a in mol.atoms if a.symbol != "H"]
    idx_map = {a: i for i, a in enumerate(heavy)}
    n = len(heavy)
    if n == 0:
        return np.zeros((mol.GetNumAtoms(), 2))
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 2)) * max(1.0, np.sqrt(n) / 2)

    edges = []
    for b in mol.bonds:
        if b.begin in idx_map and b.end in idx_map:
            edges.append((idx_map[b.begin], idx_map[b.end]))
    e = np.array(edges, dtype=int).reshape(-1, 2)

    for it in range(iters):
        lr = 0.08 * (1.0 - it / iters) + 0.005
        disp = np.zeros_like(pos)
        if len(e):
            d = pos[e[:, 0]] - pos[e[:, 1]]
            r = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
            f = (r - 1.0) * d / r
            np.add.at(disp, e[:, 0], -f)
            np.add.at(disp, e[:, 1], f)
        # pairwise repulsion
        diff = pos[:, None, :] - pos[None, :, :]
        dist2 = np.maximum((diff**2).sum(-1), 1e-6)
        rep = (diff / dist2[..., None]).sum(axis=1) * 0.4
        disp += rep
        pos = pos + lr * disp
    pos -= pos.mean(axis=0)

    full = np.zeros((mol.GetNumAtoms(), 2))
    for a, i in idx_map.items():
        full[a] = pos[i]
    # place hydrogens near their heavy parent
    for a in mol.atoms:
        if a.symbol == "H":
            nb = mol.neighbors(a.idx)
            if nb:
                p = full[nb[0]]
                ang = rng.uniform(0, 2 * np.pi)
                full[a.idx] = p + 0.55 * np.array([np.cos(ang), np.sin(ang)])
    return full


def draw_molecule(
    mol: Molecule,
    atom_colors: Optional[np.ndarray] = None,   # (n_atoms,) in [0,1] or signed
    bond_colors: Optional[np.ndarray] = None,   # (n_bonds,)
    signed: bool = False,
    title: str = "",
    show_hs: bool = False,
    frag_of_atom: Optional[Sequence[int]] = None,
    conn_bonds: Optional[Sequence] = None,      # [(atom_i, atom_j), ...]
    conn_colors: Optional[np.ndarray] = None,   # (n_connections,) in [0,1]
    path: Optional[str] = None,
):
    """Render to a PNG (returns bytes, and writes ``path`` if given).

    signed=False → white→red heat (attention weights);
    signed=True  → blue→white→red seismic (contributions, model_attr.py:793-841).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    pos = layout_2d(mol)
    keep = [a.idx for a in mol.atoms if show_hs or a.symbol != "H"]
    keep_set = set(keep)

    fig, ax = plt.subplots(figsize=(5, 4.2), dpi=110)
    cmap = cm.get_cmap("seismic" if signed else "Reds")

    if signed and atom_colors is not None and np.abs(atom_colors).max() > 0:
        scale = np.abs(atom_colors).max()
        norm = lambda v: 0.5 + 0.5 * v / scale
    else:
        norm = lambda v: v

    # bonds
    bond_id = 0
    for b in mol.bonds:
        if b.begin not in keep_set or b.end not in keep_set:
            continue
        x = [pos[b.begin, 0], pos[b.end, 0]]
        y = [pos[b.begin, 1], pos[b.end, 1]]
        color, lw = "#444444", 1.6
        if bond_colors is not None and b.idx < len(bond_colors):
            color = cmap(norm(bond_colors[b.idx]))
            lw = 3.2
        if b.GetBondType() in ("DOUBLE", "AROMATIC"):
            ax.plot(x, y, color=color, lw=lw + 1.2, alpha=0.45, zorder=1)
        ax.plot(x, y, color=color, lw=lw, zorder=1)

    # fragment-connection overlay: the REAL bonds the connections cut,
    # colored by connection weight (reference frag_weight_highlight,
    # viz.py:857-898 + get_regbond_ids_for_fragbond_ids:366-393)
    if conn_bonds is not None:
        for k, (i, j) in enumerate(conn_bonds):
            if i not in keep_set or j not in keep_set:
                continue
            w = (conn_colors[k] if conn_colors is not None
                 and k < len(conn_colors) else 1.0)
            ax.plot([pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]],
                    color=cm.get_cmap("Reds")(0.25 + 0.75 * float(w)),
                    lw=6.0, alpha=0.85, zorder=1.5,
                    dashes=(2.2, 1.2))

    # atoms
    for a in mol.atoms:
        if a.idx not in keep_set:
            continue
        fc = "#ffffff"
        if atom_colors is not None and a.idx < len(atom_colors):
            fc = cmap(norm(atom_colors[a.idx]))
        ec = "#222222"
        if frag_of_atom is not None:
            palette = plt.get_cmap("tab10")
            ec = palette(int(frag_of_atom[a.idx]) % 10)
        ax.scatter(pos[a.idx, 0], pos[a.idx, 1], s=420, c=[fc],
                   edgecolors=[ec], linewidths=2.0, zorder=2)
        ax.text(pos[a.idx, 0], pos[a.idx, 1], a.symbol, ha="center",
                va="center", fontsize=9, zorder=3)

    ax.set_title(title, fontsize=10)
    ax.set_aspect("equal")
    ax.axis("off")
    buf = io.BytesIO()
    fig.tight_layout()
    fig.savefig(buf, format="png")
    plt.close(fig)
    data = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


def render_report(result, out_path: str) -> str:
    """Standalone HTML report with all four interpretability levels — the
    no-streamlit fallback for the reference's app (vizualize/app.py)."""
    import base64

    g, mol = result.graph, result.mol
    n_heavy_bonds = mol.GetNumBonds()

    imgs = {}
    imgs["atoms (attention)"] = draw_molecule(
        mol, atom_colors=result.atom_weights, title="atom attention"
    )
    bw = np.zeros(n_heavy_bonds)
    bw[: len(result.bond_weights)] = result.bond_weights[:n_heavy_bonds]
    imgs["bonds (attention)"] = draw_molecule(
        mol, bond_colors=bw, title="bond attention"
    )
    frag_atom_w = result.frag_weights[np.asarray(g.atom_to_frag)]
    imgs["fragments (attention)"] = draw_molecule(
        mol, atom_colors=frag_atom_w, frag_of_atom=np.asarray(g.atom_to_frag),
        title="fragment attention",
    )
    if result.fconn_bonds:
        imgs["connections (attention)"] = draw_molecule(
            mol, frag_of_atom=np.asarray(g.atom_to_frag),
            conn_bonds=result.fconn_bonds,
            conn_colors=result.fconn_weights,
            title="fragment-connection attention (on real bonds)",
        )
    if result.atom_contrib is not None:
        imgs["atoms (contribution)"] = draw_molecule(
            mol, atom_colors=result.atom_contrib, signed=True,
            title="atom masking contribution",
        )
    if result.frag_contrib is not None:
        fc = result.frag_contrib[np.asarray(g.atom_to_frag)]
        imgs["fragments (contribution)"] = draw_molecule(
            mol, atom_colors=fc, signed=True,
            title="fragment masking contribution",
        )

    rows = "".join(
        f"<div class='card'><h3>{name}</h3>"
        f"<img src='data:image/png;base64,{base64.b64encode(png).decode()}'/></div>"
        for name, png in imgs.items()
    )
    # one attention+contribution table per level — the four tabs' tabular
    # content in the reference app (vizualize/app.py:187-297)
    def _table(title, head, weights, contribs, labels=None):
        if contribs is None:
            return ""
        labels = labels or [str(i) for i in range(len(weights))]
        body = "".join(
            f"<tr><td>{lab}</td><td>{w:.4f}</td><td>{c:+.4f}</td></tr>"
            for lab, w, c in zip(labels, weights, contribs)
        )
        return (f"<h3>{title}</h3><table><tr><th>{head}</th>"
                "<th>attention</th><th>contribution</th></tr>"
                + body + "</table>")

    def _sym(a):  # rdkit Atom or minichem Atom (chem/mol.py)
        return a.GetSymbol() if hasattr(a, "GetSymbol") else a.symbol

    atom_labels = [f"{i} ({_sym(mol.GetAtomWithIdx(i))})"
                   for i in range(len(result.atom_weights))] \
        if hasattr(mol, "GetAtomWithIdx") else None
    conn_labels = None
    if result.fconn_bonds:
        conn_labels = [f"{k} (atoms {i}-{j})"
                       for k, (i, j) in enumerate(result.fconn_bonds)]
    tables = (
        _table("atom table", "atom", result.atom_weights,
               result.atom_contrib, atom_labels)
        + _table("bond table", "bond", result.bond_weights,
                 result.bond_contrib)
        + _table("fragment table", "frag", result.frag_weights,
                 result.frag_contrib)
        + _table("fragment-connection table", "connection",
                 result.fconn_weights, result.fconn_contrib, conn_labels)
    )

    html = f"""<!doctype html><html><head><meta charset='utf-8'>
<title>FragNet interpretation — {result.smiles}</title>
<style>body{{font-family:sans-serif;margin:24px}}
.card{{display:inline-block;margin:8px;border:1px solid #ddd;padding:8px}}
table{{border-collapse:collapse}} td,th{{border:1px solid #ccc;padding:4px 10px}}
</style></head><body>
<h2>{result.smiles}</h2>
<p>prediction: <b>{result.prediction:.4f}</b></p>
{rows}
{tables}
</body></html>"""
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
