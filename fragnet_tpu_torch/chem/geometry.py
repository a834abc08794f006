"""Host-side 3D conformer generation for the minichem engine.

Replaces the reference's RDKit ETKDG + MMFF pipeline
(fragnet/dataset/fragments.py:41-108) with a deterministic, dependency-light
embedder: seeded random/spectral initialization followed by L-BFGS
minimization of a light-weight force field (bond stretch + angle bend + 1-4+
repulsion).  Good enough to provide self-consistent geometric pretraining
targets (bond lengths², angle-norm², dihedral dot products — data.py:224-260)
and the cos-angle bond-graph edge attributes (data.py:185-211).

When RDKit is available the engine module routes conformer generation to
ETKDG instead; this module is the always-available fallback.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from fragnet_tpu_torch.chem.mol import BOND_ORDER_VALUE, Molecule

# Covalent radii (Å) for ideal bond lengths.
_COVALENT_RADIUS: Dict[str, float] = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "Ge": 1.20, "As": 1.19,
    "Se": 1.20, "Br": 1.20, "Sn": 1.39, "Sb": 1.39, "Te": 1.38, "I": 1.39,
}
_DEFAULT_RADIUS = 1.0

_ORDER_SHRINK = {1.0: 0.0, 1.5: 0.06, 2.0: 0.11, 3.0: 0.18}

_IDEAL_COS = {
    "SP": -1.0,          # 180°
    "SP2": -0.5,         # 120°
    "SP3": -1.0 / 3.0,   # 109.47°
    "S": -1.0 / 3.0,
    "UNSPECIFIED": -1.0 / 3.0,
    "SP3D": -0.5,
    "SP3D2": 0.0,
}


def _ideal_length(mol: Molecule, bidx: int) -> float:
    b = mol.bonds[bidx]
    r = (
        _COVALENT_RADIUS.get(mol.atoms[b.begin].symbol, _DEFAULT_RADIUS)
        + _COVALENT_RADIUS.get(mol.atoms[b.end].symbol, _DEFAULT_RADIUS)
    )
    return r * (1.0 - _ORDER_SHRINK.get(BOND_ORDER_VALUE[b.GetBondType()], 0.0))


class Conformer:
    """Positions container with the RDKit-conformer surface GraphBuilder
    uses (GetPositions / angle queries)."""

    def __init__(self, positions: np.ndarray, energy: float = 0.0):
        self.positions = np.asarray(positions, dtype=np.float64)
        self.energy = float(energy)

    def GetPositions(self) -> np.ndarray:
        return self.positions

    def angle_rad(self, i: int, j: int, k: int) -> float:
        """Angle i-j-k in radians (rdMolTransforms.GetAngleRad equivalent)."""
        v1 = self.positions[i] - self.positions[j]
        v2 = self.positions[k] - self.positions[j]
        n1 = np.linalg.norm(v1)
        n2 = np.linalg.norm(v2)
        if n1 < 1e-12 or n2 < 1e-12:
            return 0.0
        c = float(np.dot(v1, v2) / (n1 * n2))
        return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _angle_triples(mol: Molecule):
    triples = []
    for j in range(mol.GetNumAtoms()):
        nbrs = mol.neighbors(j)
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                triples.append((nbrs[a], j, nbrs[b]))
    return triples


def embed_3d(mol: Molecule, seed: int = 42, max_iters: int = 300) -> Conformer:
    """Deterministic 3D embedding: seeded gaussian init (scaled to molecule
    size), then L-BFGS on the light force field. Returns a Conformer whose
    ``energy`` is the final force-field value (the pretraining energy target
    analog of the reference MMFF energy, fragments.py:101-103)."""
    n = mol.GetNumAtoms()
    rng = np.random.default_rng(seed + n * 1009)
    x0 = rng.standard_normal((n, 3)) * max(1.0, n ** (1.0 / 3.0))

    bonds = [(b.begin, b.end) for b in mol.bonds]
    ideal = np.array([_ideal_length(mol, b.idx) for b in mol.bonds]) if bonds else np.zeros(0)
    bsrc = np.array([u for u, _ in bonds], dtype=np.int64)
    bdst = np.array([v for _, v in bonds], dtype=np.int64)

    triples = _angle_triples(mol)
    ti = np.array([t[0] for t in triples], dtype=np.int64)
    tj = np.array([t[1] for t in triples], dtype=np.int64)
    tk = np.array([t[2] for t in triples], dtype=np.int64)
    cos0 = np.array(
        [_IDEAL_COS.get(str(mol.atoms[t[1]].hybridization), -1.0 / 3.0) for t in triples]
    )

    bonded = set()
    for u, v in bonds:
        bonded.add((min(u, v), max(u, v)))
    for a, j, b in triples:
        bonded.add((min(a, b), max(a, b)))
    nb_pairs = [
        (i, j)
        for i in range(n)
        for j in range(i + 1, n)
        if (i, j) not in bonded
    ]
    pi = np.array([p[0] for p in nb_pairs], dtype=np.int64)
    pj = np.array([p[1] for p in nb_pairs], dtype=np.int64)

    k_bond, k_angle, k_rep, rep_r = 100.0, 15.0, 5.0, 2.2

    def energy_grad(flat: np.ndarray):
        pos = flat.reshape(n, 3)
        grad = np.zeros_like(pos)
        e = 0.0
        if len(bsrc):
            d = pos[bsrc] - pos[bdst]
            r = np.linalg.norm(d, axis=1)
            r = np.maximum(r, 1e-8)
            diff = r - ideal
            e += k_bond * float(np.sum(diff**2))
            g = (2.0 * k_bond * diff / r)[:, None] * d
            np.add.at(grad, bsrc, g)
            np.add.at(grad, bdst, -g)
        if len(ti):
            v1 = pos[ti] - pos[tj]
            v2 = pos[tk] - pos[tj]
            r1 = np.maximum(np.linalg.norm(v1, axis=1), 1e-8)
            r2 = np.maximum(np.linalg.norm(v2, axis=1), 1e-8)
            cosang = np.sum(v1 * v2, axis=1) / (r1 * r2)
            diff = cosang - cos0
            e += k_angle * float(np.sum(diff**2))
            # d cos / d v1 = v2/(r1 r2) - cos * v1 / r1^2
            c1 = (v2 / (r1 * r2)[:, None]) - (cosang / r1**2)[:, None] * v1
            c2 = (v1 / (r1 * r2)[:, None]) - (cosang / r2**2)[:, None] * v2
            gscale = (2.0 * k_angle * diff)[:, None]
            np.add.at(grad, ti, gscale * c1)
            np.add.at(grad, tk, gscale * c2)
            np.add.at(grad, tj, -gscale * (c1 + c2))
        if len(pi):
            d = pos[pi] - pos[pj]
            r = np.maximum(np.linalg.norm(d, axis=1), 1e-8)
            close = r < rep_r
            if np.any(close):
                dr = rep_r - r[close]
                e += k_rep * float(np.sum(dr**2))
                g = (-2.0 * k_rep * dr / r[close])[:, None] * d[close]
                np.add.at(grad, pi[close], g)
                np.add.at(grad, pj[close], -g)
        return e, grad.ravel()

    if n == 1:
        return Conformer(np.zeros((1, 3)), 0.0)

    from scipy.optimize import minimize

    res = minimize(
        energy_grad,
        x0.ravel(),
        jac=True,
        method="L-BFGS-B",
        options={"maxiter": max_iters, "ftol": 1e-10},
    )
    pos = res.x.reshape(n, 3)
    pos = pos - pos.mean(axis=0, keepdims=True)
    return Conformer(pos, float(res.fun))


def embed_multiconf(mol: Molecule, num_conf: int = 1, seed: int = 42,
                    max_iters: int = 300):
    """Multi-conformer analog of get_3Dcoords2 (fragments.py:76-108): returns
    (mol, [(conf, energy), ...]) with different seeds per conformer."""
    out = []
    for c in range(num_conf):
        conf = embed_3d(mol, seed=seed + 7919 * c, max_iters=max_iters)
        out.append((conf, conf.energy))
    return mol, out
