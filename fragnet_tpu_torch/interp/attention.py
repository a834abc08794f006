"""FragNetInterpreter — the serving façade for interpretability
(counterpart of fragnet_tpu/interp/attention.py).

The analog of FragNetVizApp (fragnet/vizualize/viz.py:576-691): featurize one
SMILES on the fly, run the model once with attention extraction, and expose
the four weight levels (atoms / bonds / fragments / fragment-connections)
plus masking contributions (interp/attribution.py). Bond weights fold the
two directed edges by averaging and are min-max scaled (viz.py:684-690).
The batches carry TCSR metadata and dense planes, so on the card every GAT
pass runs a kernel (a batch without them raises there); on the CPU the same
code runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from fragnet_tpu_torch.chem import engine
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder, MolGraph
from fragnet_tpu_torch.interp.attribution import (atom_contributions,
                                                  bond_contributions,
                                                  family_sizes,
                                                  fconn_contributions,
                                                  fragment_contributions,
                                                  pad_graphs, predict)


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


@dataclasses.dataclass
class InterpResult:
    smiles: str
    prediction: float
    atom_weights: np.ndarray      # (n_atoms,) min-max scaled attention
    bond_weights: np.ndarray      # (n_bonds,) directed-pair-averaged, scaled
    frag_weights: np.ndarray      # (n_frags,)
    fconn_weights: np.ndarray     # (n_connections,)
    atom_contrib: Optional[np.ndarray] = None
    bond_contrib: Optional[np.ndarray] = None
    frag_contrib: Optional[np.ndarray] = None
    fconn_contrib: Optional[np.ndarray] = None
    graph: Optional[MolGraph] = None
    mol: Optional[object] = None
    # per folded connection k: the (atom_i, atom_j) of the REAL bond it cuts
    # (self_cn/iso_cn3 fall back to one atom from each fragment) — the
    # reference's connection→bond highlight map (viz.py:366-393)
    fconn_bonds: Optional[list] = None


def fconn_real_bonds(fragmented) -> list:
    """Map each fragment connection to a pair of real atom indices
    (reference get_regbond_ids_for_fragbond_ids, viz.py:366-393). Ordering
    matches the builder's connection order, i.e. the folded fconn weight
    index."""
    out = []
    for cn in fragmented.connections:
        if cn.bond_id is not None:
            out.append(tuple(cn.atom_indices))
        else:
            # no real bond (self_cn single-fragment loop / iso_cn3 between
            # disconnected components): arbitrary representative atoms
            # (viz.py:389-393)
            f1, f2 = cn.frags
            out.append((sorted(f1.atom_indices)[0],
                        sorted(f2.atom_indices)[0]))
    return out


class FragNetInterpreter:
    """Wraps a finetuned port model for single-molecule interpretation on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, model, data_type: str = "exp1s",
                 frag_type: str = "brics", device="cuda"):
        from fragnet_tpu_torch.train.fastpath import resolve_device

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.builder = GraphBuilder(data_type)
        self.frag_type = frag_type

    def featurize(self, smiles: str):
        """(MolGraph, mol, the one-molecule batch on the device)."""
        r = engine.mol_3d(smiles)
        if r is None:
            raise ValueError(f"could not parse/embed {smiles!r}")
        mol, conf = r
        g = self.builder.build(mol, conf, [0.0], smiles=smiles,
                               frag_type=self.frag_type)
        if g is None:
            raise ValueError(f"could not featurize {smiles!r}")
        return g, mol, to_device(pad_graphs([g]), self.device)

    def predict(self, batch, hooks=None, return_attentions: bool = False):
        """The model on ``batch`` (host or device), dropout off."""
        return predict(self.model, batch, hooks, return_attentions)

    def interpret(self, smiles: str, with_contributions: bool = True
                  ) -> InterpResult:
        g, mol, batch = self.featurize(smiles)
        pred, attn = self.predict(batch, return_attentions=True)
        n_atoms, n_edges = g.n_atoms, g.n_edges
        n_frags, n_conn = g.n_frags, g.n_fconn

        def summed(a, n):
            return a[:n].sum(dim=1).cpu().numpy()

        atom_w = summed(attn.atoms, n_atoms)
        frag_w = summed(attn.frags, n_frags)
        bond_dir_w = summed(attn.bonds, n_edges)
        fconn_dir_w = summed(attn.fbonds, n_conn)

        # fold directed pairs (2k, 2k+1) by averaging (viz.py:684-689)
        bond_w = 0.5 * (bond_dir_w[0::2] + bond_dir_w[1::2])
        if n_conn >= 2 and n_frags > 1:
            fconn_w = 0.5 * (fconn_dir_w[0::2] + fconn_dir_w[1::2])
        else:
            fconn_w = fconn_dir_w

        from fragnet_tpu_torch.chem.fragments import FragmentedMol

        fm = FragmentedMol(mol, None, self.frag_type)
        result = InterpResult(
            smiles=smiles,
            prediction=float(pred[0, 0]),
            atom_weights=_minmax(atom_w),
            bond_weights=_minmax(bond_w),
            frag_weights=_minmax(frag_w),
            fconn_weights=_minmax(fconn_w),
            graph=g,
            mol=mol,
            fconn_bonds=fconn_real_bonds(fm),
        )

        if with_contributions:
            n = family_sizes(g)
            result.atom_contrib = atom_contributions(self.model, g,
                                                     n["atom"])
            result.bond_contrib = bond_contributions(self.model, g,
                                                     n["bond"])
            result.frag_contrib = fragment_contributions(self.model, g,
                                                         n["fragment"])
            result.fconn_contrib = fconn_contributions(self.model, g,
                                                       n["fconn"])
        return result
