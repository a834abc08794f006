"""DTA dataset creation: SMILES + protein sequence + affinity (counterpart
of fragnet_tpu/data/dta.py).

Reference: fragnet/dataset/data.py:541-714 (CreateDataDTA: protein
int-encoding with vocab "ABCDEFGHIKLMNOPQRSTUVWXYZ" → 1..25, max_seq_len
1000) and fragnet/dataset/dta.py (Davis/KIBA creators). A table is a column
dict (column name → list or numpy array) with columns ``smiles``,
``protein`` and ``y``: the synthetic generator's, or a Davis/KIBA-style CSV
read by ``read_dta_csv``.
"""

from __future__ import annotations

import csv
from typing import Dict

import numpy as np

SEQ_VOC = "ABCDEFGHIKLMNOPQRSTUVWXYZ"
SEQ_DICT = {v: i + 1 for i, v in enumerate(SEQ_VOC)}
MAX_SEQ_LEN = 1000


def encode_protein(seq: str, max_len: int = MAX_SEQ_LEN) -> np.ndarray:
    """Integer-encode + zero-pad (data.py:703-714)."""
    x = np.zeros(max_len, dtype=np.int32)
    for i, ch in enumerate(seq[:max_len]):
        x[i] = SEQ_DICT.get(ch, 0)
    return x


def read_dta_csv(path: str) -> Dict[str, object]:
    """A CSV with columns smiles, protein, y (the JAX package reads it with
    ``pd.read_csv``) → a column dict; y as float64."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {"smiles": [r["smiles"] for r in rows],
            "protein": [r["protein"] for r in rows],
            "y": np.array([float(r["y"]) for r in rows], np.float64)}


def build_dta_graphs(df: Dict[str, object], data_type: str = "exp1s",
                     frag_type: str = "brics", seed: int = 42,
                     max_seq_len: int = MAX_SEQ_LEN):
    """df columns: smiles, protein, y → MolGraphs with .protein set."""
    from fragnet_tpu_torch.chem import engine
    from fragnet_tpu_torch.graphs.build import GraphBuilder

    builder = GraphBuilder(data_type)
    out = []
    for smiles, protein, y in zip(df["smiles"], df["protein"], df["y"]):
        r = engine.mol_3d(smiles, seed=seed)
        if r is None:
            continue
        mol, conf = r
        g = builder.build(
            mol, conf, [y], smiles=smiles, frag_type=frag_type,
            protein=encode_protein(str(protein), max_seq_len),
        )
        if g is not None:
            out.append(g)
    return out


_AA = "ACDEFGHIKLMNPQRSTVWY"  # the 20 standard residues


def synthetic_dta_dataset(n: int = 128, seed: int = 0,
                          seq_len_range=(50, 300)) -> Dict[str, object]:
    """Synthetic drug–target pairs with a deterministic affinity surrogate:
    affinity ~ interaction of drug logP with protein hydrophobic fraction.
    The same draws as the JAX package's, as a column dict."""
    from fragnet_tpu_torch.chem.smiles import MolFromSmiles
    from fragnet_tpu_torch.data.synthetic import pseudo_logp, random_smiles

    rng = np.random.default_rng(seed)
    smiles, proteins, ys = [], [], []
    hydrophobic = set("AVILMFWC")
    while len(smiles) < n:
        s = random_smiles(rng)
        if MolFromSmiles(s) is None:
            continue
        L = int(rng.integers(*seq_len_range))
        prot = "".join(rng.choice(list(_AA), L))
        hfrac = sum(c in hydrophobic for c in prot) / L
        y = 5.0 + 0.8 * pseudo_logp(s) * (hfrac - 0.4) * 4.0 + 0.3 * hfrac
        smiles.append(s)
        proteins.append(prot)
        ys.append(y)
    return {"smiles": smiles, "protein": proteins,
            "y": np.array(ys, np.float64)}
