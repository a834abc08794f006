"""Davis-shaped drug–target data: drugs from a featurized pool, protein
sequences with kinase-like lengths, integer-encoded as the DTA reference
encodes them (vocabulary "ABCDEFGHIKLMNOPQRSTUVWXYZ" → 1..25, 0 pads,
cut at 1000), and the affinity surrogate of ``data/dta.py`` (drug logP
against the protein's hydrophobic share).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

SEQ_VOC = "ABCDEFGHIKLMNOPQRSTUVWXYZ"
_AA = "ACDEFGHIKLMNPQRSTVWY"
_HYDROPHOBIC = set("AVILMFWC")


def protein_lengths(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    """Lognormal lengths of the given median and spread, clipped to the
    given range (Davis's kinases run 244-2549 residues)."""
    L = np.exp(rng.normal(np.log(p["median"]), p["sigma"], size=n))
    return np.clip(np.round(L), p["min"], p["max"]).astype(np.int64)


def proteins(rng: np.random.Generator, n: int, p: dict) -> List[str]:
    return ["".join(rng.choice(list(_AA), int(L)))
            for L in protein_lengths(rng, n, p)]


def encode(seq: str, max_len: int) -> np.ndarray:
    x = np.zeros(max_len, np.int32)
    for i, ch in enumerate(seq[:max_len]):
        x[i] = SEQ_VOC.index(ch) + 1 if ch in SEQ_VOC else 0
    return x


def affinity(logp: float, seq: str) -> float:
    hfrac = sum(c in _HYDROPHOBIC for c in seq) / len(seq)
    return 5.0 + 0.8 * logp * (hfrac - 0.4) * 4.0 + 0.3 * hfrac


def logps(smiles: Sequence[str]) -> np.ndarray:
    from fragnet_tpu_torch.data.synthetic import pseudo_logp

    return np.array([pseudo_logp(s) for s in smiles])


def pair_graph(drug, tokens: np.ndarray, y: float):
    """A drug's MolGraph carrying a protein and an affinity (shares the
    drug's arrays)."""
    return dataclasses.replace(drug, protein=tokens,
                               y=np.array([y], np.float32))


def real_lengths(tokens: np.ndarray) -> np.ndarray:
    return (np.asarray(tokens) != 0).sum(axis=-1)


def stack(pairs: Sequence[Tuple[int, int]], drugs, toks, ys):
    return [pair_graph(drugs[d], toks[p], ys[d, p]) for d, p in pairs]
