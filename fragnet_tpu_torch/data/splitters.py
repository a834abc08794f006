"""Dataset splitters.

* ``scaffold_split``        — deterministic MoleBert split (the split behind
  the reference's published numbers, fragnet/dataset/splitters_molebert.py:
  32-136): group by Murcko scaffold with ``include_chirality=True``
  (splitters_molebert.py:79), sort scaffold sets (by size desc, then
  first-appearance), fill train/val/test to 80/10/10.
* ``random_scaffold_split`` — chainer-chemistry style: scaffold groups
  permuted by ``np.random.RandomState(seed)``, filled valid → test → train
  (splitters_molebert.py:137-209 — note the fill ORDER; train is the
  remainder).
* ``random_split``          — ``random.seed(seed)`` + ``random.shuffle``
  (splitters_molebert.py:210-280; Python's Mersenne stream, so membership
  reproduces the reference exactly).
* ``cv_random_split``       — the reference's is StratifiedKFold(10)
  (splitters_molebert.py:283-317); exposed here as ``cv_stratified_split``,
  while ``cv_random_split`` keeps the plain k-fold used by train/cv.py.
* ``deepchem_scaffold_split`` — DeepChem-style greedy large-sets-first
  (fragnet/dataset/splitters.py:53-173, include_chirality=True default
  at :61).
"""

from __future__ import annotations

import random as _pyrandom
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fragnet_tpu_torch.chem import engine


def generate_scaffold(smiles: str, include_chirality: bool = False) -> Optional[str]:
    return engine.murcko_scaffold_smiles(smiles, include_chirality)


def _scaffold_sets(smiles_list: Sequence[str],
                   include_chirality: bool = True) -> Dict[str, List[int]]:
    sets: Dict[str, List[int]] = defaultdict(list)
    for i, s in enumerate(smiles_list):
        sc = generate_scaffold(s, include_chirality)
        if sc is None:
            sc = f"__invalid_{i}"
        sets[sc].append(i)
    return sets


def scaffold_split(
    smiles_list: Sequence[str],
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
    include_chirality: bool = True,
) -> Tuple[List[int], List[int], List[int]]:
    """Deterministic MoleBert scaffold split (splitters_molebert.py:32-136):
    chirality-aware scaffold keys (:79), sets sorted by (size desc, first
    index asc); greedily fill train until the train cutoff, then valid, then
    test."""
    np.testing.assert_almost_equal(frac_train + frac_valid + frac_test, 1.0)
    n = len(smiles_list)
    sets = _scaffold_sets(smiles_list, include_chirality)
    # MoleBert: sort sets by size (desc), tie-break by smallest index
    all_sets = sorted(
        sets.values(), key=lambda s: (len(s), s[0]), reverse=True
    )
    train_cutoff = frac_train * n
    valid_cutoff = (frac_train + frac_valid) * n
    train, valid, test = [], [], []
    for group in all_sets:
        if len(train) + len(group) > train_cutoff:
            if len(train) + len(valid) + len(group) > valid_cutoff:
                test.extend(group)
            else:
                valid.extend(group)
        else:
            train.extend(group)
    assert len(set(train) & set(valid)) == 0
    assert len(set(valid) & set(test)) == 0
    return train, valid, test


def random_scaffold_split(
    smiles_list: Sequence[str],
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
    seed: int = 0,
    include_chirality: bool = True,
) -> Tuple[List[int], List[int], List[int]]:
    """Reference semantics exactly (splitters_molebert.py:137-209): scaffold
    groups in first-appearance order, permuted with
    ``np.random.RandomState(seed)`` (the legacy MT19937 stream), filled
    valid-first then test (floor cutoffs), train takes the remainder."""
    n = len(smiles_list)
    groups = list(_scaffold_sets(smiles_list, include_chirality).values())
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(groups))
    n_valid = int(np.floor(frac_valid * n))
    n_test = int(np.floor(frac_test * n))
    train, valid, test = [], [], []
    for gi in perm:
        g = groups[gi]
        if len(valid) + len(g) <= n_valid:
            valid.extend(g)
        elif len(test) + len(g) <= n_test:
            test.extend(g)
        else:
            train.extend(g)
    return train, valid, test


def deepchem_scaffold_split(
    smiles_list: Sequence[str],
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
    include_chirality: bool = True,
) -> Tuple[List[int], List[int], List[int]]:
    """DeepChem ScaffoldSplitter (splitters.py:53-173, include_chirality
    defaults True at :61): sets sorted by size desc; fill train, spill to
    valid, then test."""
    sets = _scaffold_sets(smiles_list, include_chirality)
    groups = sorted(sets.values(), key=lambda s: (len(s), -min(s)), reverse=True)
    n = len(smiles_list)
    train_cut = frac_train * n
    valid_cut = (frac_train + frac_valid) * n
    train, valid, test = [], [], []
    for g in groups:
        if len(train) + len(g) > train_cut:
            if len(train) + len(valid) + len(g) > valid_cut:
                test.extend(g)
            else:
                valid.extend(g)
        else:
            train.extend(g)
    return train, valid, test


def random_split(
    n: int,
    frac_train: float = 0.8,
    frac_valid: float = 0.1,
    frac_test: float = 0.1,
    seed: int = 0,
) -> Tuple[List[int], List[int], List[int]]:
    """Reference semantics exactly (splitters_molebert.py:249-253):
    ``random.seed(seed)`` + ``random.shuffle`` over range(n), sliced by
    int-truncated cutoffs — membership reproduces the reference."""
    np.testing.assert_almost_equal(frac_train + frac_valid + frac_test, 1.0)
    all_idx = list(range(n))
    rng = _pyrandom.Random(seed)
    rng.shuffle(all_idx)
    n_train = int(frac_train * n)
    n_valid = int(frac_valid * n)
    return (
        all_idx[:n_train],
        all_idx[n_train : n_train + n_valid],
        all_idx[n_train + n_valid :],
    )


def cv_stratified_split(labels: Sequence, fold_idx: int = 0, seed: int = 0,
                        n_splits: int = 10) -> Tuple[List[int], List[int]]:
    """The reference cv_random_split (splitters_molebert.py:283-317):
    sklearn StratifiedKFold(10, shuffle=True, random_state=seed) over the
    labels; returns the (train, valid) index pair of ``fold_idx``."""
    from sklearn.model_selection import StratifiedKFold

    skf = StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    folds = list(skf.split(np.zeros(len(labels)), list(labels)))
    tr, va = folds[fold_idx]
    return tr.tolist(), va.tolist()


def cv_random_split(n: int, n_folds: int = 5, seed: int = 0) -> List[Tuple[List[int], List[int]]]:
    """Plain k-fold over a permutation (used by train/cv.py — the reference
    CV script gat2_cv.py:113-158 uses sklearn KFold similarly)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, n_folds)
    out = []
    for k in range(n_folds):
        val = folds[k].tolist()
        train = np.concatenate([folds[j] for j in range(n_folds) if j != k]).tolist()
        out.append((train, val))
    return out
