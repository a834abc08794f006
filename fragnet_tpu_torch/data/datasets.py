"""Dataset creation + persistence.

Reference: fragnet/dataset/dataset.py (FinetuneData:65-111,
load_pickle_dataset:273-277) — SMILES + targets → conformer → FragmentedMol
→ MolGraph arrays, with multiprocessing featurization and pickle
persistence.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from fragnet_tpu_torch.chem import engine
from fragnet_tpu_torch.graphs.build import GraphBuilder, MolGraph


def _featurize_one(args) -> Optional[MolGraph]:
    smiles, y, frag_type, data_type, add_targets, seed = args
    builder = GraphBuilder(data_type, add_dhangles=add_targets)
    r = engine.mol_3d(smiles, seed=seed)
    if r is None:
        return None
    mol, conf = r
    try:
        return builder.build(mol, conf, y, smiles=smiles, frag_type=frag_type)
    except Exception:
        return None


def build_graphs(
    smiles: Sequence[str],
    targets: Sequence,
    frag_type: str = "brics",
    data_type: str = "exp1s",
    add_targets: bool = False,
    seed: int = 42,
    n_workers: int = 0,
    progress: bool = False,
) -> List[MolGraph]:
    """Featurize a list of SMILES into MolGraphs, dropping failures
    (the reference drops no-edge/invalid molecules, data.py:368-371)."""
    jobs = [
        (s, np.atleast_1d(np.asarray(t, dtype=np.float32)), frag_type,
         data_type, add_targets, seed)
        for s, t in zip(smiles, targets)
    ]
    if n_workers and n_workers > 1:
        from multiprocessing import Pool

        with Pool(n_workers) as pool:
            out = pool.map(_featurize_one, jobs, chunksize=16)
    else:
        out = []
        for i, j in enumerate(jobs):
            out.append(_featurize_one(j))
            if progress and (i + 1) % 200 == 0:
                print(f"featurized {i + 1}/{len(jobs)}")
    return [g for g in out if g is not None]


# ---------------------------------------------------------------------------
# persistence (pickle shards, reference dataset/utils.py:41-43,121-156)
# ---------------------------------------------------------------------------

def save_pickle_dataset(graphs: List[MolGraph], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(graphs, f)


def load_pickle_dataset(path: str) -> List[MolGraph]:
    with open(path, "rb") as f:
        return pickle.load(f)
