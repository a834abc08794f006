"""Dataset creation + persistence.

Reference: fragnet/dataset/dataset.py (FinetuneData:65-111, get_pt_dataset:
19-62, load_pickle_dataset:273-277, load_data_parts:280-292) — SMILES +
targets → conformer → FragmentedMol → MolGraph arrays, with multiprocessing
featurization and pickle shard persistence.

A table is a column dict (column name → a list or numpy array, with
``"smiles"``), where the JAX package takes a pandas DataFrame; a DataFrame
also works, since only ``df[column]`` is read.

Pickles written by the JAX package hold ``fragnet_tpu.graphs.build.MolGraph``
objects; ``load_pickle_dataset`` maps that class to the port's MolGraph, so
reading them never imports the JAX package.
"""

from __future__ import annotations

import glob
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


def _target_rows(df, target) -> List[list]:
    """Each row's targets: the ``target`` column (a name) or columns (a
    list or tuple), one list per row."""
    names = list(target) if isinstance(target, (list, tuple)) else [target]
    return [list(row) for row in zip(*(list(df[t]) for t in names))]


class FinetuneData:
    """Table → graphs (reference FinetuneData, dataset.py:65-111)."""

    def __init__(self, target_name, data_type: str = "exp1s",
                 frag_type: str = "brics"):
        self.target = target_name
        self.data_type = data_type
        self.frag_type = frag_type

    def get_ft_dataset(self, df, n_workers: int = 0) -> List[MolGraph]:
        return build_graphs(
            list(df["smiles"]), _target_rows(df, self.target),
            frag_type=self.frag_type, data_type=self.data_type,
            n_workers=n_workers,
        )


class FinetuneMultiConfData:
    """Table → finetune graphs with multiple conformers per SMILES
    (reference FinetuneMultiConfData, dataset.py:225-270: 10 ETKDG/MMFF
    conformers each, all sharing the molecule's label)."""

    def __init__(self, target_name, data_type: str = "exp1s",
                 frag_type: str = "brics", num_conf: int = 10,
                 max_iters: int = 500):
        self.target = target_name
        self.data_type = data_type
        self.frag_type = frag_type
        self.num_conf = num_conf
        self.max_iters = max_iters

    def get_ft_dataset(self, df, seed: int = 42) -> List[MolGraph]:
        builder = GraphBuilder(self.data_type)
        out: List[MolGraph] = []
        for s, y in zip(df["smiles"], _target_rows(df, self.target)):
            r = engine.mol_3d_multi(s, num_conf=self.num_conf, seed=seed,
                                    max_iters=self.max_iters)
            if r is None:
                continue
            mol, confs = r
            for conf, _energy in confs:
                g = builder.build(mol, conf, y, smiles=s,
                                  frag_type=self.frag_type)
                if g is not None:
                    out.append(g)
        return out


class PretrainData:
    """SMILES → multi-conformer pretrain graphs with geometric targets and
    force-field energy as y (reference get_pt_dataset, dataset.py:19-62)."""

    def __init__(self, data_type: str = "exp1s", frag_type: str = "brics",
                 num_conf: int = 1, max_iters: int = 200,
                 compat_reference_targets: bool = False):
        self.data_type = data_type
        self.frag_type = frag_type
        self.num_conf = num_conf
        self.max_iters = max_iters
        self.compat_reference_targets = compat_reference_targets

    def get_pt_dataset(self, smiles: Sequence[str], seed: int = 42) -> List[MolGraph]:
        builder = GraphBuilder(
            self.data_type, add_dhangles=True,
            compat_reference_targets=self.compat_reference_targets)
        out = []
        for s in smiles:
            r = engine.mol_3d_multi(s, num_conf=self.num_conf, seed=seed,
                                    max_iters=self.max_iters)
            if r is None:
                continue
            mol, confs = r
            for conf, energy in confs:
                g = builder.build(mol, conf, [energy], smiles=s,
                                  frag_type=self.frag_type)
                if g is not None:
                    out.append(g)
        return out


# ---------------------------------------------------------------------------
# persistence (pickle shards, reference dataset/utils.py:41-43,121-156)
# ---------------------------------------------------------------------------

def save_pickle_dataset(graphs: List[MolGraph], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(graphs, f)


class _GraphUnpickler(pickle.Unpickler):
    """Reads the JAX package's MolGraph pickles as the port's MolGraph."""

    def find_class(self, module, name):
        if module == "fragnet_tpu.graphs.build" and name == "MolGraph":
            return MolGraph
        return super().find_class(module, name)


def load_pickle_dataset(path: str) -> List[MolGraph]:
    with open(path, "rb") as f:
        return _GraphUnpickler(f).load()


def save_ds_parts(graphs: List[MolGraph], out_dir: str, name: str = "part",
                  shard_size: int = 1000) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i in range(0, len(graphs), shard_size):
        save_pickle_dataset(
            graphs[i : i + shard_size],
            os.path.join(out_dir, f"{name}_{i // shard_size:05d}.pkl"),
        )


def load_data_parts(dir_or_glob: str, dedup: bool = True) -> List[MolGraph]:
    """Load shards; optionally dedup by SMILES (pretrain_gat2.py:133-135)."""
    paths = (
        sorted(glob.glob(os.path.join(dir_or_glob, "*.pkl")))
        if os.path.isdir(dir_or_glob)
        else sorted(glob.glob(dir_or_glob))
    )
    out: List[MolGraph] = []
    seen = set()
    for p in paths:
        for g in load_pickle_dataset(p):
            if dedup:
                if g.smiles in seen:
                    continue
                seen.add(g.smiles)
            out.append(g)
    return out
