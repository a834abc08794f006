"""The cells' molecule pools: drug-like SMILES drawn from a fixed pool
seed, featurized once by the program's own data-creation step (the 3D
embedding and the four-level graph build of ``fragnet_tpu_torch``) in
worker processes, and kept as plain arrays under ``perfbench/cache/``.

The cache is keyed by the pool's parameters only (kind, size, size
profile, pool seed, format version), never by a run's ``--seed``. A file is
written under a temporary name in the same directory and renamed into
place, so a run cut off while writing leaves no partial cache behind.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
from typing import Dict, List, Sequence

import numpy as np

FORMAT = 1
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cache")

# MolGraph array fields and the axis along which molecules concatenate
_AXIS1 = ("edge_index", "ei_bonds", "frag_index", "ei_fbonds")


def _fields():
    from fragnet_tpu_torch.graphs.build import MolGraph

    skip = {"smiles", "protein", "gene_expr"}
    return [f.name for f in dataclasses.fields(MolGraph)
            if f.name not in skip]


def draw_smiles(n: int, profile: str, pool_seed: int) -> List[str]:
    """``n`` distinct drug-like SMILES whose heavy-atom counts follow the
    named MoleculeNet size profile (data/synthetic.py)."""
    from fragnet_tpu_torch.data.synthetic import synthetic_dataset

    return list(synthetic_dataset(n=n, task="regression", seed=pool_seed,
                                  profile=profile)["smiles"])


def _featurize_chunk(args):
    """One worker's share: (index, MolGraph or None) for each SMILES."""
    kind, items, conf_seed = args
    from fragnet_tpu_torch.chem import engine
    from fragnet_tpu_torch.data.datasets import PretrainData
    from fragnet_tpu_torch.graphs.build import GraphBuilder

    out = []
    if kind == "pt":
        maker = PretrainData(data_type="exp1s", num_conf=1)
        for i, s in items:
            gs = maker.get_pt_dataset([s], seed=conf_seed)
            out.append((i, gs[0] if gs else None))
        return out
    builder = GraphBuilder("exp1s")
    for i, s in items:
        r = engine.mol_3d(s, seed=conf_seed)
        g = None
        if r is not None:
            g = builder.build(r[0], r[1], [0.0], smiles=s, frag_type="brics")
        out.append((i, g))
    return out


def featurize(kind: str, smiles: Sequence[str], workers: int,
              conf_seed: int = 42) -> list:
    """MolGraphs of ``smiles`` in order; a molecule the featurizer refuses
    comes back as None. ``kind`` "pt" adds the geometric targets and the
    force-field energy (the pretraining set's featurization); "drug" is
    the DTA drugs' (the graph alone)."""
    items = list(enumerate(smiles))
    chunks = [(kind, items[w::workers], conf_seed) for w in range(workers)]
    if workers <= 1:
        parts = [_featurize_chunk(chunks[0])]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            parts = pool.map(_featurize_chunk, chunks)
    got = dict(kv for part in parts for kv in part)
    return [got[i] for i in range(len(smiles))]


def _key(params: Dict) -> str:
    blob = json.dumps({**params, "format": FORMAT}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_graphs(path: str, graphs: list) -> None:
    """The graphs' arrays, concatenated field by field with per-molecule
    counts, as one ``.npz``; written to a temporary name, then renamed."""
    arrays = {"smiles": np.array([g.smiles for g in graphs])}
    for name in _fields():
        vals = [getattr(g, name) for g in graphs]
        if any(v is None for v in vals):
            continue
        axis = 1 if name in _AXIS1 else 0
        arrays[name] = np.concatenate(vals, axis=axis)
        arrays[f"{name}__n"] = np.array([v.shape[axis] for v in vals],
                                        np.int64)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_graphs(path: str) -> list:
    from fragnet_tpu_torch.graphs.build import MolGraph

    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    smiles = [str(s) for s in data["smiles"]]
    n = len(smiles)
    per = {}
    for name in _fields():
        if name not in data:
            per[name] = [None] * n
            continue
        axis = 1 if name in _AXIS1 else 0
        cuts = np.cumsum(data[f"{name}__n"])[:-1]
        per[name] = np.split(data[name], cuts, axis=axis)
    return [MolGraph(smiles=smiles[i], **{k: v[i] for k, v in per.items()})
            for i in range(n)]


def _program_files_hash(paths: Sequence[str]) -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    h = hashlib.sha256()
    for rel in paths:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


# the program's files whose code decides a PadSpec
_SPEC_CODE = ("fragnet_tpu_torch/graphs/hiergraph.py",
              "fragnet_tpu_torch/ops/tcsr.py")


def cached_spec(params: Dict, make):
    """The program's PadSpec for a fixed probe (``make()`` computes it),
    cached under the probe's parameters and a hash of the program code
    that sizes it, so a change to that code is never served a stale
    spec."""
    from fragnet_tpu_torch.graphs.hiergraph import PadSpec

    key = _key({**params, "code": _program_files_hash(_SPEC_CODE)})
    path = os.path.join(CACHE_DIR, f"spec-{key}.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        return PadSpec(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})
    spec = make()
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(spec), f)
    os.replace(tmp, path)
    return spec


def pool(kind: str, n: int, profile: str, pool_seed: int,
         workers: int) -> list:
    """The pool of ``n`` featurized molecules (from the cache when it is
    there; else featurized and cached). SMILES that the featurizer
    refuses are replaced by further draws, so the pool always has ``n``."""
    params = {"kind": kind, "n": n, "profile": profile,
              "pool_seed": pool_seed}
    path = os.path.join(CACHE_DIR, f"pool-{kind}-{_key(params)}.npz")
    if os.path.exists(path):
        return load_graphs(path)
    smiles = draw_smiles(int(n * 1.25) + 8, profile, pool_seed)
    graphs = [g for g in featurize(kind, smiles, workers) if g is not None]
    if len(graphs) < n:
        raise RuntimeError(f"pool {kind}: only {len(graphs)} of {n} "
                           f"molecules featurized")
    graphs = graphs[:n]
    save_graphs(path, graphs)
    return graphs
