"""MoleculeNet dataset registry + CSV loaders.

The reference vendors MoleBert's per-dataset CSV parsers
(fragnet/dataset/loader_molebert.py:976-1378) and downloads raw CSVs via
torch_geometric. Here: the same datasets and target columns, reading
user-supplied CSV files (no network egress in TPU pods); when a CSV is
absent, ``load_moleculenet`` can fall back to a synthetic stand-in so
pipelines stay runnable.

Target conventions follow the reference: regression targets as floats;
classification labels mapped to {0,1} with −1 for missing (the masked-BCE
convention, train/utils.py:422-429).

A dataset is a column table: an insertion-ordered dict with ``"smiles"`` (a
list of str) first and one float64 array per target column.
"""

from __future__ import annotations

import os
import csv
from typing import Dict, List, Optional

import numpy as np

# name -> (smiles column, target columns or None=all-but-smiles, task type)
MOLECULENET_REGISTRY: Dict[str, dict] = {
    "esol": dict(smiles="smiles",
                 targets=["measured log solubility in mols per litre"],
                 task="regression", aliases=["delaney"]),
    "freesolv": dict(smiles="smiles", targets=["expt"], task="regression"),
    "lipo": dict(smiles="smiles", targets=["exp"], task="regression",
                 aliases=["lipophilicity"]),
    "bace": dict(smiles="mol", targets=["Class"], task="classification"),
    "bbbp": dict(smiles="smiles", targets=["p_np"], task="classification"),
    "clintox": dict(smiles="smiles", targets=["FDA_APPROVED", "CT_TOX"],
                    task="classification"),
    "hiv": dict(smiles="smiles", targets=["HIV_active"], task="classification"),
    "sider": dict(smiles="smiles", targets=None, task="classification"),
    "tox21": dict(smiles="smiles", targets=None, task="classification"),
    "toxcast": dict(smiles="smiles", targets=None, task="classification"),
    "muv": dict(smiles="smiles", targets=None, task="classification"),
    "pcba": dict(smiles="smiles", targets=None, task="classification"),
}


def _canonical_name(name: str) -> str:
    name = name.lower()
    for key, info in MOLECULENET_REGISTRY.items():
        if name == key or name in info.get("aliases", []):
            return key
    raise KeyError(f"unknown MoleculeNet dataset {name!r}")


def _to_float(v: str) -> float:
    try:
        return float(v)
    except ValueError:
        return float("nan")


def load_moleculenet_csv(name: str, csv_path: str) -> Dict[str, object]:
    """Read a raw MoleculeNet CSV into the canonical (smiles, y...) table.
    Classification labels → {0,1}, NaN → −1 (loader_molebert conventions);
    regression rows with a missing value are dropped."""
    key = _canonical_name(name)
    info = MOLECULENET_REGISTRY[key]
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    header = list(rows[0].keys()) if rows else []
    targets = info["targets"]
    if targets is None:
        targets = [c for c in header
                   if c not in (info["smiles"], "mol_id", "ID")]
    smiles = [r[info["smiles"]] for r in rows]
    cols = {t: np.array([_to_float(r[t]) for r in rows], np.float64)
            for t in targets}
    if info["task"] == "classification":
        for t, col in cols.items():
            col = np.where(np.isnan(col), -1.0, col)
            cols[t] = np.where(col < 0, -1.0, np.where(col > 0, 1.0, 0.0))
    else:
        keep = np.ones(len(rows), bool)
        for col in cols.values():
            keep &= ~np.isnan(col)
        smiles = [s for s, k in zip(smiles, keep) if k]
        cols = {t: col[keep] for t, col in cols.items()}
    return {"smiles": smiles, **cols}


def load_moleculenet(
    name: str,
    data_dir: Optional[str] = None,
    allow_synthetic: bool = True,
    n_synthetic: int = 512,
    seed: int = 0,
) -> Dict[str, object]:
    """Load a MoleculeNet dataset from ``data_dir/{name}.csv``; if absent and
    ``allow_synthetic``, return a synthetic stand-in with matching task type
    and column layout."""
    key = _canonical_name(name)
    info = MOLECULENET_REGISTRY[key]
    if data_dir:
        for cand in (f"{key}.csv", f"{name}.csv", "raw.csv"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return load_moleculenet_csv(key, p)
    if not allow_synthetic:
        raise FileNotFoundError(f"no CSV for {name!r} under {data_dir!r}")
    from fragnet_tpu_torch.data.synthetic import synthetic_dataset

    n_tasks = len(info["targets"]) if info["targets"] else 3
    df = synthetic_dataset(
        n=n_synthetic,
        task="regression" if info["task"] == "regression" else "classification",
        seed=seed,
        n_tasks=n_tasks,
    )
    # rename to the canonical target columns
    tcols = target_columns(df)
    names = info["targets"] or [f"task_{i}" for i in range(len(tcols))]
    return {"smiles": df["smiles"],
            **{n: df[c] for c, n in zip(tcols, names[: len(tcols)])}}


def target_columns(df: Dict[str, object]) -> List[str]:
    return [c for c in df if c != "smiles"]


class MoleculeDataset:
    """Routing façade over the per-dataset loaders — the analog of
    fragnet/dataset/custom_dataset.py:7-27 (MoleBert-loader routing for
    tox21/toxcast/clintox/sider/bbbp/hiv/muv/pcba). ``get_data`` returns the
    list-of-records shape the reference builds from PyG ``Data`` objects."""

    ROUTED = ("tox21", "toxcast", "clintox", "sider", "bbbp", "hiv",
              "muv", "pcba")

    def __init__(self, name: str, data_dir: Optional[str] = None):
        self.name = _canonical_name(name)
        if self.name not in self.ROUTED:
            raise KeyError(f"{name!r} is not routed by MoleculeDataset "
                           f"(custom_dataset.py:12-27); use load_moleculenet")
        self.data_dir = data_dir

    def get_data(self) -> List[dict]:
        # reference reads data_dir/<name>/raw/<name>.csv
        # (custom_dataset.py:31-33); accept that layout plus flat CSVs
        candidates = []
        if self.data_dir:
            candidates = [
                os.path.join(self.data_dir, self.name, "raw",
                             f"{self.name}.csv"),
                os.path.join(self.data_dir, f"{self.name}.csv"),
            ]
        df = None
        for p in candidates:
            if os.path.exists(p):
                df = load_moleculenet_csv(self.name, p)
                break
        if df is None:
            df = load_moleculenet(self.name, data_dir=self.data_dir)
        tcols = target_columns(df)
        return [
            {"smiles": s, "y": [[float(df[t][i]) for t in tcols]]}
            for i, s in enumerate(df["smiles"])
            if s is not None
        ]
