"""GDSC drug-response data pipeline (counterpart of fragnet_tpu/data/gdsc.py)
— the native rebuild of the reference's vendored DeepTTC stack
(fragnet/dataset/ext_data_utils/Step1_getData.py:13-290, deepttc.py:5-29,
cdrp.py:9-66), on column tables (data/tables.py) where the JAX package
uses pandas: the same rows in the same order.

Input files (same names the reference expects in ``data_dir``):

* ``GDSC2_fitted_dose_response_25Feb20.csv`` — drug/cell response pairs.
  The reference reads the ``.xlsx`` of that stem; neither this package's
  machines nor its dependencies read xlsx, so export it to ``.csv`` first.
* ``Drug_listTue_Aug10_2021.csv`` — drug info incl. the PubCHEM column used
  for filtering.
* ``smile_inchi.csv`` — drug_id → SMILES.
* ``Cell_line_RMA_proc_basalExp.txt`` — TSV, genes as rows, ``DATA.<COSMIC>``
  expression columns.

All splits are reproduced: per-cancer stratified (ByCancer), per-drug,
per-cell, and the 5-fold leave-out variants (Step1_getData.py:181-232).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from fragnet_tpu_torch.data import tables
from fragnet_tpu_torch.data.tables import Table

# COSMIC ids whose expression columns are absent from the RMA table
# (Step1_getData.py:38)
BAD_COSMIC_IDS = [908134, 1789883, 908120, 908442]
PAIR_COLS = ["DRUG_ID", "COSMIC_ID", "TCGA_DESC", "LN_IC50", "AUC"]


class RNATable(NamedTuple):
    """RMA expression, cell-line-indexed: row i of ``expr`` (f32, cells ×
    genes) is COSMIC id ``cells[i]``."""
    cells: List[int]
    genes: list
    expr: np.ndarray


def _train_test_split(df: Table, test_size: float, seed: int
                      ) -> Tuple[Table, Table]:
    """Deterministic row split (sklearn.model_selection.train_test_split
    analog; shuffled by seed, the first ceil(n*test_size) of the
    permutation to test)."""
    n = tables.n_rows(df)
    n_test = int(np.ceil(n * test_size)) if test_size < 1 else int(test_size)
    perm = np.random.RandomState(seed).permutation(n)
    return tables.take(df, perm[n_test:]), tables.take(df, perm[:n_test])


def _value_counts(column: list) -> list:
    """The column's distinct present values by count, most frequent first,
    ties in order of first appearance (``Series.value_counts().index``)."""
    counts = {}
    for v in column:
        if not tables.is_missing(v):
            counts[v] = counts.get(v, 0) + 1
    return sorted(counts, key=lambda v: -counts[v])


class GDSCData:
    """Reference ``GetData`` (Step1_getData.py:13): load + filter + split."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.rnafile = os.path.join(data_dir, "Cell_line_RMA_proc_basalExp.txt")
        self.smilefile = os.path.join(data_dir, "smile_inchi.csv")
        self.pairfile = os.path.join(
            data_dir, "GDSC2_fitted_dose_response_25Feb20.xlsx")
        self.drugfile = os.path.join(data_dir, "Drug_listTue_Aug10_2021.csv")

    # -- raw tables --------------------------------------------------------
    def read_pairs(self) -> Table:
        csv_alt = os.path.splitext(self.pairfile)[0] + ".csv"
        if os.path.exists(csv_alt):
            return tables.read_csv(csv_alt)
        raise FileNotFoundError(
            f"{csv_alt} not found: the port reads the response pairs from "
            f"that .csv (export {os.path.basename(self.pairfile)} to it); "
            f"it does not read .xlsx")

    def get_drug(self) -> Table:
        """smile_inchi.csv with drug_id/smiles columns (Step1:30-32 reads
        with index_col=0 — the real file has a leading unnamed index)."""
        df = tables.read_csv(self.smilefile)
        first = next(iter(df))
        if "drug_id" in list(df)[1:]:  # the leading column is an index
            del df[first]
        return df

    def filter_pairs(self, df: Table) -> Table:
        """Drop known-bad COSMIC ids + drugs without a usable PubCHEM entry
        (Step1_getData.py:34-50)."""
        df = tables.where(df, [c not in BAD_COSMIC_IDS
                               for c in df["COSMIC_ID"]])
        pub = tables.read_csv(self.drugfile)
        usable = {d for d, p in zip(pub["drug_id"], pub["PubCHEM"])
                  if not tables.is_missing(p) and p != "none"
                  and p != "several"}
        return tables.where(df, [d in usable for d in df["DRUG_ID"]])

    # -- splits ------------------------------------------------------------
    def _split(self, df: Table, col: str, ratio: float, seed: int):
        """Stratified per-value split (Step1_getData.py:77-100)."""
        trains, tests = [], []
        for value in _value_counts(df[col]):
            sub = tables.where(df, [v == value for v in df[col]], PAIR_COLS)
            tr, te = _train_test_split(sub, ratio, seed)
            trains.append(tr)
            tests.append(te)
        return tables.concat(trains), tables.concat(tests)

    def by_cancer(self, seed: int = 1, test_size: float = 0.05):
        df = self.filter_pairs(self.read_pairs())
        return self._split(df, "TCGA_DESC", test_size, seed)

    def by_drug(self, seed: int = 1, test_size: float = 0.2):
        df = self.filter_pairs(self.read_pairs())
        return self._split(df, "DRUG_ID", test_size, seed)

    def by_cell(self, seed: int = 1, test_size: float = 0.2):
        df = self.filter_pairs(self.read_pairs())
        return self._split(df, "COSMIC_ID", test_size, seed)

    def _leave_out(self, df: Table, col: str, fold: int):
        """5-fold leave-out over distinct values (Step1_getData.py:181-204)."""
        values = list(dict.fromkeys(df[col]))
        per = len(values) // 5
        lo = per * fold
        hi = len(values) if fold == 4 else per * (fold + 1)
        held = set(values[lo:hi])
        keep = ["DRUG_ID", "COSMIC_ID", "TCGA_DESC", "LN_IC50"]
        out = [v in held for v in df[col]]
        return (tables.where(df, [not o for o in out], keep),
                tables.where(df, out, keep))

    def cell_leave_out(self, fold: int):
        df = self.filter_pairs(self.read_pairs())
        return self._leave_out(df, "COSMIC_ID", fold)

    def drug_leave_out(self, fold: int):
        df = self.filter_pairs(self.read_pairs())
        return self._leave_out(df, "DRUG_ID", fold)

    # -- expression --------------------------------------------------------
    def get_rna(self, use_genes: Optional[Sequence[str]] = None) -> RNATable:
        """RMA expression, transposed to cell-line-indexed: cells =
        COSMIC_ID (int), one column per gene (Step1_getData.py:279-290
        reads the per-split DATA.<id> columns; the cell-indexed transpose is
        the batcher-friendly layout here)."""
        rna = tables.read_csv(self.rnafile, sep="\t")
        if use_genes is not None and "GENE_SYMBOLS" in rna:
            wanted = set(use_genes)
            rna = tables.where(rna, [g in wanted
                                     for g in rna["GENE_SYMBOLS"]])
        data_cols = [c for c in rna if c.startswith("DATA.")]
        mat = np.array([rna[c] for c in data_cols], np.float64).reshape(
            len(data_cols), -1).astype(np.float32)
        cells = [int(c.split(".", 1)[1]) for c in data_cols]
        genes = (list(rna["GENE_SYMBOLS"]) if "GENE_SYMBOLS" in rna
                 else [f"g{i}" for i in range(mat.shape[1])])
        return RNATable(cells, genes, mat)


def encode_pairs(gdsc: GDSCData, *frames: Table) -> List[Table]:
    """DeepTTC ``DataEncoding.encode2`` (deepttc.py:9-29): attach SMILES by
    DRUG_ID and Label = LN_IC50."""
    drug_smiles = gdsc.get_drug()
    id2smi = dict(zip(drug_smiles["drug_id"], drug_smiles["smiles"]))
    out = []
    for df in frames:
        df = tables.where(df, [d in id2smi for d in df["DRUG_ID"]])
        df["smiles"] = [id2smi[i] for i in df["DRUG_ID"]]
        df["Label"] = list(df["LN_IC50"])
        out.append(df)
    return out


def create_gdsc_cdrp_dataset(
    data_dir: str,
    output_dir: str,
    data_type: str = "exp1s",
    frag_type: str = "brics",
    use_genes: Optional[Sequence[str]] = None,
    seed: int = 1,
    test_size: float = 0.05,
    val_size: float = 0.1,
):
    """Reference ``create_cdrp_dataset`` (fragnet/dataset/cdrp.py:9-66):
    ByCancer split → val carve-out → encode → featurize → train/val/test.pkl
    (what data/cdrp.py's graphs and the port's load_pickle_dataset read),
    beside each split's rows as ``{name}.csv``."""
    from fragnet_tpu_torch.data.cdrp import build_cdrp_graphs
    from fragnet_tpu_torch.data.datasets import save_pickle_dataset

    os.makedirs(output_dir, exist_ok=True)
    gdsc = GDSCData(data_dir)
    train, test = gdsc.by_cancer(seed=seed, test_size=test_size)
    train, val = _train_test_split(train, val_size, seed)
    train, val, test = encode_pairs(gdsc, train, val, test)
    rna = gdsc.get_rna(use_genes=use_genes)

    counts = {}
    for name, df in (("train", train), ("val", val), ("test", test)):
        tables.write_csv(df, os.path.join(output_dir, f"{name}.csv"))
        feat = {"smiles": df["smiles"], "cell_line": df["COSMIC_ID"],
                "y": df["Label"]}
        graphs = build_cdrp_graphs(
            feat, (rna.cells, rna.expr), data_type=data_type,
            frag_type=frag_type)
        save_pickle_dataset(
            graphs, os.path.join(output_dir, f"{name}.pkl"))
        counts[name] = len(graphs)
    return counts
