"""The port's ingest (fragnet_tpu_torch/data/: lmdb_io, gdsc, create,
tables, and datasets' / moleculenet's table classes) against fragnet_tpu's
on tiny inputs written at run time, on the CPU:

* LMDB: round trips (one leaf, branch and overflow pages, empty), the two
  writers' files byte for byte, each reader on the other's file, the
  UniMol record semantics;
* GDSC on a copy of tests/test_ingest.py's ``gdsc_dir`` layout: the raw
  and filtered pairs, every split (by cancer, drug and cell; the five
  leave-out folds of each) and ``get_rna`` row for row equal to the JAX
  package's DataFrames, floats parsed bit for bit as pandas parses them;
  a pair table only in .xlsx refused with the accepted .csv named;
* every ``data.create`` subcommand (finetune, pretrain from a CSV and from
  a UniMol LMDB, dta, cdrp, scaffold_from_df, simsgt, gdsc through
  ``create_gdsc_cdrp_dataset``) writes the files the JAX ``create``
  writes, pickles of graphs equal field by field and CSVs equal text for
  text;
* ``FinetuneData``, ``FinetuneMultiConfData`` and ``MoleculeDataset`` on
  column tables against the JAX classes on DataFrames;
* the MoleculeNet downloader (data/download.py) through file:// URLs:
  plain, gzipped and aliased sources byte for byte against the JAX
  package's function, an existing file, the no-egress error, the CLI;
* no port module imports pandas.
"""

import argparse
import ast
import dataclasses
import gzip
import math
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from threadpoolctl import threadpool_limits

import fragnet_tpu.data.create as jax_create
import fragnet_tpu.data.gdsc as jax_gdsc
import fragnet_tpu.data.lmdb_io as jax_lmdb

import fragnet_tpu_torch.data.create as port_create
import fragnet_tpu_torch.data.gdsc as port_gdsc
import fragnet_tpu_torch.data.lmdb_io as port_lmdb
from fragnet_tpu_torch.data import tables
from fragnet_tpu_torch.data.datasets import load_pickle_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SMILES = ["CCO", "c1ccccc1", "CCN", "CC(=O)O", "C1CCCCC1", "CCCl",
                "c1ccncc1", "OCCO"]


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """The featurizer's small numpy / scipy calls on one BLAS thread, so
    that test workers sharing the host's cores do not oversubscribe them
    (OpenBLAS's own threads made featurizing 30× slower beside the other
    workers)."""
    with threadpool_limits(limits=1):
        yield


# --------------------------------------------------------------------------
# LMDB
# --------------------------------------------------------------------------

def _lmdb_items(kind):
    if kind == "empty":
        return {}
    if kind == "leaf":
        return {f"k{i}".encode(): f"value-{i}".encode() for i in range(10)}
    rng = random.Random(0)
    return {f"key-{i:05d}".encode():
            bytes(rng.getrandbits(8)
                  for _ in range(rng.choice([10, 100, 5000, 9000])))
            for i in range(400)}


@pytest.mark.parametrize("kind", ["leaf", "branch-overflow", "empty"])
def test_lmdb_round_trip_and_bytes_match_jax(tmp_path, kind):
    items = _lmdb_items(kind)
    pp, jp = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    port_lmdb.write_lmdb(pp, items)
    jax_lmdb.write_lmdb(jp, items)
    with open(pp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    for path in (pp, jp):
        r = port_lmdb.LMDBReader(path)
        assert dict(r.items()) == items and len(r) == len(items)
        assert r.keys() == sorted(items)
    if kind == "leaf":
        r = port_lmdb.LMDBReader(jp)
        assert r.get(b"k3") == b"value-3" and r.get(b"missing") is None


def test_unimol_lmdb_matches_jax(tmp_path):
    recs = [{"smiles": f"C{'C' * (i % 5)}O", "target": [float(i)]}
            for i in range(30)]
    pp, jp = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    port_lmdb.write_unimol_lmdb(pp, recs)
    jax_lmdb.write_unimol_lmdb(jp, recs)
    with open(pp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    for name in (None, "tox21"):
        got = port_lmdb.read_unimol_lmdb(jp, name=name)
        assert got == jax_lmdb.read_unimol_lmdb(jp, name=name)
    assert isinstance(got[0]["target"][0], list)  # multi-task wrapping
    bad = str(tmp_path / "bad.lmdb")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 8192)
    with pytest.raises(ValueError):
        port_lmdb.LMDBReader(bad)


# --------------------------------------------------------------------------
# GDSC
# --------------------------------------------------------------------------

def _gdsc_files(d, n_cells):
    """tests/test_ingest.py's synthetic GDSC file set (the reference's
    layout) for ``n_cells`` cell lines, with one response row's TCGA_DESC
    missing."""
    d.mkdir()
    rng = np.random.default_rng(0)
    cosmic = [100 + i for i in range(n_cells)] + [908134]  # one known-bad id
    drugs = [1, 2, 3, 4]
    rows = []
    for c in cosmic:
        for dr in drugs:
            rows.append(dict(
                DRUG_ID=dr, COSMIC_ID=c,
                TCGA_DESC=["BRCA", "LUAD", "SKCM"][c % 3]
                if (c, dr) != (105, 2) else None,
                LN_IC50=float(rng.normal()), AUC=float(rng.uniform()),
            ))
    pd.DataFrame(rows).to_csv(
        d / "GDSC2_fitted_dose_response_25Feb20.csv", index=False)
    pd.DataFrame({
        "drug_id": drugs, "PubCHEM": ["11", "22", "none", "44"],
    }).to_csv(d / "Drug_listTue_Aug10_2021.csv", index=False)
    pd.DataFrame({
        "drug_id": drugs,
        "smiles": ["CCO", "c1ccccc1", "CCN", "CC(=O)O"],
    }).to_csv(d / "smile_inchi.csv")  # with the leading index column
    genes = [f"G{j}" for j in range(7)]
    rna = pd.DataFrame({"GENE_SYMBOLS": genes})
    for c in cosmic[:-1]:
        rna[f"DATA.{c}"] = rng.normal(size=len(genes)).astype(np.float32)
    rna.to_csv(d / "Cell_line_RMA_proc_basalExp.txt", sep="\t", index=False)
    return str(d)


@pytest.fixture()
def gdsc_dir(tmp_path):
    return _gdsc_files(tmp_path / "gdsc", 12)


def _rows(df: pd.DataFrame):
    """A DataFrame as a column table (NaN and None alike as missing)."""
    return {c: [None if (v is None or (isinstance(v, float)
                                       and math.isnan(v))) else v
                for v in df[c].tolist()] for c in df.columns}


def _port_rows(t):
    return {c: [None if tables.is_missing(v) else v for v in col]
            for c, col in t.items()}


def _same(port_table, jax_df):
    got, want = _port_rows(port_table), _rows(jax_df)
    assert list(got) == list(want)
    for c in want:
        assert got[c] == want[c], c


def test_gdsc_tables_match_jax(gdsc_dir):
    """Raw and filtered pairs, every split and leave-out fold, the drug
    table and the expression table: the same rows in the same order."""
    j, p = jax_gdsc.GDSCData(gdsc_dir), port_gdsc.GDSCData(gdsc_dir)
    _same(p.read_pairs(), j.read_pairs())
    filt = p.filter_pairs(p.read_pairs())
    _same(filt, j.filter_pairs(j.read_pairs()))
    assert 908134 not in filt["COSMIC_ID"] and 3 not in filt["DRUG_ID"]
    _same(p.get_drug(), j.get_drug())
    for split in ("by_cancer", "by_drug", "by_cell"):
        for seed, ts in ((1, 0.05), (42, 0.2), (7, 0.5)):
            got = getattr(p, split)(seed=seed, test_size=ts)
            want = getattr(j, split)(seed=seed, test_size=ts)
            for a, b in zip(got, want):
                _same(a, b)
    tr, te = p.by_cancer(seed=1, test_size=0.2)
    assert None not in tr["TCGA_DESC"] + te["TCGA_DESC"]  # NaN group dropped
    for fold in range(5):
        for name in ("cell_leave_out", "drug_leave_out"):
            for a, b in zip(getattr(p, name)(fold), getattr(j, name)(fold)):
                _same(a, b)
    for genes in (None, ["G0", "G3", "G6"]):
        got, want = p.get_rna(use_genes=genes), j.get_rna(use_genes=genes)
        assert got.cells == list(want.index)
        assert got.genes == list(want.columns)
        assert got.expr.dtype == np.float32
        np.testing.assert_array_equal(got.expr, want.to_numpy())
    t = {"a": list(range(23)), "b": [float(i) / 7 for i in range(23)]}
    for a, b in zip(port_gdsc._train_test_split(t, 0.2, 42),
                    jax_gdsc._train_test_split(pd.DataFrame(t), 0.2, 42)):
        _same(a, b)


def test_gdsc_pairs_only_in_xlsx_are_refused(tmp_path):
    d = tmp_path / "only_xlsx"
    d.mkdir()
    (d / "GDSC2_fitted_dose_response_25Feb20.xlsx").write_bytes(b"PK")
    with pytest.raises(FileNotFoundError,
                       match="GDSC2_fitted_dose_response_25Feb20.csv"):
        port_gdsc.GDSCData(str(d)).read_pairs()


def _graphs_equal(port_graphs, jax_graphs):
    assert len(port_graphs) == len(jax_graphs)
    for a, b in zip(port_graphs, jax_graphs):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert set(fa) == set(fb)
        for k in fb:
            if isinstance(fb[k], np.ndarray):
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
                assert fa[k].dtype == fb[k].dtype, k
            else:
                assert fa[k] == fb[k], k


def _same_outputs(port_out, jax_out):
    """The two output trees hold the same files: pickles of equal graphs,
    CSVs of equal text."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(jax_out)
    assert names and files(port_out) == names
    for name in names:
        p, j = os.path.join(port_out, name), os.path.join(jax_out, name)
        if name.endswith(".pkl"):
            with open(j, "rb") as f:
                want = pickle.load(f)
            _graphs_equal(load_pickle_dataset(p), want)
        else:
            with open(p) as f, open(j) as g:
                assert f.read() == g.read(), name
    return names


# --------------------------------------------------------------------------
# the create CLI
# --------------------------------------------------------------------------

def _ns(out, **kw):
    base = dict(out=out, csv=None, data_type="exp1s", frag_type="brics",
                seed=42, n_synthetic=3, workers=0)
    base.update(kw)
    return argparse.Namespace(**base)


def _write(path, header, rows):
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    return str(path)


def _inputs(tmp_path):
    """{case: (create function name, argument overrides)} on tiny CSVs
    (GDSC: the layout above for 4 cell lines, 12 pairs kept)."""
    rng = np.random.default_rng(3)
    vals = [repr(float(v)) for v in rng.standard_normal(len(SMALL_SMILES))]
    esol = _write(tmp_path / "esol.csv",
                  ["smiles", "measured log solubility in mols per litre"],
                  zip(SMALL_SMILES[:6], vals))
    bbbp = _write(tmp_path / "bbbp.csv", ["smiles", "p_np"],
                  zip(SMALL_SMILES[:6], [1, 0, 1, 1, 0, 0]))
    cep = _write(tmp_path / "cep.csv", ["smiles", "pce", "gap"],
                 zip(SMALL_SMILES[:6], vals, vals[::-1]))
    pt_csv = _write(tmp_path / "pt.csv", ["smiles"],
                    [[s] for s in SMALL_SMILES[:4]])
    lmdb = str(tmp_path / "ligands.lmdb")
    jax_lmdb.write_unimol_lmdb(lmdb, [{"smiles": s, "target": [0.0]}
                                      for s in SMALL_SMILES[4:8]])
    prot = ["MKVLAAGIVG", "ACDEFGHIKL", "WYVTSRQPNM"]
    dta = [(s, prot[i % 3], vals[i]) for i, s in enumerate(SMALL_SMILES[:6])]
    dta_tr = _write(tmp_path / "davis_train.csv", ["smiles", "protein", "y"],
                    dta[:4])
    dta_te = _write(tmp_path / "davis_test.csv", ["smiles", "protein", "y"],
                    dta[4:])
    cdrp = _write(tmp_path / "cdrp.csv", ["smiles", "cell_line", "y"],
                  [(s, f"C{i % 2}", vals[i])
                   for i, s in enumerate(SMALL_SMILES[:4])] + [
                      ("CCO", "C9", "1.0")])  # no expression row: skipped
    genes = _write(tmp_path / "genes.csv", ["cell", "g0", "g1", "g2"],
                   [("C0", 0.5, -1.25, 2.0), ("C1", 1.5, 0.25, -0.75)])
    return {
        "finetune-scaffold": ("create_finetune", dict(
            dataset="esol", csv=esol, data_dir=None, split="scaffold")),
        "finetune-random": ("create_finetune", dict(
            dataset="esol", csv=esol, data_dir=None, split="random")),
        "pretrain-csv": ("create_pretrain", dict(
            csv=pt_csv, shard_size=3, mode="scratch", num_conf=1,
            lmdb=None)),
        "pretrain-lmdb": ("create_pretrain", dict(
            shard_size=2, mode="scratch", num_conf=1, lmdb=lmdb)),
        "dta-folds": ("create_dta", dict(
            train_csv=dta_tr, val_csv=None, test_csv=dta_te)),
        "dta-single": ("create_dta", dict(
            csv=dta_te, train_csv=None, val_csv=None, test_csv=None)),
        "cdrp": ("create_cdrp", dict(csv=cdrp, gene_csv=genes)),
        "scaffold_from_df": ("create_scaffold_from_df", dict(
            csv=cep, target_name=None)),
        "scaffold_from_df-target": ("create_scaffold_from_df", dict(
            csv=cep, target_name="gap")),
        "simsgt": ("create_simsgt", dict(
            dataset="bbbp", csv=bbbp, data_dir=None)),
        "gdsc": ("create_gdsc", dict(
            data_dir=_gdsc_files(tmp_path / "gdsc", 4), genes_file=None)),
    }


CASES = ["finetune-scaffold", "finetune-random", "pretrain-csv",
         "pretrain-lmdb", "dta-folds", "dta-single", "cdrp",
         "scaffold_from_df", "scaffold_from_df-target", "simsgt", "gdsc"]


@pytest.mark.parametrize("case", CASES)
def test_create_subcommand_matches_jax(tmp_path, case):
    """The subcommand's function in both packages on the same inputs: the
    same files, graphs equal field by field, CSVs equal text for text (for
    gdsc, create_gdsc_cdrp_dataset's train / val / test CSVs and pickles,
    every split non-empty, each graph with its expression row)."""
    fn, kw = _inputs(tmp_path)[case]
    getattr(jax_create, fn)(_ns(str(tmp_path / "jax"), **kw))
    getattr(port_create, fn)(_ns(str(tmp_path / "port"), **kw))
    names = _same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    graphs = {n: load_pickle_dataset(str(tmp_path / "port" / n))
              for n in names if n.endswith(".pkl")}
    assert any(graphs.values())
    if case == "gdsc":
        assert set(names) == {f"{s}.{e}" for s in ("train", "val", "test")
                              for e in ("csv", "pkl")}
        assert all(graphs.values())
        assert all(g.gene_expr.shape == (7,)
                   for gs in graphs.values() for g in gs)


def test_create_cli_parses_as_jax(tmp_path):
    """The port's CLI entry (main(argv)) on the finetune subcommand gives
    the pickles the JAX functions give."""
    csv = _write(tmp_path / "esol.csv",
                 ["smiles", "measured log solubility in mols per litre"],
                 [(s, i * 0.5) for i, s in enumerate(SMALL_SMILES[:5])])
    port_create.main(["finetune", "--dataset", "esol", "--csv", csv,
                      "--out", str(tmp_path / "port"), "--split", "random"])
    jax_create.create_finetune(_ns(str(tmp_path / "jax"), dataset="esol",
                                   csv=csv, data_dir=None, split="random"))
    _same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


# --------------------------------------------------------------------------
# table classes
# --------------------------------------------------------------------------

def test_finetune_data_classes_match_jax():
    from fragnet_tpu.data.datasets import FinetuneData as JaxFT
    from fragnet_tpu.data.datasets import FinetuneMultiConfData as JaxMulti

    from fragnet_tpu_torch.data.datasets import (FinetuneData,
                                                 FinetuneMultiConfData)

    df = pd.DataFrame({"smiles": SMALL_SMILES[:3],
                       "a": [0.5, -1.0, 2.25], "b": [1, 0, 1]})
    table = {c: df[c].tolist() for c in df.columns}
    for target in ("a", ["a", "b"]):
        _graphs_equal(FinetuneData(target).get_ft_dataset(table),
                      JaxFT(target).get_ft_dataset(df))
    got = FinetuneMultiConfData(["a", "b"], num_conf=2).get_ft_dataset(
        {c: v[:2] for c, v in table.items()})
    _graphs_equal(got, JaxMulti(["a", "b"], num_conf=2).get_ft_dataset(
        df.iloc[:2]))
    assert len(got) >= 2


def test_molecule_dataset_matches_jax(tmp_path):
    from fragnet_tpu.data.moleculenet import MoleculeDataset as JaxMD

    from fragnet_tpu_torch.data.moleculenet import MoleculeDataset

    with pytest.raises(KeyError):
        MoleculeDataset("esol")  # not routed (custom_dataset.py:12-27)
    raw = tmp_path / "bbbp" / "raw"
    raw.mkdir(parents=True)
    pd.DataFrame({"smiles": ["CCO", "c1ccccc1", "CCN"],
                  "p_np": [1, 0, None]}).to_csv(raw / "bbbp.csv",
                                                index=False)
    got = MoleculeDataset("bbbp", data_dir=str(tmp_path)).get_data()
    assert got == JaxMD("bbbp", data_dir=str(tmp_path)).get_data()
    assert got[0]["y"] == [[1.0]] and got[2]["y"] == [[-1.0]]
    got = MoleculeDataset("clintox").get_data()  # the synthetic stand-in
    assert got == JaxMD("clintox").get_data()
    assert len(got) == 512 and len(got[0]["y"][0]) == 2


# --------------------------------------------------------------------------
# the MoleculeNet downloader (file:// URLs: no network)
# --------------------------------------------------------------------------

def test_download_registry_matches_jax():
    import fragnet_tpu.data.download as jax_download
    import fragnet_tpu_torch.data.download as port_download
    from fragnet_tpu_torch.data.moleculenet import MOLECULENET_REGISTRY

    assert port_download.DOWNLOAD_REGISTRY == jax_download.DOWNLOAD_REGISTRY
    assert set(MOLECULENET_REGISTRY) <= set(port_download.DOWNLOAD_REGISTRY)


_CSV = "smiles,expt\nCCO,1.0\nc1ccccc1,-0.25\n"


@pytest.mark.parametrize("name,suffix", [("freesolv", ".csv"),
                                         ("tox21", ".csv.gz"),
                                         ("Delaney", ".csv")],
                         ids=["plain", "gz", "alias"])
def test_download_file_url_matches_jax(tmp_path, name, suffix):
    """A plain and a gzipped file:// source, and a dataset alias: the
    port's file equals the JAX package's byte for byte, under the same
    canonical name."""
    import fragnet_tpu.data.download as jax_download
    import fragnet_tpu_torch.data.download as port_download

    src = tmp_path / f"src{suffix}"
    raw = _CSV.encode()
    src.write_bytes(gzip.compress(raw) if suffix.endswith(".gz") else raw)
    got = port_download.download_moleculenet(name, str(tmp_path / "port"),
                                             url=f"file://{src}")
    want = jax_download.download_moleculenet(name, str(tmp_path / "jax"),
                                             url=f"file://{src}")
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read() == raw


def test_download_existing_file_and_no_egress(tmp_path):
    """An existing file is returned untouched without a fetch (its URL
    names nothing); a source that cannot be read raises ConnectionError
    naming the destination, as in the JAX package; an unknown name
    raises KeyError."""
    import fragnet_tpu.data.download as jax_download
    import fragnet_tpu_torch.data.download as port_download

    out = tmp_path / "out"
    out.mkdir()
    (out / "esol.csv").write_text("smiles,y\nCCO,0\n")
    missing = f"file://{tmp_path}/absent.csv"
    assert port_download.download_moleculenet("esol", str(out), url=missing) \
        == str(out / "esol.csv")
    assert (out / "esol.csv").read_text() == "smiles,y\nCCO,0\n"
    errs = []
    for mod in (port_download, jax_download):
        with pytest.raises(ConnectionError) as e:
            mod.download_moleculenet("bace", str(tmp_path / mod.__name__),
                                     url=missing, timeout=1.0)
        errs.append(str(e.value))
        with pytest.raises(KeyError):
            mod.download_moleculenet("no_such_set", str(tmp_path / "k"))
    assert "bace.csv" in errs[0] and "no network" in errs[0]
    assert errs[0].split(str(tmp_path))[0] == errs[1].split(str(tmp_path))[0]


def test_download_cli(tmp_path):
    """``python -m fragnet_tpu_torch.data.download`` writes the file and
    prints its path."""
    src = tmp_path / "src.csv"
    src.write_text(_CSV)
    r = subprocess.run(
        [sys.executable, "-m", "fragnet_tpu_torch.data.download",
         "--dataset", "esol", "--out", str(tmp_path / "raw"),
         "--url", f"file://{src}"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    dest = tmp_path / "raw" / "esol.csv"
    assert r.stdout.strip() == f"downloaded -> {dest}"
    assert dest.read_text() == _CSV


# --------------------------------------------------------------------------
# no pandas in the port
# --------------------------------------------------------------------------

def test_no_port_module_imports_pandas():
    """Neither a module of fragnet_tpu_torch nor chip_smoke.py imports
    pandas (the card's machine has none)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(REPO, "fragnet_tpu_torch")):
        paths += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            if any(n.split(".")[0] == "pandas" for n in names):
                offenders.append(os.path.relpath(path, REPO))
    assert len(paths) > 60 and not offenders, offenders
