"""Dataset-creation CLI (counterpart of fragnet_tpu/data/create.py) — the
analog of fragnet/data_create/ (create_pretrain_datasets.py: sharded
creation in chunks with scratch/add modes; create_finetune_datasets.py:
router by dataset name). Tables are column dicts read with the ``csv``
module (data/tables.py) where the JAX package uses pandas; the pickles
hold the port's MolGraphs, which the port's ``load_pickle_dataset`` and
``load_data_parts`` read (as its trainers' ``finetune.{train,val,test}.
path`` and ``pretrain.data_dir``).

Usage:
    # finetune data: registry dataset (CSV file or synthetic fallback)
    python -m fragnet_tpu_torch.data.create finetune --dataset esol \
        [--csv path.csv] --out data/esol [--split scaffold]

    # pretrain data: SMILES csv, UniMol LMDB (or synthetic), sharded pickles
    python -m fragnet_tpu_torch.data.create pretrain [--csv smiles.csv] \
        [--lmdb train.lmdb] --out data/pt --shard_size 1000 \
        [--mode scratch|add] [--num_conf 1]

    # DTA / CDRP synthetic or CSV; GDSC from its raw tables
    python -m fragnet_tpu_torch.data.create dta  --out data/dta  [--csv davis.csv]
    python -m fragnet_tpu_torch.data.create cdrp --out data/cdrp
    python -m fragnet_tpu_torch.data.create gdsc --data_dir raw/gdsc --out data/gdsc

    # a CSV scaffold-split as the reference's CEP / malaria sets; SimSGT
    python -m fragnet_tpu_torch.data.create scaffold_from_df --csv cep.csv --out data/cep
    python -m fragnet_tpu_torch.data.create simsgt --dataset bbbp --out data
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _load_registry(args):
    """The registry dataset ``args.dataset``: ``--csv``, else a CSV under
    ``--data_dir``, else the synthetic stand-in (said aloud)."""
    from fragnet_tpu_torch.data.moleculenet import (load_moleculenet,
                                                    load_moleculenet_csv)

    if args.csv:
        return load_moleculenet_csv(args.dataset, args.csv)
    try:
        return load_moleculenet(args.dataset, data_dir=args.data_dir,
                                allow_synthetic=False)
    except FileNotFoundError:
        df = load_moleculenet(args.dataset, n_synthetic=args.n_synthetic,
                              seed=args.seed)
        print(f"[create] no CSV found — using synthetic stand-in "
              f"({len(df['smiles'])} molecules)")
        return df


def _write_folds(df, folds, maker, out, workers, tag="", with_csv=False):
    """Featurize each fold's rows of ``df`` with ``maker`` into
    ``out/{name}.pkl`` (and its rows into ``out/{name}.csv``)."""
    from fragnet_tpu_torch.data import tables
    from fragnet_tpu_torch.data.datasets import save_pickle_dataset

    os.makedirs(out, exist_ok=True)
    for name, idx in folds:
        part = tables.take(df, idx)
        if with_csv:
            tables.write_csv(part, os.path.join(out, f"{name}.csv"))
        graphs = maker.get_ft_dataset(part, n_workers=workers)
        save_pickle_dataset(graphs, os.path.join(out, f"{name}.pkl"))
        print(f"[create] {tag}{name}: {len(graphs)} graphs "
              f"-> {out}/{name}.pkl")


def _maker(tcols, args):
    from fragnet_tpu_torch.data.datasets import FinetuneData

    return FinetuneData(tcols if len(tcols) > 1 else tcols[0],
                        data_type=args.data_type, frag_type=args.frag_type)


def create_finetune(args) -> None:
    from fragnet_tpu_torch.data.moleculenet import target_columns
    from fragnet_tpu_torch.data.splitters import random_split, scaffold_split

    df = _load_registry(args)
    smiles = list(df["smiles"])
    if args.split == "scaffold":
        tr, va, te = scaffold_split(smiles)
    else:
        tr, va, te = random_split(len(smiles), seed=args.seed)
    _write_folds(df, (("train", tr), ("val", va), ("test", te)),
                 _maker(target_columns(df), args), args.out, args.workers)


def create_pretrain(args) -> None:
    """Sharded pretrain creation with scratch/add modes
    (create_pretrain_datasets.py:10-121)."""
    from fragnet_tpu_torch.data.datasets import PretrainData, save_pickle_dataset

    if getattr(args, "lmdb", None):
        from fragnet_tpu_torch.data.lmdb_io import read_unimol_lmdb

        records = read_unimol_lmdb(args.lmdb)
        smiles = [r["smiles"] for r in records]
        print(f"[create] UniMol LMDB: {len(smiles)} ligands")
    elif args.csv:
        from fragnet_tpu_torch.data.tables import read_csv

        smiles = list(read_csv(args.csv)["smiles"])
    else:
        from fragnet_tpu_torch.data.synthetic import synthetic_dataset

        smiles = list(synthetic_dataset(n=args.n_synthetic,
                                        seed=args.seed)["smiles"])
        print(f"[create] synthetic pretrain SMILES: {len(smiles)}")

    os.makedirs(args.out, exist_ok=True)
    existing = sorted(glob.glob(os.path.join(args.out, "part_*.pkl")))
    start_shard = 0
    if args.mode == "add" and existing:
        start_shard = int(os.path.basename(existing[-1])[5:10]) + 1
        done = start_shard * args.shard_size
        smiles = smiles[done:]
        print(f"[create] add mode: resuming at shard {start_shard}")
    elif existing and args.mode == "scratch":
        for p in existing:
            os.remove(p)

    maker = PretrainData(data_type=args.data_type, frag_type=args.frag_type,
                         num_conf=args.num_conf)
    for k in range(0, len(smiles), args.shard_size):
        chunk = smiles[k : k + args.shard_size]
        graphs = maker.get_pt_dataset(chunk, seed=args.seed)
        shard = start_shard + k // args.shard_size
        path = os.path.join(args.out, f"part_{shard:05d}.pkl")
        save_pickle_dataset(graphs, path)
        print(f"[create] shard {shard}: {len(graphs)} graphs -> {path}")


def create_dta(args) -> None:
    """Davis/KIBA creator (fragnet/dataset/dta.py:7-49): per-fold CSVs
    (--train_csv/--val_csv/--test_csv) → train/val/test.pkl, each beside
    its rows as ``{name}.csv``; a single --csv or synthetic fallback
    produces one dta.pkl."""
    from fragnet_tpu_torch.data import tables
    from fragnet_tpu_torch.data.datasets import save_pickle_dataset
    from fragnet_tpu_torch.data.dta import build_dta_graphs, synthetic_dta_dataset

    os.makedirs(args.out, exist_ok=True)
    folds = [("train", args.train_csv), ("val", args.val_csv),
             ("test", args.test_csv)]
    if any(p for _, p in folds):
        for name, path in folds:
            if not path:
                continue
            df = tables.read_csv(path)
            tables.write_csv(df, os.path.join(args.out, f"{name}.csv"))
            graphs = build_dta_graphs(df, data_type=args.data_type,
                                      frag_type=args.frag_type, seed=args.seed)
            save_pickle_dataset(graphs, os.path.join(args.out, f"{name}.pkl"))
            print(f"[create] dta {name}: {len(graphs)} graphs")
        return
    if args.csv:
        df = tables.read_csv(args.csv)
    else:
        df = synthetic_dta_dataset(n=args.n_synthetic, seed=args.seed)
        print(f"[create] synthetic DTA pairs: {len(df['smiles'])}")
    graphs = build_dta_graphs(df, data_type=args.data_type,
                              frag_type=args.frag_type, seed=args.seed)
    save_pickle_dataset(graphs, os.path.join(args.out, "dta.pkl"))
    print(f"[create] {len(graphs)} graphs -> {args.out}/dta.pkl")


def create_scaffold_from_df(args) -> None:
    """CSV → MoleBert-deterministic scaffold split → featurized pkl per fold
    (fragnet/dataset/scaffold_split_from_df.py:8-48; used for CEP/malaria)."""
    from fragnet_tpu_torch.data import tables
    from fragnet_tpu_torch.data.moleculenet import target_columns
    from fragnet_tpu_torch.data.splitters import scaffold_split

    ds = tables.read_csv(args.csv)
    ds["smiles"] = [str(s) for s in ds["smiles"]]
    tr, va, te = scaffold_split(ds["smiles"])
    tcols = [args.target_name] if args.target_name else target_columns(ds)
    _write_folds(ds, (("train", tr), ("val", va), ("test", te)),
                 _maker(tcols, args), args.out, args.workers, with_csv=True)


def create_simsgt(args) -> None:
    """SimSGT-split MoleculeNet creation (fragnet/dataset/simsgt.py:9-55).

    The reference imports ``splitters_simsgt``, a module absent from its own
    tree; the deterministic MoleBert scaffold split (null_value=0,
    80/10/10 — the same recipe SimSGT uses) stands in here. Output layout
    matches: <out>/simsgt/<name>/{train,val,test}.pkl."""
    from fragnet_tpu_torch.data.moleculenet import (load_moleculenet,
                                                    load_moleculenet_csv,
                                                    target_columns)
    from fragnet_tpu_torch.data.splitters import scaffold_split

    if args.csv:
        df = load_moleculenet_csv(args.dataset, args.csv)
    else:
        df = load_moleculenet(args.dataset, data_dir=args.data_dir,
                              n_synthetic=args.n_synthetic, seed=args.seed)
    tr, va, te = scaffold_split(list(df["smiles"]))
    _write_folds(df, (("train", tr), ("val", va), ("test", te)),
                 _maker(target_columns(df), args),
                 os.path.join(args.out, "simsgt", args.dataset), args.workers,
                 tag=f"simsgt/{args.dataset} ")


def create_gdsc(args) -> None:
    """Full GDSC CDRP pipeline (fragnet/dataset/cdrp.py:9-66 via the DeepTTC
    stack — see data/gdsc.py)."""
    from fragnet_tpu_torch.data.gdsc import create_gdsc_cdrp_dataset

    use_genes = None
    if args.genes_file:
        with open(args.genes_file) as f:
            use_genes = [l.strip() for l in f if l.strip()]
    counts = create_gdsc_cdrp_dataset(
        args.data_dir, args.out, data_type=args.data_type,
        frag_type=args.frag_type, use_genes=use_genes, seed=args.seed)
    print(f"[create] gdsc: {counts}")


def create_cdrp(args) -> None:
    """CDRP pairs (--csv: smiles, cell_line, y) with an expression table
    (--gene_csv: the cell line in the first column, one column per gene),
    or the synthetic set → cdrp.pkl."""
    from fragnet_tpu_torch.data import tables
    from fragnet_tpu_torch.data.cdrp import (build_cdrp_graphs,
                                             synthetic_cdrp_dataset)
    from fragnet_tpu_torch.data.datasets import save_pickle_dataset

    if args.csv and args.gene_csv:
        df = tables.read_csv(args.csv)
        genes = tables.read_csv(args.gene_csv)
        cells, *gcols = genes
        gene_expr = (genes[cells], np.array([genes[c] for c in gcols],
                                            np.float64).T)
    else:
        df, gene_expr = synthetic_cdrp_dataset(n=args.n_synthetic,
                                               seed=args.seed)
        print(f"[create] synthetic CDRP pairs: {len(df['smiles'])}")
    graphs = build_cdrp_graphs(df, gene_expr, data_type=args.data_type,
                               frag_type=args.frag_type, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    save_pickle_dataset(graphs, os.path.join(args.out, "cdrp.pkl"))
    print(f"[create] {len(graphs)} graphs -> {args.out}/cdrp.pkl")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--out", required=True)
    common.add_argument("--csv", default=None)
    common.add_argument("--data_type", default="exp1s")
    common.add_argument("--frag_type", default="brics")
    common.add_argument("--seed", type=int, default=42)
    common.add_argument("--n_synthetic", type=int, default=256)
    common.add_argument("--workers", type=int, default=0)

    ft = sub.add_parser("finetune", parents=[common])
    ft.add_argument("--dataset", required=True)
    ft.add_argument("--data_dir", default=None)
    ft.add_argument("--split", default="scaffold",
                    choices=["scaffold", "random"])
    ft.set_defaults(fn=create_finetune)

    pt = sub.add_parser("pretrain", parents=[common])
    pt.add_argument("--shard_size", type=int, default=1000)
    pt.add_argument("--mode", default="scratch", choices=["scratch", "add"])
    pt.add_argument("--num_conf", type=int, default=1)
    pt.add_argument("--lmdb", default=None,
                    help="UniMol ligand LMDB (dataset/utils.py:78-104)")
    pt.set_defaults(fn=create_pretrain)

    dta = sub.add_parser("dta", parents=[common])
    dta.add_argument("--train_csv", default=None)
    dta.add_argument("--val_csv", default=None)
    dta.add_argument("--test_csv", default=None)
    dta.set_defaults(fn=create_dta)

    cdrp = sub.add_parser("cdrp", parents=[common])
    cdrp.add_argument("--gene_csv", default=None)
    cdrp.set_defaults(fn=create_cdrp)

    sdf = sub.add_parser("scaffold_from_df", parents=[common])
    sdf.add_argument("--target_name", default=None)
    sdf.set_defaults(fn=create_scaffold_from_df)

    sim = sub.add_parser("simsgt", parents=[common])
    sim.add_argument("--dataset", required=True)
    sim.add_argument("--data_dir", default=None)
    sim.set_defaults(fn=create_simsgt)

    gd = sub.add_parser("gdsc", parents=[common])
    gd.add_argument("--data_dir", required=True)
    gd.add_argument("--genes_file", default=None)
    gd.set_defaults(fn=create_gdsc)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
