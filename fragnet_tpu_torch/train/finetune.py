"""Finetune entry point of the port — counterpart of
fragnet_tpu/train/finetune.py (the analog of
fragnet/train/finetune/finetune_gat2.py).

Usage:
    python -m fragnet_tpu_torch.train.finetune --config configs/ft/esol.yaml \
        finetune.n_epochs=0 [k=v ...] [--device cuda|cpu]

This slice runs the prediction path: SMILES → graphs → tile-aligned padded
batches with TCSR metadata and dense planes → FragNetFineTune forward → test
RMSE and ``preds_seed_{seed}.pkl``. It needs ``finetune.n_epochs=0``:
training (the backward kernels and Adam) is ROADMAP.md Queue A4, and any
option this slice does not run raises instead of being ignored.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
from typing import Optional, Union

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """(reference finetune_gat2.py:17-26)"""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_model(opt, n_classes: int, policy=None,
                generator: Optional[torch.Generator] = None):
    """The gat2 FragNetFineTune from the config; other model families are
    not ported yet (ROADMAP.md Queue A9)."""
    from fragnet_tpu_torch.model.finetune import FragNetFineTune
    from fragnet_tpu_torch.model.layers import KernelPolicy

    mv = opt.get("model_version", "gat2")
    if mv != "gat2":
        raise NotImplementedError(
            f"model_version={mv!r} is not ported yet (ROADMAP.md Queue A9); "
            f"the port has gat2")
    m = opt.finetune.model
    return FragNetFineTune(
        n_classes=n_classes,
        atom_features=opt.get("atom_features", 167),
        frag_features=opt.get("frag_features", 167),
        edge_features=opt.get("edge_features", 17),
        fedge_in=opt.get("fedge_in", 6),
        fbond_edge_in=opt.get("fbond_edge_in", 6),
        num_layer=m.get("num_layer", 4),
        num_heads=m.get("num_heads", 4),
        drop_ratio=m.get("drop_ratio", 0.15),
        emb_dim=m.get("emb_dim", 128),
        h1=m.get("h1", 256), h2=m.get("h2", 256),
        h3=m.get("h3", 256), h4=m.get("h4", 256),
        act=m.get("act", "relu"),
        fthead=m.get("fthead", "FTHead3"),
        policy=policy or KernelPolicy(),
        generator=generator,
    )


def load_datasets(opt):
    """Returns (train_graphs, val_graphs, test_graphs, n_tasks, task)."""
    from fragnet_tpu_torch.data.datasets import (build_graphs,
                                                 load_pickle_dataset)
    from fragnet_tpu_torch.data.moleculenet import (load_moleculenet,
                                                    target_columns)
    from fragnet_tpu_torch.data.splitters import (random_scaffold_split,
                                                  random_split,
                                                  scaffold_split)

    ft = opt.finetune
    data = ft.get("data", None)

    # pre-featurized pickles (reference train/val/test.path flow)
    if ft.get("train", None) and ft.train.get("path", None):
        return (
            load_pickle_dataset(ft.train.path),
            load_pickle_dataset(ft.val.path),
            load_pickle_dataset(ft.test.path),
            int(ft.get("n_classes", 1)),
            ft.get("target_type", "regr"),
        )

    seed = int(opt.get("seed", 42))
    df = load_moleculenet(
        data.get("name", "esol"),
        data_dir=data.get("path", None),
        n_synthetic=int(data.get("n_synthetic", 512)),
        seed=seed,
    )
    tcols = target_columns(df)
    smiles = list(df["smiles"])
    split = data.get("split", "scaffold")
    if split == "scaffold":
        tr, va, te = scaffold_split(smiles)
    elif split == "random":
        tr, va, te = random_split(len(smiles), seed=seed)
    else:
        tr, va, te = random_scaffold_split(smiles, seed=seed)

    target_vals = np.stack([np.asarray(df[c], np.float64) for c in tcols],
                           axis=1)
    frag_type = data.get("frag_type", "brics")

    def make(idx):
        return build_graphs([smiles[i] for i in idx],
                            [target_vals[i] for i in idx],
                            frag_type=frag_type)

    task = ft.get("target_type", "regr")
    return make(tr), make(va), make(te), len(tcols), task


def _refuse_unported(opt) -> None:
    ft = opt.finetune
    n_epochs = int(ft.get("n_epochs", 100))
    if n_epochs > 0:
        raise NotImplementedError(
            f"finetune.n_epochs={n_epochs}: training is not ported yet — "
            f"it needs the backward kernels and Adam (ROADMAP.md Queue A4); "
            f"pass finetune.n_epochs=0 to run the prediction path")
    dist = opt.get("dist", None)
    if dist and dist.get("mode", "none") != "none":
        raise NotImplementedError(
            f"dist.mode={dist.get('mode')!r} is not ported yet "
            f"(ROADMAP.md Queue A11/A12)")
    if int(ft.get("n_buckets", 1)) > 1:
        raise NotImplementedError("finetune.n_buckets > 1 (bucketed "
                                  "loaders) is not ported yet (ROADMAP.md "
                                  "Queue A6)")
    if ft.get("standardize", False):
        raise NotImplementedError("finetune.standardize is not ported yet "
                                  "(ROADMAP.md Queue A10)")
    pt = opt.get("pretrain", None)
    if pt and pt.get("use", False):
        raise NotImplementedError("pretrain.use: encoder transfer is not "
                                  "ported yet (ROADMAP.md Queue A7)")


def run_finetune(opt, quiet: bool = False, datasets=None,
                 device: Union[str, torch.device, None] = None):
    """The single-device finetune run with ``finetune.n_epochs=0``: build the
    model from ``seed``, predict the test split, print ``test rmse`` (or
    ``roc_auc``) and write ``preds_seed_{seed}.pkl`` under ``exp_dir``.
    Runs on CUDA unless ``device="cpu"``. Returns (metric value, model)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.train import fastpath
    from fragnet_tpu_torch.train.loop import TrainerFineTune

    _refuse_unported(opt)
    ft = opt.finetune
    fp = fastpath.resolve(ft, model_version=opt.get("model_version", "gat2"),
                          device=device)
    seed = int(opt.get("seed", 42))
    seed_everything(seed)
    exp_dir = opt.get("exp_dir", "exps/tmp")
    os.makedirs(exp_dir, exist_ok=True)

    train_g, val_g, test_g, n_tasks, task = (
        datasets if datasets is not None else load_datasets(opt))
    if not quiet:
        print(f"datasets: train={len(train_g)} val={len(val_g)} "
              f"test={len(test_g)} tasks={n_tasks} type={task}")
        print(f"fastpath: tcsr={fp.tcsr} dtype=f32 device={fp.device}")

    bs = int(ft.get("batch_size", 16))
    spec = spec_for(train_g + val_g + test_g, batch_size=bs, tcsr=fp.tcsr)
    model = build_model(opt, n_classes=n_tasks, policy=fp.kernel,
                        generator=torch.Generator().manual_seed(seed))
    model = model.to(fp.device).eval()

    # eval loaders hard-fail on oversized molecules instead of silently
    # shrinking the reported metric's denominator
    test_loader = BatchLoader(test_g, bs, spec=spec, n_tasks=n_tasks,
                              on_oversize="error")
    trainer = TrainerFineTune(model, target_type=task, device=fp.device)
    score, y, p = trainer.test(test_loader)
    metric = "rmse" if task == "regr" else "roc_auc"
    value = float(np.sqrt(score)) if task == "regr" else -score
    if not quiet:
        print(f"test {metric}: {value:.5f}")
    with open(os.path.join(exp_dir, f"preds_seed_{seed}.pkl"), "wb") as f:
        pickle.dump({"y": y, "pred": p, metric: value}, f)
    return value, model


def main(argv=None):
    import ast

    from fragnet_tpu_torch.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = ap.parse_args(argv)
    opt = load_config(args.config)
    for ov in args.overrides:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        opt.set_path(k, v)
    run_finetune(opt, device=args.device)


if __name__ == "__main__":
    main()
