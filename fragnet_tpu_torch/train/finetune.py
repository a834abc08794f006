"""Finetune entry point of the port — counterpart of
fragnet_tpu/train/finetune.py (the analog of
fragnet/train/finetune/finetune_gat2.py).

Usage:
    python -m fragnet_tpu_torch.train.finetune --config configs/ft/esol.yaml \
        [k=v ...] [--device cuda|cpu]

The single-device finetune: SMILES → graphs → tile-aligned padded batches
with TCSR metadata and dense planes → FragNetFineTune → masked loss →
backward through the GAT kernels → Adam, with validation, early stopping
and a checkpoint every epoch, then the test metric on the best parameters
and ``preds_seed_{seed}.pkl``. ``finetune.n_epochs=0`` runs the prediction
path alone. Any option the port does not run yet raises instead of being
ignored (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
import time
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


def run_finetune(opt, quiet: bool = False, datasets=None,
                 device: Union[str, torch.device, None] = None):
    """The single-device finetune run (the JAX package's run_finetune,
    fragnet_tpu/train/finetune.py:210-484, without its distributed,
    bucketed and standardized branches): build the model from ``seed``,
    load the encoder from a pretrain checkpoint when ``pretrain.use`` and
    ``pretrain.chk`` are set, cache the loaders on the device as
    ``finetune.cache`` says (``fastpath.maybe_cache``),
    train ``finetune.n_epochs`` epochs with Adam, validate, early-stop and
    save ``exp_dir/ft.ckpt`` on each improvement, log ``scalars.jsonl``,
    then test the best parameters, print ``test rmse`` (or ``roc_auc``) and
    write ``preds_seed_{seed}.pkl``. Runs on CUDA unless ``device="cpu"``.
    Returns (metric value, model holding the best parameters)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.obs import ScalarLogger, profile_trace
    from fragnet_tpu_torch.train import fastpath
    from fragnet_tpu_torch.train.checkpoint import (
        save_params, transfer_pretrained_encoder)
    from fragnet_tpu_torch.train.earlystop import EarlyStopping
    from fragnet_tpu_torch.train.loop import TrainerFineTune
    from fragnet_tpu_torch.train.optim import make_optimizer, make_schedule

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
        print(f"fastpath: tcsr={fp.tcsr} dtype=f32 cache={fp.cache} "
              f"device={fp.device}")

    bs = int(ft.get("batch_size", 16))
    spec = spec_for(train_g + val_g + test_g, batch_size=bs, tcsr=fp.tcsr)
    model = build_model(opt, n_classes=n_tasks, policy=fp.kernel,
                        generator=torch.Generator().manual_seed(seed))
    model = model.to(fp.device)

    train_loader = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                               seed=seed, n_tasks=n_tasks)
    # eval loaders hard-fail on oversized molecules instead of silently
    # shrinking the reported metric's denominator
    val_loader = BatchLoader(val_g, bs, spec=spec, n_tasks=n_tasks,
                             on_oversize="error")
    test_loader = BatchLoader(test_g, bs, spec=spec, n_tasks=n_tasks,
                              on_oversize="error")
    # device-resident caching: after the first pass the input pipeline
    # costs nothing (DeviceCacheLoader; reshuffles batch ORDER per epoch)
    train_loader, val_loader, test_loader = (
        fastpath.maybe_cache(ld, fp.device, spec=spec, n_tasks=n_tasks,
                             policy=fp.cache, seed=seed + i)
        for i, ld in enumerate((train_loader, val_loader, test_loader)))
    # the JAX package draws an init batch here (model.init), which advances
    # the train loader's shuffle state; drawing it too keeps both packages
    # on the same batches from the same seed
    next(iter(train_loader))

    # pretrained encoder transfer (finetune_gat2.py:213-230)
    pt = opt.get("pretrain", None)
    if pt and pt.get("use", False) and pt.get("chk", None):
        transfer_pretrained_encoder(
            model, torch.load(pt.chk, map_location="cpu", weights_only=True))
        if not quiet:
            print(f"loaded pretrained encoder from {pt.chk}")

    n_epochs = int(ft.get("n_epochs", 100))
    lr = float(ft.get("lr", 1e-4))
    sched = None
    if ft.get("use_schedular", False):
        sched = make_schedule("linear", lr,
                              total_steps=n_epochs * max(1, len(train_loader)))
    optimizer, scheduler = make_optimizer(model.parameters(), "adam", lr=lr,
                                          schedule=sched)
    trainer = TrainerFineTune(model, optimizer, target_type=task,
                              device=fp.device, scheduler=scheduler)
    ckpt_path = os.path.join(exp_dir, ft.get("chkpoint_name", "ft.ckpt"))
    es = EarlyStopping(patience=int(ft.get("es_patience", 100)),
                       path=ckpt_path, save_fn=save_params)
    profile_dir = (os.path.join(exp_dir, "profile")
                   if ft.get("profile", False) else None)
    # throughput: real message edges over all 4 levels × layers (the
    # bench.py metric), logged per epoch
    epoch_edges = fastpath.epoch_message_edges(
        train_g, num_layer=int(ft.model.get("num_layer", 4)))

    metric = "rmse" if task == "regr" else "roc_auc"
    with ScalarLogger(exp_dir) as logger:
        t0 = time.time()
        for epoch in range(n_epochs):
            te0 = time.perf_counter()
            with profile_trace(profile_dir if epoch == 1 else None):
                train_loss = trainer.train_epoch(train_loader)
            edges_per_sec = epoch_edges / max(time.perf_counter() - te0, 1e-9)
            val_score = trainer.validate(val_loader)
            es(val_score, model)
            logger.log("train/loss", train_loss, epoch)
            logger.log("train/edges_per_sec", edges_per_sec, epoch)
            logger.log("val/score", val_score, epoch)
            if not quiet and (epoch % 10 == 0 or epoch == n_epochs - 1):
                print(f"epoch {epoch:4d} train_loss {train_loss:.5f} "
                      f"val {val_score:.5f} best {-(es.best_score or 0):.5f} "
                      f"{edges_per_sec / 1e6:.2f}M edges/s "
                      f"[{time.time() - t0:.1f}s]")
            if es.early_stop:
                if not quiet:
                    print(f"early stop at epoch {epoch}")
                break

        if es.best_params is not None:
            model.load_state_dict(es.best_params)
        score, y, p = trainer.test(test_loader)
        value = float(np.sqrt(score)) if task == "regr" else -score
        logger.log(f"test/{metric}", value, n_epochs)
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
