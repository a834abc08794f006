"""DTA / CDRP training of the port: label-standardized trainers and the CLI
(counterpart of fragnet_tpu/train/tasks.py).

Reference: fragnet/train/finetune/finetune_dta.py, finetune_cdrp.py,
trainer_dta.py:33-91 (labels standardized with train mean/sdev during
training, destandardized for eval metrics), trainer_cdrp.py.

Usage:
    python -m fragnet_tpu_torch.train.tasks --task dta  [--config cfg.yaml] \
        [k=v ...] [--device cuda|cpu]
    python -m fragnet_tpu_torch.train.tasks --task cdrp [--config cfg.yaml] \
        [k=v ...] [--device cuda|cpu]

The drug encoder is the gat2 FragNet core, so its batches carry TCSR
metadata and dense planes on CUDA and its GAT passes run the kernels; the
protein encoders, the gene-expression MLP and the heads run as torch ops.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.train.loop import _numpy, make_train_step, mse_loss


def _label_stats(label_mean, label_sdev, device) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(mean, sdev + 1e-5) as f32 tensors on ``device`` (the sum in f32, as
    the JAX steps make it)."""
    mean = torch.as_tensor(np.asarray(label_mean, np.float32), device=device)
    sdev = torch.as_tensor(np.asarray(label_sdev, np.float32),
                           device=device) + 1e-5
    return mean, sdev


def standardized_loss(out: torch.Tensor, y: torch.Tensor,
                      graph_mask: torch.Tensor, mean: torch.Tensor,
                      sdev: torch.Tensor) -> torch.Tensor:
    """The DTA / CDRP train loss (trainer_dta.py:33-91): the masked MSE of
    the first output column against the first label column standardized
    as (y − mean)/sdev; ``sdev`` already holds the + 1e-5."""
    return mse_loss(out[:, :1], (y[:, :1] - mean) / sdev, graph_mask)


def make_standardized_steps(model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer,
                            label_mean: float, label_sdev: float,
                            device: Union[str, torch.device] = "cuda",
                            scheduler=None) -> Tuple[Callable, Callable]:
    """(train_step, predict) with (y − mean)/(sdev + 1e-5) standardization
    (trainer_dta.py:33-91): ``train_step(batch) -> loss`` (a 0-d device
    tensor) trains on standardized_loss in train mode; ``predict(batch)``
    returns the first output column in raw label space, in eval mode."""
    mean, sdev = _label_stats(label_mean, label_sdev, device)
    train_step = make_train_step(
        model, optimizer,
        lambda out, y, m: standardized_loss(out, y, m, mean, sdev), device,
        scheduler)

    def predict(batch):
        with obs.span("fragnet.predict"):
            with obs.span("fragnet.data.upload"):
                b = to_device(batch, device)
            model.eval()
            with torch.no_grad():
                with obs.span("fragnet.model.forward"):
                    out = model(b)
                return out[:, 0] * sdev + mean

    return train_step, predict


def make_standardized_ft_steps(model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer,
                               label_mean, label_sdev,
                               device: Union[str, torch.device] = "cuda",
                               scheduler=None) -> Tuple[Callable, Callable]:
    """Standardized steps in TrainerFineTune's step contract (train/loop.py):
    train on (y − mean)/(sdev + 1e-5), evaluate in raw label space — the
    reference's finetune_norm.py:28-43 flow. Multi-task: per-task
    mean/sdev vectors broadcast over the task axis. ``eval_step(batch) ->
    (loss, out)``, both in raw label space."""
    mean, sdev = _label_stats(label_mean, label_sdev, device)
    train_step = make_train_step(
        model, optimizer, lambda out, y, m: mse_loss(out, (y - mean) / sdev, m),
        device, scheduler)

    def eval_step(batch):
        b = to_device(batch, device)
        model.eval()
        with torch.no_grad():
            out = model(b) * sdev + mean  # raw label space
            return mse_loss(out, b.y, b.graph_mask), out

    return train_step, eval_step


class TrainerTask:
    """Epoch runner for DTA/CDRP regression with standardization."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, label_mean: float,
                 label_sdev: float,
                 device: Union[str, torch.device] = "cuda", scheduler=None):
        self.model = model
        self.label_mean = label_mean
        self.label_sdev = label_sdev
        self._step, self._predict = make_standardized_steps(
            model, optimizer, label_mean, label_sdev, device, scheduler)

    def train_epoch(self, batches: Iterable) -> float:
        """One pass of train steps; the mean step loss, fetched once after
        the last step."""
        losses = [self._step(batch) for batch in batches]
        if not losses:
            return 0.0
        return float(torch.stack(losses).double().sum()) / len(losses)

    def evaluate(self, batches: Iterable
                 ) -> Tuple[float, np.ndarray, np.ndarray]:
        """(MSE in raw label space, labels, predictions) over the real
        graphs."""
        ys, ps = [], []
        for batch in batches:
            pred = self._predict(batch).cpu().numpy()
            m = _numpy(batch.graph_mask) > 0
            ys.append(_numpy(batch.y)[:, 0][m])
            ps.append(pred[m])
        y = np.concatenate(ys)
        p = np.concatenate(ps)
        return float(np.mean((y - p) ** 2)), y, p


def load_task_graphs(task: str, opt):
    """The task's MolGraphs: DTA from ``finetune.data.path`` (a CSV with
    smiles, protein, y) or the synthetic generator; CDRP from the synthetic
    generator (the GDSC pipeline is not ported)."""
    seed = int(opt.get("seed", 42))
    ft = opt.finetune
    data = ft.get("data", None) or {}
    n = int(data.get("n_synthetic", 96))
    if task == "dta":
        from fragnet_tpu_torch.data.dta import (build_dta_graphs,
                                                read_dta_csv,
                                                synthetic_dta_dataset)

        path = data.get("path", None)
        df = read_dta_csv(path) if path else synthetic_dta_dataset(
            n=n, seed=seed)
        return build_dta_graphs(df, seed=seed)
    if task == "cdrp":
        from fragnet_tpu_torch.data.cdrp import (build_cdrp_graphs,
                                                 synthetic_cdrp_dataset)

        df, genes = synthetic_cdrp_dataset(n=n, seed=seed)
        return build_cdrp_graphs(df, genes, seed=seed)
    raise ValueError(f"unknown task {task!r} (dta|cdrp)")


def build_task_model(task: str, opt, graphs, policy=None,
                     generator: Optional[torch.Generator] = None):
    """The task's model from ``finetune.model`` with the JAX package's
    defaults: DTAModel (``protein_encoder`` transformer or cnn, over the
    graphs' protein length; the transformer at its 8 layers, 8 heads and
    FFN 512, as the JAX package's run_task builds it) or CDRPModel
    (``gene_dim`` from the graphs)."""
    from fragnet_tpu_torch.model.layers import KernelPolicy

    m = opt.finetune.model
    kw = dict(num_layer=int(m.get("num_layer", 4)),
              num_heads=int(m.get("num_heads", 4)),
              drop_ratio=float(m.get("drop_ratio", 0.15)),
              emb_dim=int(m.get("emb_dim", 128)),
              policy=policy or KernelPolicy(), generator=generator)
    if task == "dta":
        from fragnet_tpu_torch.model.dta import DTAModel

        return DTAModel(
            protein_encoder=m.get("protein_encoder", "transformer"),
            protein_max_len=graphs[0].protein.shape[-1], **kw)
    if task == "cdrp":
        from fragnet_tpu_torch.model.cdrp import CDRPModel

        return CDRPModel(gene_dim=graphs[0].gene_expr.shape[-1], **kw)
    raise ValueError(f"unknown task {task!r} (dta|cdrp)")


def run_task(task: str, opt, quiet: bool = False,
             device: Union[str, torch.device, None] = None, graphs=None):
    """The DTA or CDRP run (the JAX package's run_task): the task's graphs
    (``graphs``, or load_task_graphs), the random 80/10/10 split, the
    train labels' mean and population std, TCSR batches cached on the
    device as ``finetune.cache`` says, the model from ``seed``, Adam,
    standardized training with early stopping on the validation MSE and
    ``exp_dir/{task}.ckpt`` on each improvement, then the test RMSE of the
    best parameters in raw label space. Runs on CUDA unless
    ``device="cpu"``. Returns (test RMSE, model holding the best
    parameters)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.splitters import random_split
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.train import fastpath
    from fragnet_tpu_torch.train.checkpoint import save_params
    from fragnet_tpu_torch.train.earlystop import EarlyStopping
    from fragnet_tpu_torch.train.finetune import seed_everything
    from fragnet_tpu_torch.train.optim import make_optimizer

    if task not in ("dta", "cdrp"):
        raise ValueError(f"unknown task {task!r} (dta|cdrp)")
    seed = int(opt.get("seed", 42))
    exp_dir = opt.get("exp_dir", f"exps/{task}")
    ft = opt.finetune
    fastpath.require_f32(ft, "run_task")
    # the drug encoder is the gat2 FragNet core: TCSR batches and kernels
    fp = fastpath.resolve(ft, model_version="gat2", device=device)
    seed_everything(seed)
    os.makedirs(exp_dir, exist_ok=True)
    if graphs is None:
        graphs = load_task_graphs(task, opt)
    if not quiet:
        print(f"{task}: {len(graphs)} graphs; fastpath: tcsr={fp.tcsr} "
              f"cache={fp.cache} device={fp.device}")
    tr, va, te = random_split(len(graphs), seed=seed)
    train_g = [graphs[i] for i in tr]
    val_g = [graphs[i] for i in va]
    test_g = [graphs[i] for i in te]

    ys = np.array([g.y[0] for g in train_g])
    label_mean, label_sdev = float(ys.mean()), float(ys.std())

    bs = int(ft.get("batch_size", 16))
    spec = spec_for(graphs, batch_size=bs, tcsr=fp.tcsr)
    loaders = (BatchLoader(train_g, bs, spec=spec, shuffle=True, seed=seed),
               BatchLoader(val_g, bs, spec=spec),
               BatchLoader(test_g, bs, spec=spec))
    train_loader, val_loader, test_loader = (
        fastpath.maybe_cache(ld, fp.device, spec=spec, policy=fp.cache,
                             seed=seed + i) for i, ld in enumerate(loaders))
    # the JAX package draws an init batch here (model.init), which advances
    # the train loader's shuffle state; drawing it too keeps both packages
    # on the same batches from the same seed
    next(iter(train_loader))

    model = build_task_model(task, opt, graphs, policy=fp.kernel,
                             generator=torch.Generator().manual_seed(seed))
    model = model.to(fp.device)
    optimizer, scheduler = make_optimizer(model.parameters(), "adam",
                                          lr=float(ft.get("lr", 1e-4)))
    trainer = TrainerTask(model, optimizer, label_mean, label_sdev,
                          fp.device, scheduler)
    es = EarlyStopping(patience=int(ft.get("es_patience", 50)),
                       path=os.path.join(exp_dir, f"{task}.ckpt"),
                       save_fn=save_params)
    torch.manual_seed(seed + 1)  # the dropout stream
    t0 = time.time()
    for epoch in range(int(ft.get("n_epochs", 50))):
        train_loss = trainer.train_epoch(train_loader)
        val_mse, _, _ = trainer.evaluate(val_loader)
        es(val_mse, model)
        if not quiet and epoch % 5 == 0:
            print(f"epoch {epoch:4d} train {train_loss:.5f} "
                  f"val_mse {val_mse:.5f} [{time.time() - t0:.1f}s]")
        if es.early_stop:
            break

    if es.best_params is not None:
        model.load_state_dict(es.best_params)
    mse, _y, _p = trainer.evaluate(test_loader)
    if not quiet:
        print(f"test rmse: {np.sqrt(mse):.5f}")
    return float(np.sqrt(mse)), model


def main(argv=None):
    import ast

    from fragnet_tpu_torch.config import Config, load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=["dta", "cdrp"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = ap.parse_args(argv)
    if args.config:
        opt = load_config(args.config)
    else:
        opt = Config({
            "seed": 42,
            "exp_dir": f"exps/{args.task}",
            "finetune": {"model": {"num_layer": 2, "emb_dim": 64},
                         "batch_size": 16, "lr": 1e-4, "n_epochs": 20,
                         "es_patience": 20},
        })
    for ov in args.overrides:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        opt.set_path(k, v)
    run_task(args.task, opt, device=args.device)


if __name__ == "__main__":
    main()
