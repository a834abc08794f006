"""Train and eval steps, metrics and the finetune trainer (counterpart of
fragnet_tpu/train/loop.py). The model holds its parameters and the
optimizer its state, so there is no TrainState: a step updates both in
place.

Re-designs fragnet/train/utils.py:307-637 (TrainerFineTune): masked losses
that are exactly the reference's (MSE; masked BCE ignoring labels < −0.5 —
the NaN-label convention, train/utils.py:422-429), and host metrics (RMSE,
masked mean-per-task ROC-AUC, train/utils.py:480-492).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.graphs.batch import to_device


# ---------------------------------------------------------------------------
# losses (masked — padding-aware versions of the reference's)
# ---------------------------------------------------------------------------

def mse_loss(pred: torch.Tensor, y: torch.Tensor,
             graph_mask: torch.Tensor) -> torch.Tensor:
    """Mean over real graphs of (pred − y)² (nn.MSELoss over the batch)."""
    se = (pred.reshape(y.shape) - y) ** 2
    m = graph_mask[:, None]
    return torch.sum(se * m) / torch.clamp(torch.sum(m) * y.shape[1],
                                           min=1.0)


def bce_masked_loss(pred: torch.Tensor, y: torch.Tensor,
                    graph_mask: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits, ignoring labels < −0.5 (missing-label convention)
    and padded graphs. Reference: train/utils.py:297-305,412-429."""
    pred = pred.reshape(y.shape)
    is_valid = (y > -0.5) & (graph_mask[:, None] > 0)
    per = (torch.clamp(pred, min=0) - pred * y
           + torch.log1p(torch.exp(-torch.abs(pred))))
    per = torch.where(is_valid, per, torch.zeros_like(per))
    return torch.sum(per) / torch.clamp(is_valid.sum().float(), min=1.0)


LOSSES = {"mse": mse_loss, "bce": bce_masked_loss}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _loss_fn(loss: Union[str, Callable]) -> Callable:
    return LOSSES[loss] if isinstance(loss, str) else loss


def apply_gradients(loss: torch.Tensor, optimizer: torch.optim.Optimizer,
                    scheduler=None) -> None:
    """Backpropagate ``loss``, step the optimizer, then the scheduler, and
    drop the gradients."""
    with obs.span("fragnet.train.backward"):
        loss.backward()
    with obs.span("fragnet.train.optimizer"):
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        optimizer.zero_grad(set_to_none=True)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    loss_name: Union[str, Callable] = "mse",
                    device: Union[str, torch.device] = "cuda",
                    scheduler=None) -> Callable:
    """``train_step(batch) -> loss`` for a numpy HierGraphBatch: the batch
    is moved to ``device``, the model runs in train mode (dropout on),
    the masked loss (a LOSSES name, or ``loss(pred, y, graph_mask)``) is
    backpropagated, the optimizer steps, then the scheduler, and the
    gradients are dropped.
    The loss comes back as a 0-d device tensor, so the step does not wait
    for the device."""
    loss_fn = _loss_fn(loss_name)

    def train_step(batch):
        with obs.span("fragnet.step"):
            with obs.span("fragnet.data.upload"):
                b = to_device(batch, device)
            model.train()
            with obs.span("fragnet.model.forward"):
                out = model(b)
            with obs.span("fragnet.train.loss"):
                loss = loss_fn(out, b.y, b.graph_mask)
            apply_gradients(loss, optimizer, scheduler)
            return loss.detach()

    return train_step


def make_eval_step(model: torch.nn.Module,
                   loss_name: Union[str, Callable] = "mse",
                   device: Union[str, torch.device] = "cuda") -> Callable:
    """``eval_step(batch) -> (loss, pred)`` for a numpy HierGraphBatch; the
    batch is moved to ``device`` and the model runs in eval mode."""
    loss_fn = _loss_fn(loss_name)

    def eval_step(batch):
        with obs.span("fragnet.predict"):
            with obs.span("fragnet.data.upload"):
                b = to_device(batch, device)
            model.eval()
            with torch.no_grad():
                with obs.span("fragnet.model.forward"):
                    out = model(b)
                with obs.span("fragnet.train.loss"):
                    return loss_fn(out, b.y, b.graph_mask), out

    return eval_step


def make_predict_step(model: torch.nn.Module,
                      device: Union[str, torch.device] = "cuda") -> Callable:
    def predict(batch):
        model.eval()
        with torch.no_grad():
            return model(to_device(batch, device))

    return predict


# ---------------------------------------------------------------------------
# host-side metrics
# ---------------------------------------------------------------------------

def rmse_metric(y: np.ndarray, pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((y - pred) ** 2)))


def roc_auc_score(y: np.ndarray, score: np.ndarray) -> float:
    """Binary ROC-AUC of labels ``y`` (1 positive) by ``score``, with
    sklearn's roc_auc_score's steps in its order (stable descending sort,
    one point per distinct score, collinear points dropped, trapezoids), so
    the two agree bit for bit; numpy only, since the card's machine may
    have no sklearn. Both classes must be present."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score = np.asarray(score)[order]
    pos = (np.asarray(y)[order] == 1).astype(np.float64)
    idx = np.r_[np.where(np.diff(score))[0], pos.size - 1]
    tps = np.cumsum(pos)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def mean_per_task_auc(y: np.ndarray, pred: np.ndarray) -> float:
    """Masked mean-per-task ROC-AUC (train/utils.py:480-492)."""
    rocs = []
    for t in range(y.shape[1]):
        col = y[:, t]
        if (col == 1).sum() > 0 and (col == 0).sum() > 0:
            valid = col > -0.5
            rocs.append(roc_auc_score(col[valid], pred[valid, t]))
    return float(np.mean(rocs)) if rocs else float("nan")


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _numpy(x) -> np.ndarray:
    """A batch field as numpy, whether the batch is on the host or cached
    on a device."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TrainerFineTune:
    """Epoch-level runner mirroring the reference trainer's API surface
    (train/validate/test) on top of the steps. The model holds its own
    parameters, so the methods take only the batches; ``train_epoch`` needs
    an ``optimizer`` or a ``train_step``.

    target_type: 'regr' (MSE / RMSE) or 'clsf' (masked BCE / −mean ROC-AUC).

    ``train_step`` / ``eval_step`` replace the single-device steps (the
    distributed modes' steps, dist/); ``gather`` stacks an array over the
    ranks (dist/data_parallel.py:gather_numpy), so that under data
    parallelism the metrics see every rank's predictions, targets and masks
    and every rank computes the same score.
    """

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 target_type: str = "regr",
                 device: Union[str, torch.device] = "cuda",
                 scheduler=None, train_step: Optional[Callable] = None,
                 eval_step: Optional[Callable] = None,
                 gather: Optional[Callable] = None):
        self.model = model
        self.target_type = target_type
        loss = "mse" if target_type == "regr" else "bce"
        if train_step is None and optimizer is not None:
            train_step = make_train_step(model, optimizer, loss, device,
                                         scheduler)
        self._train_step = train_step
        self._eval_step = eval_step or make_eval_step(model, loss, device)
        self._gather = gather

    def train_epoch(self, batches: Iterable) -> float:
        """One pass of train steps; returns the mean step loss. The step
        losses stay on the device and are fetched once, after the last
        step (the JAX trainer syncs once per epoch too)."""
        if self._train_step is None:
            raise ValueError("TrainerFineTune was built without an optimizer "
                             "or a train step")
        losses = [self._train_step(batch) for batch in batches]
        if not losses:
            return 0.0
        return float(torch.stack(losses).double().sum()) / len(losses)

    def validate(self, batches: Iterable) -> float:
        """Returns the score minimized by early stopping: mean loss for
        regression, −mean-per-task ROC-AUC for classification."""
        if self.target_type == "regr":
            total, n = 0.0, 0
            for batch in batches:
                l, _ = self._eval_step(batch)
                total += float(l)
                n += 1
            return total / max(n, 1)
        y, p = self._collect(batches)
        return -mean_per_task_auc(y, p)

    def test(self, batches: Iterable) -> Tuple[float, np.ndarray, np.ndarray]:
        y, p = self._collect(batches)
        if self.target_type == "regr":
            mse = float(np.mean((y - p) ** 2))
            return mse, y, p
        return -mean_per_task_auc(y, p), y, p

    def _collect(self, batches: Iterable):
        ys, ps = [], []
        for batch in batches:
            _, out = self._eval_step(batch)
            arrs = (_numpy(batch.y), _numpy(batch.graph_mask),
                    out.cpu().numpy())
            if self._gather is not None:
                arrs = tuple(self._gather(a) for a in arrs)
            y, mask, p = arrs
            ys.append(y[mask > 0])
            ps.append(p.reshape(y.shape)[mask > 0])
        return np.concatenate(ys), np.concatenate(ps)
