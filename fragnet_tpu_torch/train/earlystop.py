"""Early stopping with best-checkpoint capture (counterpart of
fragnet_tpu/train/earlystop.py). Reference: fragnet/train/utils.py:13-56
(EarlyStopping)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


class EarlyStopping:
    """Tracks a minimized validation score; keeps the best parameters in
    memory and optionally persists them via ``save_fn(state_dict, path)``."""

    def __init__(self, patience: int = 20, delta: float = 0.0,
                 path: Optional[str] = None,
                 save_fn: Optional[Callable[[Dict[str, torch.Tensor], str],
                                            None]] = None,
                 verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.path = path
        self.save_fn = save_fn
        self.verbose = verbose
        self.counter = 0
        self.best_score: Optional[float] = None
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.early_stop = False

    def __call__(self, val_loss: float, model: torch.nn.Module) -> None:
        score = -float(val_loss)
        if self.best_score is None or score > self.best_score + self.delta:
            self.best_score = score
            # a detached clone on the model's device: the optimizer updates
            # the parameters in place, so a reference would move with them
            self.best_params = {k: v.detach().clone()
                                for k, v in model.state_dict().items()}
            self.counter = 0
            if self.path and self.save_fn:
                self.save_fn(self.best_params, self.path)
            if self.verbose:
                print(f"[earlystop] new best val={val_loss:.6f}")
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
