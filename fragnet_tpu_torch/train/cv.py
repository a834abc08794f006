"""k-fold cross-validated finetuning (counterpart of fragnet_tpu/train/cv.py)
— the analog of fragnet/train/finetune/gat2_cv.py:113-158 (and its
duplicate gat2_cv_frag.py): train+val are merged, split into k folds
(KFold semantics via ``cv_random_split``), each fold trains with the
held-out part as the early-stopping validation set, and the fixed test set
is scored per fold; run_finetune_cv reports mean ± std of the test metric.

Usage:
    python -m fragnet_tpu_torch.train.cv --config configs/ft/esol.yaml \
        [--folds 5] [--device cuda|cpu] [k=v ...]
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
import pickle
from typing import List, Union

import numpy as np
import torch


def run_finetune_cv(opt, n_folds: int = 5, quiet: bool = False,
                    device: Union[str, torch.device, None] = None):
    """Returns (mean, std, per-fold scores) and writes them to
    ``exp_dir/cv_scores.pkl``; fold k trains in ``exp_dir/fold_k`` on
    ``device`` (CUDA unless the caller asks for the CPU). Datasets are
    featurized once and re-folded (the reference refits the featurizer per
    run; one-shot featurization is equivalent and k× cheaper)."""
    from fragnet_tpu_torch.data.splitters import cv_random_split
    from fragnet_tpu_torch.train.finetune import load_datasets, run_finetune

    train_g, val_g, test_g, n_tasks, task = load_datasets(opt)
    pool = list(train_g) + list(val_g)  # gat2_cv.py:121 merges train+val
    folds = cv_random_split(len(pool), n_folds=n_folds,
                            seed=int(opt.get("seed", 42)))

    scores: List[float] = []
    exp_dir = opt.get("exp_dir", "exps/cv")
    for k, (tr_idx, va_idx) in enumerate(folds):
        fold_opt = copy.deepcopy(opt)
        fold_opt.set_path("exp_dir", os.path.join(exp_dir, f"fold_{k}"))
        fold_train = [pool[i] for i in tr_idx]
        fold_val = [pool[i] for i in va_idx]
        value, _ = run_finetune(
            fold_opt, quiet=True, device=device,
            datasets=(fold_train, fold_val, test_g, n_tasks, task),
        )
        scores.append(value)
        if not quiet:
            print(f"fold {k}: test {value:.5f}")

    mean, std = float(np.mean(scores)), float(np.std(scores))
    if not quiet:
        print(f"cv ({n_folds} folds): {mean:.5f} +/- {std:.5f}")
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "cv_scores.pkl"), "wb") as f:
        pickle.dump({"scores": scores, "mean": mean, "std": std}, f)
    return mean, std, scores


def main(argv=None):
    from fragnet_tpu_torch.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    opt = load_config(args.config)
    for ov in args.overrides:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        opt.set_path(k, v)
    run_finetune_cv(opt, n_folds=args.folds, device=args.device)


if __name__ == "__main__":
    main()
