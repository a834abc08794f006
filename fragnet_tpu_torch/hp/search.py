"""Resumable hyperparameter search (counterpart of
fragnet_tpu/hp/search.py; the study, space and backends are copied, the
objectives run the port's trainers).

Mirrors the reference's Optuna workflow (fragnet/hp/hpoptuna.py:39-195):
  * the FragNet finetune search space — drop_ratio ∈ {0,.1,.2,.3}, h1–h4 ∈
    64..2048 step 64, 9 activations, batch ∈ {16,32,64,128} (:46-62)
  * SQLite-backed resumable study (:190-192 ``load_if_exists``)
  * pruning on intermediate values (:140-143, MedianPruner)
  * failures scored with sentinel 1000.0 (:152-159)

Implementation: a dependency-free Study (stdlib sqlite3) with random +
TPE-lite sampling. When optuna is importable, ``run_hp_search(backend=
"optuna")`` delegates to it with the same space. ``random.Random(seed)``
draws the same numbers in both packages, so with the same seed and the
same objective values the built-in study proposes the JAX package's
params trial by trial.

The objectives train on CUDA unless built with ``device="cpu"``
(``task_objective``; the CLI's ``--device``). A trial that raises is
scored FAILURE_SCORE and stored in state FAIL, with its cause printed —
the reference's behaviour; a caller that must not miss a failure reads
the states back from the study's ``trials`` table.

    python -m fragnet_tpu_torch.hp.search --config configs/ft/esol.yaml \
        --backend builtin --n_trials 2 [--task ft|clf|dta|cdrp] \
        [--device cuda|cpu] [k=v ...]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import sqlite3
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

FAILURE_SCORE = 1000.0  # hpoptuna.py:152-159


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    kind: str                 # "categorical" | "int" | "float" | "loguniform"
    choices: Optional[Sequence] = None
    low: Optional[float] = None
    high: Optional[float] = None
    step: Optional[float] = None


class SearchSpace:
    def __init__(self, params: Sequence[Param]):
        self.params = list(params)

    def sample(self, rng: random.Random) -> Dict[str, Any]:
        out = {}
        for p in self.params:
            if p.kind == "categorical":
                out[p.name] = rng.choice(list(p.choices))
            elif p.kind == "int":
                n = int((p.high - p.low) // (p.step or 1))
                out[p.name] = int(p.low + (p.step or 1) * rng.randint(0, n))
            elif p.kind == "float":
                out[p.name] = rng.uniform(p.low, p.high)
            elif p.kind == "loguniform":
                out[p.name] = math.exp(
                    rng.uniform(math.log(p.low), math.log(p.high))
                )
            else:
                raise ValueError(p.kind)
        return out


def fragnet_search_space() -> SearchSpace:
    """The reference finetune space (hpoptuna.py:46-62)."""
    acts = ["relu", "silu", "gelu", "celu", "selu", "rrelu", "relu6",
            "prelu", "leakyrelu"]
    return SearchSpace([
        Param("drop_ratio", "categorical", choices=[0.0, 0.1, 0.2, 0.3]),
        Param("h1", "int", low=64, high=2048, step=64),
        Param("h2", "int", low=64, high=2048, step=64),
        Param("h3", "int", low=64, high=2048, step=64),
        Param("h4", "int", low=64, high=2048, step=64),
        Param("act", "categorical", choices=acts),
        Param("batch_size", "categorical", choices=[16, 32, 64, 128]),
        Param("lr", "loguniform", low=1e-5, high=1e-3),
    ])


class Study:
    """Minimizing study with SQLite persistence + resume (load_if_exists
    semantics) and a TPE-lite sampler: after ``n_startup`` random trials,
    draw K candidates and pick the one most similar to the best-quartile
    trials and least similar to the rest."""

    def __init__(self, storage: str, name: str = "study",
                 n_startup: int = 8, seed: int = 0):
        os.makedirs(os.path.dirname(os.path.abspath(storage)), exist_ok=True)
        self.conn = sqlite3.connect(storage)
        self.name = name
        self.n_startup = n_startup
        self.rng = random.Random(seed)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS trials ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, study TEXT, "
            "params TEXT, value REAL, state TEXT, ts REAL)"
        )
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS reports ("
            "trial_id INTEGER, step INTEGER, value REAL)"
        )
        self.conn.commit()

    # -- persistence -------------------------------------------------------
    def _trials(self, state: Optional[str] = "COMPLETE") -> List[Tuple[Dict, float]]:
        q = "SELECT params, value FROM trials WHERE study=?"
        args = [self.name]
        if state:
            q += " AND state=?"
            args.append(state)
        return [
            (json.loads(p), v) for p, v in self.conn.execute(q, args).fetchall()
        ]

    @property
    def n_complete(self) -> int:
        return len(self._trials())

    @property
    def best_trial(self) -> Optional[Tuple[Dict, float]]:
        done = self._trials()
        return min(done, key=lambda t: t[1]) if done else None

    # -- sampling ----------------------------------------------------------
    def _similarity(self, a: Dict, b: Dict, space: SearchSpace) -> float:
        s = 0.0
        for p in space.params:
            va, vb = a[p.name], b[p.name]
            if p.kind == "categorical":
                s += 1.0 if va == vb else 0.0
            else:
                lo = p.low or 1e-9
                hi = p.high or 1.0
                if p.kind == "loguniform":
                    d = abs(math.log(va) - math.log(vb)) / abs(
                        math.log(hi) - math.log(lo)
                    )
                else:
                    d = abs(va - vb) / max(hi - lo, 1e-9)
                s += 1.0 - min(d, 1.0)
        return s / max(len(space.params), 1)

    def suggest(self, space: SearchSpace) -> Dict[str, Any]:
        done = self._trials()
        if len(done) < self.n_startup:
            return space.sample(self.rng)
        done.sort(key=lambda t: t[1])
        n_good = max(1, len(done) // 4)
        good = [t[0] for t in done[:n_good]]
        bad = [t[0] for t in done[n_good:]]
        best_cand, best_score = None, -1e9
        for _ in range(24):
            cand = space.sample(self.rng)
            sg = sum(self._similarity(cand, g, space) for g in good) / len(good)
            sb = (
                sum(self._similarity(cand, b, space) for b in bad) / len(bad)
                if bad else 0.0
            )
            score = sg - 0.5 * sb
            if score > best_score:
                best_cand, best_score = cand, score
        return best_cand

    # -- pruning (median rule, hpoptuna.py:140-143) ------------------------
    def should_prune(self, trial_id: int, step: int, value: float) -> bool:
        self.conn.execute(
            "INSERT INTO reports VALUES (?,?,?)", (trial_id, step, value)
        )
        self.conn.commit()
        rows = self.conn.execute(
            "SELECT value FROM reports WHERE step=? AND trial_id!=?",
            (step, trial_id),
        ).fetchall()
        if len(rows) < 4:
            return False
        vals = sorted(v for (v,) in rows)
        median = vals[len(vals) // 2]
        return value > median

    # -- trial lifecycle ---------------------------------------------------
    def start_trial(self, params: Dict) -> int:
        cur = self.conn.execute(
            "INSERT INTO trials (study, params, value, state, ts) "
            "VALUES (?,?,?,?,?)",
            (self.name, json.dumps(params), None, "RUNNING", time.time()),
        )
        self.conn.commit()
        return cur.lastrowid

    def finish_trial(self, trial_id: int, value: float,
                     state: str = "COMPLETE") -> None:
        self.conn.execute(
            "UPDATE trials SET value=?, state=? WHERE id=?",
            (value, state, trial_id),
        )
        self.conn.commit()

    def optimize(self, objective: Callable[[Dict, "TrialHandle"], float],
                 space: SearchSpace, n_trials: int,
                 catch_failures: bool = True) -> None:
        for _ in range(n_trials):
            params = self.suggest(space)
            tid = self.start_trial(params)
            handle = TrialHandle(self, tid)
            try:
                value = objective(params, handle)
                self.finish_trial(tid, value,
                                  "PRUNED" if handle.pruned else "COMPLETE")
            except Exception as e:  # sentinel score (hpoptuna.py:152-159)
                if not catch_failures:
                    raise
                print(f"[hp] trial {tid} failed: {type(e).__name__}: {e}")
                self.finish_trial(tid, FAILURE_SCORE, "FAIL")


class TrialHandle:
    def __init__(self, study: Study, trial_id: int):
        self.study = study
        self.trial_id = trial_id
        self.pruned = False

    def report(self, step: int, value: float) -> bool:
        """Report an intermediate value; returns True if the trial should
        stop (pruned)."""
        if self.study.should_prune(self.trial_id, step, value):
            self.pruned = True
        return self.pruned


def task_objective(task: str = "ft", device=None) -> Callable:
    """``train_fn(opt) -> score`` (minimized) for ``task``: ``ft`` = the
    regression test metric of the port's run_finetune; ``clf`` = its
    −ROC-AUC (reference hp/hp_clf.py); ``dta``/``cdrp`` = the test RMSE of
    the port's run_task (reference hp/hp_dta.py, hp_cdrp.py). Trains on
    ``device`` (CUDA by default)."""
    if task in ("dta", "cdrp"):
        from fragnet_tpu_torch.train.tasks import run_task

        def train_fn(opt, _task=task):
            value, _ = run_task(_task, opt, quiet=True, device=device)
            return value
    else:
        from fragnet_tpu_torch.train.finetune import run_finetune

        def train_fn(opt, _task=task):
            value, _ = run_finetune(opt, quiet=True, device=device)
            # clf reports ROC-AUC (higher better) — minimize the negative
            return -value if _task == "clf" else value
    return train_fn


def run_hp_search(
    base_config,
    n_trials: int = 10,
    storage: Optional[str] = None,
    study_name: str = "fragnet_hp",
    backend: str = "auto",
    train_fn: Optional[Callable] = None,
    seed: int = 0,
    task: str = "ft",
):
    """End-to-end HP search over the finetune recipe.

    ``train_fn(opt) -> score`` defaults to ``task_objective(task)``, on
    CUDA. Each trial deep-copies the base config and injects the sampled
    params the way the reference does (hpoptuna.py:72-85; ``_inject``).
    """
    if train_fn is None:
        train_fn = task_objective(task)

    space = fragnet_search_space()
    storage = storage or os.path.join(
        base_config.get("exp_dir", "exps/hp"), "hp.sqlite"
    )

    if backend == "optuna" or (backend == "auto" and _have_optuna()):
        return _run_optuna(base_config, n_trials, storage, study_name, train_fn)
    if backend == "hyperopt":
        return _run_hyperopt(base_config, n_trials, train_fn)
    if backend == "ray":
        return _run_ray(base_config, n_trials, train_fn)

    study = Study(storage, name=study_name, seed=seed)

    def objective(params: Dict, handle: TrialHandle) -> float:
        return train_fn(_inject(base_config, params))

    study.optimize(objective, space, n_trials)
    return study


def _have_optuna() -> bool:
    try:  # pragma: no cover
        import optuna  # noqa: F401

        return True
    except ImportError:
        return False


def _run_optuna(base_config, n_trials, storage, study_name, train_fn):
    import copy

    import optuna

    from fragnet_tpu_torch.config import Config

    study = optuna.create_study(
        study_name=study_name,
        storage=f"sqlite:///{storage}",
        load_if_exists=True,
        direction="minimize",
    )

    def objective(trial):
        opt = Config(copy.deepcopy(base_config.to_dict()))
        opt.set_path("finetune.model.drop_ratio",
                     trial.suggest_categorical("drop_ratio", [0.0, 0.1, 0.2, 0.3]))
        for k in ("h1", "h2", "h3", "h4"):
            opt.set_path(f"finetune.model.{k}",
                         trial.suggest_int(k, 64, 2048, step=64))
        opt.set_path("finetune.model.act", trial.suggest_categorical(
            "act", ["relu", "silu", "gelu", "celu", "selu", "rrelu", "relu6",
                    "prelu", "leakyrelu"]))
        opt.set_path("finetune.batch_size",
                     trial.suggest_categorical("batch_size", [16, 32, 64, 128]))
        opt.set_path("finetune.lr", trial.suggest_float("lr", 1e-5, 1e-3, log=True))
        try:
            return train_fn(opt)
        except Exception:
            return FAILURE_SCORE

    study.optimize(objective, n_trials=n_trials)
    return study


def _inject(base_config, params: Dict):
    """Deep-copy the base config and inject sampled params the way every
    backend objective does (hpoptuna.py:72-85)."""
    import copy

    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(base_config.to_dict()))
    opt.set_path("finetune.model.drop_ratio", params["drop_ratio"])
    for k in ("h1", "h2", "h3", "h4"):
        opt.set_path(f"finetune.model.{k}", params[k])
    opt.set_path("finetune.model.act", params["act"])
    opt.set_path("finetune.batch_size", params["batch_size"])
    opt.set_path("finetune.lr", params["lr"])
    return opt


def _run_hyperopt(base_config, n_trials, train_fn):
    """Hyperopt backend (reference hp/hp.py, hp2.py: fmin over hp.choice
    space). Requires the ``hyperopt`` package."""
    import numpy as np
    from hyperopt import Trials, fmin, hp, tpe

    space = {
        "drop_ratio": hp.choice("drop_ratio", [0.0, 0.1, 0.2, 0.3]),
        "h1": hp.choice("h1", list(range(64, 2049, 64))),
        "h2": hp.choice("h2", list(range(64, 2049, 64))),
        "h3": hp.choice("h3", list(range(64, 2049, 64))),
        "h4": hp.choice("h4", list(range(64, 2049, 64))),
        "act": hp.choice("act", ["relu", "silu", "gelu", "celu", "selu",
                                 "rrelu", "relu6", "prelu", "leakyrelu"]),
        "batch_size": hp.choice("batch_size", [16, 32, 64, 128]),
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-3)),
    }

    def objective(params):
        try:
            return train_fn(_inject(base_config, params))
        except Exception:
            return FAILURE_SCORE

    trials = Trials()
    best = fmin(objective, space, algo=tpe.suggest, max_evals=n_trials,
                trials=trials)
    return trials


def _run_ray(base_config, n_trials, train_fn):
    """Ray Tune backend (reference hp/hpray.py). Requires ``ray[tune]``."""
    from ray import tune

    space = {
        "drop_ratio": tune.choice([0.0, 0.1, 0.2, 0.3]),
        "h1": tune.choice(list(range(64, 2049, 64))),
        "h2": tune.choice(list(range(64, 2049, 64))),
        "h3": tune.choice(list(range(64, 2049, 64))),
        "h4": tune.choice(list(range(64, 2049, 64))),
        "act": tune.choice(["relu", "silu", "gelu", "celu", "selu",
                            "rrelu", "relu6", "prelu", "leakyrelu"]),
        "batch_size": tune.choice([16, 32, 64, 128]),
        "lr": tune.loguniform(1e-5, 1e-3),
    }

    def trainable(params):
        try:
            value = train_fn(_inject(base_config, params))
        except Exception:
            value = FAILURE_SCORE
        tune.report({"score": value})

    tuner = tune.Tuner(
        trainable,
        param_space=space,
        tune_config=tune.TuneConfig(num_samples=n_trials, metric="score",
                                    mode="min"),
    )
    return tuner.fit()


def main(argv=None):  # CLI: python -m fragnet_tpu_torch.hp.search --config ... --n_trials 5
    import argparse

    from fragnet_tpu_torch.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--n_trials", type=int, default=10)
    ap.add_argument("--study_name", default="fragnet_hp")
    ap.add_argument("--storage", default=None)
    ap.add_argument("--task", default="ft", choices=["ft", "clf", "dta", "cdrp"],
                    help="objective family (hpft/hp_clf/hp_dta/hp_cdrp analogs)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "builtin", "optuna", "hyperopt", "ray"],
                    help="search backend (hpoptuna/hp/hpray analogs; builtin "
                         "= the SQLite TPE-lite study)")
    ap.add_argument("--device", default="cuda",
                    help="the trials' device (cuda unless cpu is asked for)")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = ap.parse_args(argv)
    opt = load_config(args.config)
    for ov in args.overrides:
        k, v = ov.split("=", 1)
        try:
            import ast

            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        opt.set_path(k, v)
    study = run_hp_search(opt, n_trials=args.n_trials, storage=args.storage,
                          study_name=args.study_name, task=args.task,
                          backend=args.backend,
                          train_fn=task_objective(args.task, args.device))
    best = study.best_trial
    if best:
        print(f"best value: {best[1]:.5f}\nbest params: {best[0]}")


if __name__ == "__main__":
    main()
