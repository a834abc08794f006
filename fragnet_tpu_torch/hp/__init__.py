"""Hyperparameter search — the re-design of fragnet/hp/ (hpoptuna.py,
hp.py/hp2.py, hpray.py), counterpart of fragnet_tpu/hp/. Uses optuna when
importable; otherwise the built-in SQLite-backed resumable study with
random + TPE-lite sampling and median pruning."""

from fragnet_tpu_torch.hp.search import SearchSpace, Study, run_hp_search

__all__ = ["Study", "SearchSpace", "run_hp_search"]
