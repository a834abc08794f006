"""Tiny cells for the CPU tests: the benchmark's drivers, configurations
and traffic mixes cut to a few molecules, two layers and short proteins,
so that a run takes seconds on the CPU."""

from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-2,
               "pred_gap": 1e-4}

CELLS = {"pt": "pt-unimol-b4096", "dta_train": "dta-davis-train-b32",
         "dta_screen": "dta-screen-b64"}


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def parts(kind: str):
    """(manifest, cell, configuration, traffic) of the tiny cell ``kind``."""
    from perfbench import run

    man = copy.deepcopy(run.manifest())
    big = {c["name"]: c for c in man["workloads"]}[CELLS[kind]]
    conf = {c["name"]: c for c in man["configs"]}[big["config"]]
    cfg = _json(os.path.relpath(os.path.join(os.path.dirname(BENCH),
                                             conf["file"]), BENCH))
    tr = _json("traffic", f"{big['traffic']}.json")
    cfg["model"]["num_layer"] = 2
    if kind == "pt":
        cfg["batch_size"] = 16
        tr.update(pool={"n": 16, "profile": "lipo", "seed": 7},
                  batches_per_epoch=2)
    else:
        cfg["protein"].update(layers=2, max_len=64)
        if kind == "dta_train":
            tr.update(drugs={"n": 6, "profile": "lipo", "seed": 11},
                      batch_size=4, train_batches=4)
            tr["proteins"].update(n=5, median=40, min=10, max=90)
        else:
            tr.update(library={"n": 16, "profile": "lipo", "seed": 12},
                      batch_size=4)
            tr["protein"].update(median=40, min=10, max=90)
    tr["trace_steps"] = 2
    # a tiny model on the CPU reads other gaps than the cell on the card
    # (Adam's first steps amplify round-off in its few small gradients)
    tr["limits"] = {k: TINY_LIMITS[k] for k in tr["limits"]}
    cell = dict(big, name=f"tiny-{kind}")
    man["workloads"].append(cell)
    for m in man["end_to_end"] + man["per_layer"]:
        if CELLS[kind] in m.get("workloads", []):
            m["workloads"].append(cell["name"])
    return man, cell, cfg, tr


def run(kind: str, seed: int, traced: bool = False, seconds: float = 0.5):
    import torch

    from perfbench import run as bench

    man, cell, cfg, tr = parts(kind)
    return bench.run_cell(cell["name"], seed, seconds, traced,
                          device=torch.device("cpu"), workers=1, man=man,
                          parts=(cell, cfg, tr))

