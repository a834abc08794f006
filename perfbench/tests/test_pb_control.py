"""The control on the card: the reference computed with TF32 on (the
precision below the configurations' float32) in the program's place must
come out not correct, while the program comes out correct, at the
configurations' widths with smaller batches. Needs a CUDA device; run on
the card with

    python -m pytest -m cuda perfbench/tests/test_pb_control.py
"""

import copy

import pytest
import torch

from perfbench import calibrate
from perfbench.tests import tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _parts(kind):
    _, cell, _, _ = tiny.parts(kind)
    big_cfg = tiny._json("configs", f"{cell['config']}.json")
    big_tr = tiny._json("traffic", f"{cell['traffic']}.json")
    cfg, tr = copy.deepcopy(big_cfg), copy.deepcopy(big_tr)
    if kind == "pt":
        cfg["batch_size"] = 512
        tr["batches_per_epoch"] = 4
    elif kind == "dta_train":
        tr.update(batch_size=8, train_batches=4)
    else:
        tr.update(batch_size=8, library=dict(tr["library"], n=64))
    return cell, cfg, tr


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pt", "dta_train", "dta_screen"])
def test_control_fails_where_the_program_passes(cuda, kind):
    cell, cfg, tr = _parts(kind)
    out = calibrate.readings(cell["name"], 2 ** 33 + 5, 1.0, True, None,
                             device=cuda, parts=(cell, cfg, tr))
    limits = tr["limits"]
    assert all(out["program"][k] <= lim for k, lim in limits.items()), out
    assert any(out["control"][k] > lim for k, lim in limits.items()), out
