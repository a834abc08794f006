"""The program against the plain reference at a tiny size on the CPU,
through the benchmark's own drivers and run (the look for a chip skipped):
sound runs come out correct, and each fault that a cell can have, planted
in the program underneath, makes ``correct`` false."""

import pytest
import torch

from perfbench.common import faults
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("kind", ["pt", "dta_train", "dta_screen"])
def test_sound_run_is_correct(kind):
    res, checks = tiny.run(kind, 2 ** 40 + 17)
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] > 0
    for name, value, limit in checks:
        assert value < limit, (name, value, limit)
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("kind", ["pt", "dta_train"])
def test_traced_run_reads_the_same(kind):
    res, checks = tiny.run(kind, 5, traced=True)
    assert res["correct"], checks
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert "breakdown" in res


@pytest.mark.parametrize("kind,fault", [
    ("pt", "unchanged_state"), ("pt", "half_batch"),
    ("dta_train", "unchanged_state"), ("dta_train", "half_batch"),
    ("dta_screen", "altered_answer")])
def test_planted_fault_is_caught(kind, fault):
    with faults.FAULTS[fault]():
        res, checks = tiny.run(kind, 3)
    assert not res["correct"], checks


def test_seed_draws_the_same_inputs():
    a, _ = tiny.run("dta_screen", 99)
    b, _ = tiny.run("dta_screen", 99)
    assert a["checks"] == b["checks"]
