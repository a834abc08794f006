"""The readers of the program's spans (perfbench/metrics/_spans.py and the
metrics that use it) on a synthetic span table and synthetic device
intervals: the division by the window's root spans, the idle time cut to
the root spans' host intervals, and None where the spans have no device
facet or the program keeps none."""

import types

import pytest

from perfbench import run
from perfbench.common.trace import Traced
from perfbench.metrics import _spans

STAGES = {"decode_ms": ("fragnet.data.decode",),
          "forward_ms": ("fragnet.model.forward",),
          "backward_ms": ("fragnet.train.backward",),
          "optimizer_ms": ("fragnet.train.optimizer",),
          "protein_encoder_ms": ("fragnet.model.protein",),
          "logit_terms_ms": ("fragnet.gat.logits",),
          "bond_level_ms": ("fragnet.gat.bond", "fragnet.gat.bond.bwd")}


def _row(device_ms, calls=1):
    return {"parents": [], "calls": calls, "host_ms": 1.0,
            "host_self_ms": 1.0, "device_ms": device_ms,
            "device_self_ms": device_ms, "per_step": {}}


def _table(steps=4, device=True):
    names = ["fragnet.step"] + [n for ns in STAGES.values() for n in ns]
    return {"steps": steps,
            "spans": {n: _row(10.0 * (i + 1) if device else None)
                      for i, n in enumerate(names)}}


def _reading(dev=(), host=()):
    t = Traced(device=list(dev), host=list(host), window_s=1.0, busy_s=0.0,
               steps=[0, 1], host_step_ms=[1.0, 1.0])
    return types.SimpleNamespace(traced=t)


@pytest.fixture
def table(monkeypatch):
    """obs.span_table replaced by one that returns ``box["table"]`` and
    keeps the interval it was asked for."""
    from fragnet_tpu_torch import obs

    box = {"table": _table()}

    def span_table(t0_ns=None, t1_ns=None):
        box["asked"] = (t0_ns, t1_ns)
        return box["table"]

    monkeypatch.setattr(obs, "span_table", span_table)
    return box


def test_stage_ms_is_the_device_ms_over_the_root_spans():
    tab = _table(steps=4)
    want = {n: r["device_ms"] for n, r in tab["spans"].items()}
    assert _spans.device_ms_per_step(tab, "fragnet.data.decode") == \
        want["fragnet.data.decode"] / 4
    assert _spans.device_ms_per_step(
        tab, "fragnet.gat.bond", "fragnet.gat.bond.bwd") == \
        (want["fragnet.gat.bond"] + want["fragnet.gat.bond.bwd"]) / 4


@pytest.mark.parametrize("case", ["no device facet", "no roots", "absent",
                                  "no table"])
def test_stage_ms_is_none_without_what_it_reads(case):
    tab = {"no device facet": _table(device=False),
           "no roots": _table(steps=0), "absent": _table(),
           "no table": None}[case]
    name = "fragnet.nowhere" if case == "absent" else "fragnet.data.decode"
    assert _spans.device_ms_per_step(tab, name) is None


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_each_stage_reader_reads_its_spans_over_the_window(metric, table):
    host = [("fragnet.step", 100.0, 100.5), ("aten::mm", 100.1, 100.2),
            ("fragnet.step", 100.5, 101.0)]
    got = run.reader(f"{metric}.x")(_reading(host=host))
    rows = table["table"]["spans"]
    assert got == pytest.approx(
        sum(rows[n]["device_ms"] for n in STAGES[metric]) / 4)
    t0, t1 = table["asked"]
    assert t0 == int(100.0 * 1e9) - _spans.PAD_NS
    assert t1 == int(101.0 * 1e9) + _spans.PAD_NS
    table["table"] = _table(device=False)
    assert run.reader(f"{metric}.x")(_reading(host=host)) is None


def test_idle_within_cuts_the_gaps_to_the_roots():
    dev = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k3", 2.5, 4.0),
           ("k4", 6.0, 7.0), ("Optimizer.step#Adam.step", 0.0, 7.0)]
    # gaps (1, 2) and (4, 6); the annotation of a host operation is not
    # device work
    hosts = ["Optimizer.step#Adam.step", "aten::mm"]
    assert _spans.idle_within(dev, [(0.0, 7.0)], hosts) == pytest.approx(3.0)
    assert _spans.idle_within(dev, [(1.5, 5.0)], hosts) == pytest.approx(1.5)
    assert _spans.idle_within(dev, [(0.0, 1.0), (6.5, 8.0)], hosts) == 0.0
    assert _spans.idle_within(dev, [(1.0, 2.0), (4.0, 4.5)], hosts) == \
        pytest.approx(1.5)
    assert _spans.idle_within(dev, [(0.0, 7.0)]) == 0.0


def test_host_wait_is_the_idle_inside_the_roots_per_root(table):
    read = run.reader("host_wait_ms.x")
    dev = [("k1", 10.0, 10.1), ("k2", 10.3, 10.4), ("k3", 10.9, 11.0),
           ("aten::mm", 10.0, 11.0)]
    host = [("fragnet.step", 10.0, 10.35), ("fragnet.step", 10.35, 10.8),
            ("aten::mm", 10.6, 10.7)]
    # gaps (10.1, 10.3) and (10.4, 10.9): 0.2 s and 0.4 s inside the roots
    assert read(_reading(dev, host)) == pytest.approx(1e3 * 0.6 / 2)
    table["table"] = _table(device=False)
    assert read(_reading(dev, host)) is None
    table["table"] = _table()
    assert read(_reading((), host)) is None
    assert read(_reading(dev, [("aten::mm", 10.0, 11.0)])) is None


def test_a_program_without_span_table_gives_none(monkeypatch):
    from fragnet_tpu_torch import obs

    monkeypatch.delattr(obs, "span_table")
    r = _reading([("k", 0.0, 1.0)], [("fragnet.step", 0.0, 1.0)])
    for metric in list(STAGES) + ["host_wait_ms"]:
        assert run.reader(f"{metric}.x")(r) is None
    assert _spans.window_table(types.SimpleNamespace(traced=None)) is None


def test_a_traced_cpu_run_reports_none_of_them():
    """On the CPU the spans have no device facet: the readers give None
    and the result line leaves the metrics out."""
    from perfbench.tests import tiny

    res, _ = tiny.run("pt", 2**31 + 11, traced=True)
    assert res["correct"]
    new = set(STAGES) | {"host_wait_ms"}
    assert not {m.split(".")[0] for m in res["metrics"]} & new
