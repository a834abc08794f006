"""The port's spans (fragnet_tpu_torch/obs.py): the shared no-op while no
profiler records; under ``torch.profiler`` on the CPU, the vocabulary of a
packed pretraining step and of a DTA train step, nested under one root
with one step id, the GAT levels' ``.bwd`` spans from the autograd
Functions' backward, host stamps on the profiler's clock, the bounded
buffer and ``profile_trace``'s ``spans.json``; and the same loss and
gradients with the profiler on and off."""

import json
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fragnet_tpu_torch import obs
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.data.datasets import PretrainData
from fragnet_tpu_torch.data.dta import build_dta_graphs, synthetic_dta_dataset
from fragnet_tpu_torch.graphs.hiergraph import spec_for
from fragnet_tpu_torch.model.dta import DTAModel
from fragnet_tpu_torch.model.pretrain import FragNetPreTrain
from fragnet_tpu_torch.train.optim import make_optimizer
from fragnet_tpu_torch.train.pretrain import make_pretrain_step
from fragnet_tpu_torch.train.tasks import make_standardized_steps

PT_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "CC(=O)Oc1ccccc1C(=O)O",
             "OCC(O)C(O)CO"]
LEVELS = ("fragnet.gat.bond", "fragnet.gat.atom", "fragnet.gat.frag",
          "fragnet.gat.fconn")
# each span's parent in one step (the GAT levels' is the model's part)
PT_PARENTS = {
    "fragnet.step": None,
    "fragnet.data.upload": "fragnet.step",
    "fragnet.data.decode": "fragnet.step",
    "fragnet.data.planes": "fragnet.data.decode",
    "fragnet.model.forward": "fragnet.step",
    "fragnet.model.head": "fragnet.model.forward",
    "fragnet.gat.logits": LEVELS,
    "fragnet.train.loss": "fragnet.step",
    "fragnet.train.backward": "fragnet.step",
    "fragnet.train.optimizer": "fragnet.step",
    **{lvl: "fragnet.model.forward" for lvl in LEVELS},
    **{lvl + ".bwd": "fragnet.train.backward" for lvl in LEVELS},
}
DTA_PARENTS = {
    **{k: v for k, v in PT_PARENTS.items()
       if k not in ("fragnet.data.decode", "fragnet.data.planes")},
    "fragnet.model.drug": "fragnet.model.forward",
    "fragnet.model.protein": "fragnet.model.forward",
    **{lvl: "fragnet.model.drug" for lvl in LEVELS},
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pt_data():
    """(pack layout, one packed buffer) of a tiny pretraining set."""
    graphs = PretrainData().get_pt_dataset(PT_SMILES, seed=0)
    spec = spec_for(graphs, batch_size=4, multiple=16, tcsr=True, tn=16,
                    te=16, align=True)
    loader = BatchLoader(graphs, 4, spec=spec, with_targets=True, pack=True)
    buf = torch.from_numpy(next(iter(loader)))  # builds the layout
    return loader.layout, buf


@pytest.fixture(scope="module")
def dta_batch():
    """One padded DTA batch (TCSR metadata and planes) and its protein
    length."""
    graphs = build_dta_graphs(synthetic_dta_dataset(n=4, seed=3,
                                                    seq_len_range=(8, 24)),
                              max_seq_len=24)
    spec = spec_for(graphs, batch_size=4, tcsr=True)
    return next(iter(BatchLoader(graphs, 4, spec=spec))), 24


def _pt_step(layout):
    model = FragNetPreTrain(num_layer=1, num_heads=2, emb_dim=16,
                            drop_ratio=0.0,
                            generator=torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(model.parameters(), "adam", lr=1e-3)
    return model, opt, make_pretrain_step(model, opt, layout=layout,
                                          device="cpu")


def _dta_step(L):
    model = DTAModel(num_layer=1, num_heads=2, emb_dim=16, drop_ratio=0.0,
                     protein_layers=1, protein_heads=2,
                     protein_intermediate=32, protein_max_len=L,
                     generator=torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(model.parameters(), "adam", lr=1e-3)
    step, _predict = make_standardized_steps(model, opt, 5.0, 1.0, "cpu")
    return model, opt, step


def _traced(step, batch):
    """One step under the profiler, after a traced warm-up step (the
    process's first record_function call is slow to enter): (profiler, the
    step's span records)."""
    with profile(activities=[ProfilerActivity.CPU]):
        step(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        step(batch)
        t1 = time.time_ns()
    return prof, obs.span_records(t0, t1)


def _events(prof, prefix=""):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU
            and e.name().startswith(prefix)]


def test_off_is_the_shared_noop_and_records_nothing(pt_data):
    assert not torch.autograd._profiler_enabled()
    assert obs.span("fragnet.step") is obs.span("fragnet.x") is obs._OFF
    assert obs.span(None) is obs._OFF
    assert obs.current() is None
    # a span entered while off opens no record_function in a profiler
    # started inside it
    with obs.span("fragnet.off"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(3).sum()
    assert not _events(prof, "fragnet.")
    n, steps = len(obs._RECORDER.spans), obs._RECORDER.steps
    _m, _o, step = _pt_step(pt_data[0])
    step(pt_data[1])
    assert len(obs._RECORDER.spans) == n and obs._RECORDER.steps == steps


@pytest.mark.parametrize("kind", ["pretrain", "dta"])
def test_every_vocabulary_span_nests_under_one_step(kind, pt_data,
                                                    dta_batch):
    if kind == "pretrain":
        step, batch, parents = _pt_step(pt_data[0])[2], pt_data[1], \
            PT_PARENTS
    else:
        step, batch, parents = _dta_step(dta_batch[1])[2], dta_batch[0], \
            DTA_PARENTS
    _prof, recs = _traced(step, batch)
    names = {r["name"] for r in recs}
    assert names == set(parents)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["fragnet.step"]
    assert {r["step"] for r in recs} == {roots[0]["step"]}
    for r in recs:
        if r["parent"] is None:
            continue
        p = recs[r["parent"]]
        want = parents[r["name"]]
        assert p["name"] in (want if isinstance(want, tuple) else (want,)), \
            (r["name"], p["name"])
        assert p["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= p["t1_ns"]
        assert r["device_ms"] is None  # no CUDA events on the CPU
    # the table: self time within the total, one root call a step
    tab = obs.span_table(roots[0]["t0_ns"], roots[0]["t1_ns"])
    assert tab["steps"] == 1
    assert tab["spans"]["fragnet.step"]["per_step"]["calls"] == 1
    for name, row in tab["spans"].items():
        assert 0 <= row["host_self_ms"] <= row["host_ms"] + 1e-9, name
        assert row["device_ms"] is None and row["device_self_ms"] is None
    step_row = tab["spans"]["fragnet.step"]
    kids = sum(tab["spans"][n]["host_ms"] for n in parents
               if parents[n] == "fragnet.step")
    assert step_row["host_self_ms"] == pytest.approx(
        step_row["host_ms"] - kids, abs=1e-6)


def test_bwd_spans_run_inside_the_functions_backward(pt_data):
    _m, _o, step = _pt_step(pt_data[0])
    prof, recs = _traced(step, pt_data[1])
    nodes = [e for e in _events(prof)
             if "GatFnBackward" in e[0] and "evaluate_function" in e[0]]
    bwd = [e for e in _events(prof, "fragnet.gat.")
           if e[0].endswith(".bwd")]
    assert {e[0] for e in bwd} == {lvl + ".bwd" for lvl in LEVELS}
    for name, a, b in bwd:
        assert any(na <= a and b <= nb for _n, na, nb in nodes), name
    assert {r["name"] for r in recs} >= {e[0] for e in bwd}


class _Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.span = obs.current()
        return 2 * x

    @staticmethod
    @obs.spanned_backward
    def backward(ctx, g):
        return 2 * g


def test_a_backward_span_is_named_by_its_forwards_span():
    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("fragnet.gat.atom"):
            y = _Double.apply(x).sum()
        z = _Double.apply(x).sum()  # outside any span: no backward span
        with obs.span("fragnet.train.backward"):
            (y + z).backward()
    names = [e[0] for e in _events(prof, "fragnet.")]
    assert sorted(names) == ["fragnet.gat.atom", "fragnet.gat.atom.bwd",
                             "fragnet.train.backward"]
    assert torch.equal(x.grad, torch.full((3,), 4.0))


def test_host_stamps_sit_on_the_profilers_clock(pt_data):
    _m, _o, step = _pt_step(pt_data[0])
    prof, recs = _traced(step, pt_data[1])
    events = _events(prof, "fragnet.")
    assert len(events) == len(recs)
    for r in recs:
        same = [e for e in events if e[0] == r["name"]]
        _n, a, b = min(same, key=lambda e: abs(e[1] - r["t0_ns"]))
        assert abs(a - r["t0_ns"]) < 1_000_000, r["name"]
        assert abs(b - r["t1_ns"]) < 1_000_000, r["name"]


def test_the_buffer_is_bounded(pt_data, monkeypatch):
    rec = obs.SpanRecorder(max_spans=8)
    monkeypatch.setattr(obs, "_RECORDER", rec)
    _m, _o, step = _pt_step(pt_data[0])
    with profile(activities=[ProfilerActivity.CPU]):
        step(pt_data[1])
        step(pt_data[1])
    assert len(rec.spans) == 8 and rec.steps == 2 and not rec.stack
    assert rec.spans[-1].name == "fragnet.step"
    # the records drop parents that left the buffer
    recs = obs.span_records()
    assert len(recs) == 8
    assert all(r["parent"] is None or r["parent"] < len(recs) for r in recs)


def test_profile_trace_writes_the_span_table(pt_data, tmp_path):
    _m, _o, step = _pt_step(pt_data[0])
    with obs.profile_trace(str(tmp_path)):
        step(pt_data[1])
    assert (tmp_path / "trace.json").exists()
    tab = json.loads((tmp_path / "spans.json").read_text())
    assert tab["steps"] == 1
    assert set(tab["spans"]) == set(PT_PARENTS)
    row = tab["spans"]["fragnet.gat.bond"]
    assert row["calls"] == 1 and row["parents"] == ["fragnet.model.forward"]
    assert row["per_step"]["host_ms"] == pytest.approx(row["host_ms"])


@pytest.mark.parametrize("kind", ["pretrain", "dta"])
def test_the_same_loss_and_gradients_with_the_profiler_on(kind, pt_data,
                                                          dta_batch):
    out = []
    for traced in (False, True):
        if kind == "pretrain":
            model, opt, step = _pt_step(pt_data[0])
            batch = pt_data[1]
        else:
            model, opt, step = _dta_step(dta_batch[1])
            batch = dta_batch[0]
        torch.manual_seed(0)  # the protein encoder's dropout
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                loss = step(batch)
        else:
            loss = step(batch)
        # the step drops the gradients: Adam's first moment holds them
        out.append((float(loss),
                    {n: opt.state[p]["exp_avg"].clone()
                     for n, p in model.named_parameters()
                     if p in opt.state},
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()}))
    (l0, g0, w0), (l1, g1, w1) = out
    assert l0 == l1
    assert set(g0) == set(g1) and g0
    for n in g0:
        np.testing.assert_array_equal(g1[n].numpy(), g0[n].numpy(),
                                      err_msg=n)
    for n in w0:
        np.testing.assert_array_equal(w1[n].numpy(), w0[n].numpy(),
                                      err_msg=n)
