"""The port's HP search and optimizer additions against fragnet_tpu's, on
the CPU:

* the warmup schedules (``cosine_warmup``, ``linear_warmup``) at every
  update count against optax's, 1e-6; Adam with ``grad_clip`` against
  ``optax.chain(clip_by_global_norm, adam)`` over ten steps, 1e-6;
* the built-in ``Study``: with the same seed and a deterministic objective
  12 trials (past ``n_startup`` 8, so the TPE-lite branch runs) propose
  exactly the JAX study's params; the median pruning decisions; resume
  from one sqlite file and the FAILURE_SCORE sentinel; ``_inject``'s
  configs;
* ``run_hp_search`` routes ``ft`` / ``clf`` to run_finetune (``clf``
  negated) and ``dta`` / ``cdrp`` to run_task, the trainers stubbed in both
  packages; one real port trial on the CPU ends COMPLETE with a finite
  value;
* the widest sampled model (FTHead3 h1-h4 2048, ``prelu``, batch 128)
  against the JAX model with weights carried by ``state_dict_from_jax``:
  prediction and every gradient within 1e-4 relative.
"""

import dataclasses
import json
import math
import pickle
import random
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from fragnet_tpu.config import Config as JaxConfig
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.hp import search as jax_hp
from fragnet_tpu.train import optim as jax_optim
from fragnet_tpu.train.finetune import build_model as jax_build_model
from fragnet_tpu.train.loop import mse_loss as jax_mse

from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import MolGraph
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.hp import search as port_hp
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import build_model
from fragnet_tpu_torch.train.loop import mse_loss
from fragnet_tpu_torch.train.optim import make_optimizer, make_schedule

SMALL = dict(num_layer=2, num_heads=2, emb_dim=32, drop_ratio=0.1, h1=32,
             h2=32, h3=32, h4=32, act="relu", fthead="FTHead3")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch forwards and the featurizer's small numpy / scipy
    calls: one intra-op thread and one BLAS thread, so that test workers
    sharing the host's cores do not oversubscribe them (OpenBLAS's own
    threads made featurizing 30× slower beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    """The eight molecules as the port's MolGraphs (the featurizers agree
    array for array; copying the fields saves featurizing them again)."""
    return [MolGraph(**{f.name: getattr(g, f.name)
                        for f in dataclasses.fields(MolGraph)})
            for g in ft_graphs]


# --------------------------------------------------------------------------
# schedules and clipping against optax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,total,warmup", [
    ("cosine_warmup", 40, 6), ("cosine_warmup", 40, 0),
    ("cosine_warmup", 7, 3), ("linear_warmup", 40, 6),
    ("linear_warmup", 40, 0), ("linear_warmup", 5, 9)])
def test_warmup_schedules_match_optax(name, total, warmup):
    """The rate at update counts 0 .. total + 10 against the JAX package's
    optax schedule, 1e-6 of the peak."""
    port = make_schedule(name, 0.01, total_steps=total, warmup_steps=warmup)
    ref = jax_optim.make_schedule(name, 0.01, total_steps=total,
                                  warmup_steps=warmup)
    got = [port(k) for k in range(total + 10)]
    want = [float(ref(k)) for k in range(total + 10)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 0.01)
    assert max(got) == pytest.approx(0.01, rel=1e-6)


def test_cosine_warmup_longer_than_the_run_raises_in_both():
    """A warmup that leaves the cosine no decay steps is refused, as
    optax's cosine_decay_schedule refuses it."""
    with pytest.raises(ValueError):
        jax_optim.make_schedule("cosine_warmup", 0.01, total_steps=4,
                                warmup_steps=9)
    with pytest.raises(ValueError, match="decay steps"):
        make_schedule("cosine_warmup", 0.01, total_steps=4, warmup_steps=9)


@pytest.mark.parametrize("schedule", [None, "cosine_warmup"])
def test_adam_with_grad_clip_matches_optax(schedule):
    """Ten Adam steps on the same gradients, clipped by their global norm
    (some steps above the limit, some below): the port's parameters
    against optax.chain(clip_by_global_norm, adam) after every step,
    1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"w": (3, 4), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    scales = [0.1, 3.0, 0.4, 5.0, 0.2, 2.5, 0.05, 4.0, 1.0, 0.3]
    grads = [{k: (rng.standard_normal(s) * c).astype(np.float32)
              for k, s in shapes.items()} for c in scales]
    norms = [math.sqrt(sum(float((g ** 2).sum()) for g in gs.values()))
             for gs in grads]
    clip = 2.0
    assert min(norms) < clip < max(norms)
    lr, kw = 0.01, dict(total_steps=10, warmup_steps=2)
    tx = jax_optim.make_optimizer(
        "adam", lr=lr, grad_clip=clip,
        schedule=jax_optim.make_schedule(schedule, lr, **kw))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt, sched = make_optimizer(tp.values(), "adam", lr=lr, grad_clip=clip,
                                schedule=make_schedule(schedule, lr, **kw))
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        if sched is not None:
            sched.step()
        opt.zero_grad(set_to_none=True)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the study
# --------------------------------------------------------------------------

def _objective_value(params):
    """A deterministic objective of the sampled params."""
    acts = ["relu", "silu", "gelu", "celu", "selu", "rrelu", "relu6",
            "prelu", "leakyrelu"]
    return (abs(math.log10(params["lr"]) + 4.0) + params["h1"] / 2048
            - params["h4"] / 4096 + 0.1 * acts.index(params["act"])
            + params["drop_ratio"] + params["batch_size"] / 512)


def _rows(path, name):
    with sqlite3.connect(path) as conn:
        return [(json.loads(p), v, s) for p, v, s in conn.execute(
            "SELECT params, value, state FROM trials WHERE study=? "
            "ORDER BY id", (name,)).fetchall()]


def test_study_proposes_the_jax_params(tmp_path):
    """Seed 3, 12 trials of a deterministic objective: the port's trials
    (params, value, state) equal the JAX study's, the TPE-lite branch
    included (trials 9-12)."""
    space_j, space_p = (jax_hp.fragnet_search_space(),
                        port_hp.fragnet_search_space())
    assert [dataclasses.astuple(p) for p in space_j.params] == \
        [dataclasses.astuple(p) for p in space_p.params]
    for mod, tag in ((jax_hp, "jax"), (port_hp, "port")):
        study = mod.Study(str(tmp_path / f"{tag}.sqlite"), seed=3)
        study.optimize(lambda p, h: _objective_value(p),
                       mod.fragnet_search_space(), 12)
    got = _rows(str(tmp_path / "port.sqlite"), "study")
    want = _rows(str(tmp_path / "jax.sqlite"), "study")
    assert len(got) == 12 and got == want
    assert all(s == "COMPLETE" for _, _, s in got)
    # the TPE-lite trials are not the random sampler's next draws
    rng = random.Random(3)
    randoms = [space_p.sample(rng) for _ in range(12)]
    assert [p for p, _, _ in got[:8]] == randoms[:8]
    assert [p for p, _, _ in got[8:]] != randoms[8:]


def test_pruning_decisions_match_jax(tmp_path):
    """Six trials reporting three steps each: the median rule's decisions
    equal the JAX study's (the fifth trial, above the median of four
    earlier ones, is pruned; the sixth, below it, is not)."""
    reports = [[t + 0.1 * s for s in range(3)] for t in range(5)] + \
        [[-1.0, -0.5, 0.0]]
    decisions = {}
    for mod, tag in ((jax_hp, "jax"), (port_hp, "port")):
        study = mod.Study(str(tmp_path / f"{tag}.sqlite"), seed=0)
        out = []
        for t, vals in enumerate(reports):
            handle = mod.TrialHandle(study, study.start_trial({"t": t}))
            out.append([handle.report(step, v) for step, v in
                        enumerate(vals)])
        decisions[tag] = out
    assert decisions["port"] == decisions["jax"]
    assert decisions["port"][4] == [True] * 3
    assert decisions["port"][5] == [False] * 3


def test_resume_and_failure_sentinel_match_jax(tmp_path):
    """Three trials, the second raising (scored FAILURE_SCORE, state FAIL),
    then a second Study on the same file resumes with three more: the
    table equals the JAX package's, and the resumed study counts the
    earlier COMPLETE trials."""
    assert port_hp.FAILURE_SCORE == jax_hp.FAILURE_SCORE == 1000.0

    def objective(params, handle, calls=[0]):
        calls[0] += 1
        if calls[0] % 3 == 2:
            raise RuntimeError("a failing trial")
        return _objective_value(params)

    for mod, tag in ((jax_hp, "jax"), (port_hp, "port")):
        path = str(tmp_path / f"{tag}.sqlite")
        for seed in (5, 6):
            study = mod.Study(path, name="resumed", seed=seed)
            study.optimize(objective, mod.fragnet_search_space(), 3)
        assert study.n_complete == 4
    got = _rows(str(tmp_path / "port.sqlite"), "resumed")
    assert got == _rows(str(tmp_path / "jax.sqlite"), "resumed")
    assert [s for _, _, s in got] == ["COMPLETE", "FAIL", "COMPLETE"] * 2
    assert [v for _, v, s in got if s == "FAIL"] == [1000.0, 1000.0]


def test_inject_matches_jax():
    """The sampled params land in the same config keys, the rest of the
    base config untouched."""
    base = {"seed": 1, "exp_dir": "x", "finetune": {
        "model": dict(SMALL), "batch_size": 16, "lr": 1e-4, "n_epochs": 3}}
    params = port_hp.fragnet_search_space().sample(random.Random(2))
    got = port_hp._inject(Config(base), params).to_dict()
    assert got == jax_hp._inject(JaxConfig(base), params).to_dict()
    assert got["finetune"]["model"]["h4"] == params["h4"]
    assert got["finetune"]["n_epochs"] == 3


@pytest.mark.parametrize("task", ["ft", "clf", "dta", "cdrp"])
def test_run_hp_search_routes_each_task(tmp_path, monkeypatch, task):
    """With run_finetune and run_task stubbed in both packages, the
    default objective sends ``ft`` and ``clf`` to run_finetune (``clf``
    minimizes −ROC-AUC) and ``dta`` / ``cdrp`` to run_task, with the same
    configs; the studies' tables are equal."""
    import fragnet_tpu.train.finetune as jft
    import fragnet_tpu.train.tasks as jtasks

    import fragnet_tpu_torch.train.finetune as pft
    import fragnet_tpu_torch.train.tasks as ptasks

    seen = {"jax": [], "port": []}

    def stubs(tag):
        def ft(opt, quiet=False, **kw):
            seen[tag].append(("finetune", opt.to_dict(), kw.get("device")))
            return 0.25 + opt.finetune.lr * 100, None

        def run_task(name, opt, quiet=False, **kw):
            seen[tag].append((name, opt.to_dict(), kw.get("device")))
            return 0.5 + opt.finetune.lr * 100, None
        return ft, run_task

    for mod, tmod, tag in ((jft, jtasks, "jax"), (pft, ptasks, "port")):
        ft, rt = stubs(tag)
        monkeypatch.setattr(mod, "run_finetune", ft)
        monkeypatch.setattr(tmod, "run_task", rt)
    base = {"seed": 1, "exp_dir": str(tmp_path), "finetune": {
        "model": dict(SMALL), "batch_size": 16, "lr": 1e-4}}
    for mod, cfg, tag in ((jax_hp, JaxConfig, "jax"),
                          (port_hp, Config, "port")):
        mod.run_hp_search(cfg(base), n_trials=2, backend="builtin", seed=4,
                          task=task, study_name=task,
                          storage=str(tmp_path / f"{tag}.sqlite"))
    routed = {"ft": "finetune", "clf": "finetune"}.get(task, task)
    assert [s[0] for s in seen["port"]] == [routed] * 2
    assert [s[:2] for s in seen["port"]] == [s[:2] for s in seen["jax"]]
    assert all(s[2] is None for s in seen["port"])  # the card by default
    got = _rows(str(tmp_path / "port.sqlite"), task)
    assert got == _rows(str(tmp_path / "jax.sqlite"), task)
    for (params, value, state) in got:
        raw = (0.5 if task in ("dta", "cdrp") else 0.25) + params["lr"] * 100
        assert state == "COMPLETE"
        assert value == pytest.approx(-raw if task == "clf" else raw)


@pytest.mark.parametrize("backend", ["optuna", "hyperopt", "ray"])
def test_missing_backend_packages_raise_import_error(tmp_path, backend):
    """The optuna, hyperopt and ray backends import their package when
    called: where it is not installed, both packages raise ImportError."""
    base = {"seed": 1, "exp_dir": str(tmp_path), "finetune": {}}
    for mod, cfg in ((jax_hp, JaxConfig), (port_hp, Config)):
        with pytest.raises(ImportError):
            mod.run_hp_search(cfg(base), n_trials=1, backend=backend,
                              train_fn=lambda opt: 0.0)


def test_one_real_trial_on_the_cpu(tmp_path, port_graphs):
    """run_hp_search with the port's ft objective on the CPU (2 layers, emb
    32, 1 epoch; the sampled head widths, activation and batch size):
    the trial ends COMPLETE with a finite value."""
    from fragnet_tpu_torch.data.datasets import save_pickle_dataset

    paths = {}
    for name, part in (("train", port_graphs), ("val", port_graphs[:4]),
                       ("test", port_graphs[4:])):
        paths[name] = {"path": str(tmp_path / f"{name}.pkl")}
        save_pickle_dataset(part, paths[name]["path"])
    opt = Config({"seed": 3, "exp_dir": str(tmp_path / "hp"),
                  "finetune": {"model": dict(SMALL), "n_epochs": 1,
                               "target_type": "regr", "n_classes": 1,
                               "tcsr": True, **paths}})
    study = port_hp.run_hp_search(
        opt, n_trials=1, backend="builtin", seed=0,
        train_fn=port_hp.task_objective("ft", device="cpu"))
    (params, value, state), = _rows(
        str(tmp_path / "hp" / "hp.sqlite"), "fragnet_hp")
    assert state == "COMPLETE" and math.isfinite(value)
    assert study.best_trial == (params, value)
    with open(tmp_path / "hp" / "preds_seed_3.pkl", "rb") as f:
        assert np.isfinite(pickle.load(f)["pred"]).all()


# --------------------------------------------------------------------------
# the widest sampled model against the JAX model
# --------------------------------------------------------------------------

WIDEST = dict(SMALL, h1=2048, h2=2048, h3=2048, h4=2048, act="prelu")
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None, dp_atom=None, dp_frag=None)


def _close(port, ref, rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def test_widest_sampled_model_matches_jax(ft_graphs, port_graphs):
    """FTHead3 at h1-h4 2048 with prelu, 128 graph slots (the eight
    molecules and 120 padding graphs): the port (aligned-tcsr route, the
    kernels' plain versions) against the JAX model on its segment path,
    weights carried by state_dict_from_jax (prelu's slope included):
    prediction, loss and every gradient within 1e-4 relative."""
    cfg = {"seed": 3, "model_version": "gat2", "finetune": {"model": WIDEST}}
    kw = dict(batch_size=128, tcsr=True, align=True)
    bj = jax_pad_batch(ft_graphs, jax_spec_for(ft_graphs, **kw))
    bj = jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                      dataclasses.replace(bj, **_NO_KERNELS))
    bp = to_device(pad_batch(port_graphs, spec_for(port_graphs, **kw)),
                   "cpu")
    assert bp.graph_mask.shape[0] == 128 and bp.tm_atom is not None
    model = jax_build_model(JaxConfig(cfg), n_classes=1)
    params = jax.jit(lambda k: model.init(k, bj, deterministic=True))(
        jax.random.PRNGKey(0))

    def loss(p):
        pred = model.apply(p, bj, deterministic=True)
        return jax_mse(pred, bj.y, bj.graph_mask), pred

    (l_j, pred_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    port = build_model(Config(cfg), n_classes=1)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    assert port.fthead.act.weight.shape == (1,)
    port.eval()
    pred_p = port(bp)
    _close(pred_p, pred_j)
    loss_p = mse_loss(pred_p, bp.y, bp.graph_mask)
    loss_p.backward()
    _close(loss_p, l_j)
    want = state_dict_from_jax(jax.device_get(g_j))
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    zero = []
    for name, p in names.items():
        # None: computed and off the loss's path in the port, zeros in JAX
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if float(want[name].abs().max()) <= 1e-6 * scale:
            # off the loss's path (0 in exact arithmetic): round-off only
            assert float(got.abs().max()) <= 1e-6 * scale, name
            zero.append(name)
        else:
            _close(got, want[name])
    # the 2048-wide head's gradients are all held to 1e-4
    assert not [n for n in zero if n.startswith("fthead")], zero
