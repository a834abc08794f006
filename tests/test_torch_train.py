"""The port's training half against fragnet_tpu's, on the CPU: the
optimizers and the schedule against optax on identical gradient
sequences, the SGD trainer against the JAX trainer over two shuffled
epochs, early stopping, ``run_finetune`` with ``n_epochs > 0`` (its
checkpoint, scalars and predictions, and the checkpoint opened in the JAX
package), and the profiler trace. Small model: 2 layers, emb 32, 4 heads, dropout 0.
Tolerances: 1e-6 for optimizer steps (f32 rounding of one update rule in
two libraries), 1e-4 relative for anything through the model (as
tests/test_torch_model.py)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fragnet_tpu.data.batcher import BatchLoader as JaxLoader
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.train import optim as jax_optim
from fragnet_tpu.train.checkpoint import import_torch_state_dict
from fragnet_tpu.train.earlystop import EarlyStopping as JaxEarlyStopping
from fragnet_tpu.train.loop import TrainerFineTune as JaxTrainer
from fragnet_tpu.train.loop import TrainState

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import spec_for
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.obs import profile_trace, read_scalars
from fragnet_tpu_torch.train.checkpoint import load_params, state_dict_from_jax
from fragnet_tpu_torch.train.earlystop import EarlyStopping
from fragnet_tpu_torch.train.finetune import run_finetune
from fragnet_tpu_torch.train.loop import TrainerFineTune
from fragnet_tpu_torch.train.optim import make_optimizer, make_schedule

SMALL = dict(num_layer=2, num_heads=4, emb_dim=32, h1=16, h2=16, h3=16,
             h4=16, drop_ratio=0.0, act="relu", fthead="FTHead3")


def _close(port, ref, rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = PortBuilder("exp1s")
    return [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                          smiles=g.smiles) for g in ft_graphs]


# --------------------------------------------------------------------------
# optimizers and schedules against optax
# --------------------------------------------------------------------------

# (schedule, total_steps, warmup_steps, end_factor): constant, and the
# linear ramp over explicit warmup_steps and over the total_steps // 20
# updates that run_finetune asks for
_SCHEDULES = [
    pytest.param(None, 40, 6, 1.0 / 3.0, id="None"),
    pytest.param("linear", 40, 6, 1.0 / 3.0, id="linear"),
    pytest.param("linear", 400, 0, 1.0 / 3.0, id="linear-total"),
    pytest.param("linear", 40, 6, 0.5, id="linear-end-half"),
    pytest.param("linear", 10, 0, 1.0 / 3.0, id="linear-short"),
]


@pytest.mark.parametrize("schedule,total,warmup,end", _SCHEDULES)
def test_schedule_values_match_optax(schedule, total, warmup, end):
    kw = dict(total_steps=total, warmup_steps=warmup, end_factor=end)
    port = make_schedule(schedule, 0.01, **kw)
    ref = jax_optim.make_schedule(schedule, 0.01, **kw)
    if schedule is None:
        assert port is None and ref == 0.01
        assert make_schedule("constant", 0.01, **kw) is None
        return
    for step in range(total + 10):
        np.testing.assert_allclose(port(step), float(ref(step)),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("call", [
    lambda: make_schedule("exponential", 0.01),
    lambda: make_optimizer([torch.nn.Parameter(torch.zeros(1))], "rmsprop"),
], ids=["schedule", "optimizer"])
def test_unported_optimizer_options_raise(call):
    with pytest.raises(ValueError, match="unknown"):
        call()


# (name, schedule, lr); at lr 0.01 the ids are name-clip-schedule, clip None
_OPTIMIZERS = [
    pytest.param(name, sched, lr,
                 id=f"{name}-None-{sched}" + ("" if lr == 0.01 else f"-{lr}"))
    for lr in (0.01, 1e-4) for name in ("adam", "sgd")
    for sched in (None, "linear")]


@pytest.mark.parametrize("name,schedule,lr", _OPTIMIZERS)
def test_optimizer_steps_match_optax(name, schedule, lr):
    """The same gradient sequence through optax and the port: parameters
    agree after every step."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.7).astype(np.float32)
              for k, s in shapes.items()} for _ in range(8)]
    # optax takes Adam's bias corrections 1 - b**t in f32 (~1e-5 relative
    # error at t = 1), an error in the update that scales with lr: at lr
    # 0.01 eight steps stay inside 1e-6, and each still moves a parameter
    # by far more than that
    kw = dict(total_steps=8, warmup_steps=2)
    tx = jax_optim.make_optimizer(
        name, lr=lr, schedule=jax_optim.make_schedule(schedule, lr, **kw))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt, sched = make_optimizer(tp.values(), name, lr=lr,
                                schedule=make_schedule(schedule, lr, **kw))
    assert (sched is None) == (schedule is None)
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
# trainer and early stopping against the JAX package
# --------------------------------------------------------------------------

def test_sgd_trainer_epochs_match_jax(ft_graphs, port_graphs):
    """Two shuffled epochs of SGD from carried weights (dropout 0, segment
    path): per-epoch mean losses and the final parameters agree."""
    model = JaxModel(**SMALL)
    sj = jax_spec_for(ft_graphs, batch_size=3)
    loader_j = JaxLoader(ft_graphs, 3, spec=sj, shuffle=True, seed=5)
    params = model.init(jax.random.PRNGKey(1), jax_pad_batch(ft_graphs[:3], sj),
                        deterministic=True)
    lr = 0.02
    tx = optax.sgd(lr)
    jtrainer = JaxTrainer(model, tx, target_type="regr")
    state = TrainState.create(params, tx)

    port = FragNetFineTune(**SMALL)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    opt, _ = make_optimizer(port.parameters(), "sgd", lr=lr)
    trainer = TrainerFineTune(port, opt, target_type="regr", device="cpu")
    loader_p = BatchLoader(port_graphs, 3, spec=spec_for(port_graphs, 3),
                           shuffle=True, seed=5)
    for _ in range(2):
        state, loss_j = jtrainer.train_epoch(state, loader_j,
                                             jax.random.PRNGKey(2))
        loss_p = trainer.train_epoch(loader_p)
        assert abs(loss_p - loss_j) <= 1e-4 * abs(loss_j)
    want = state_dict_from_jax(jax.device_get(state.params))
    for name, p in port.state_dict().items():
        _close(p, want[name])


def test_early_stopping_matches_jax():
    port = torch.nn.Linear(2, 1)
    saved = []
    es_p = EarlyStopping(patience=2, path="ckpt",
                         save_fn=lambda sd, path: saved.append(path))
    es_j = JaxEarlyStopping(patience=2)
    for i, val in enumerate([1.0, 0.8, 0.9, 0.7, 0.75, 0.71, 0.72]):
        with torch.no_grad():
            port.bias.fill_(float(i))
        es_p(val, port)
        es_j(val, {"i": i})
        assert (es_p.best_score, es_p.counter, es_p.early_stop) == \
            (es_j.best_score, es_j.counter, es_j.early_stop)
    assert len(saved) == 3 and es_p.early_stop
    # the snapshot is a clone: later in-place updates do not reach it
    assert float(es_p.best_params["bias"]) == 3.0 == es_j.best_params["i"]


# --------------------------------------------------------------------------
# run_finetune with training, its checkpoint, and the profiler trace
# --------------------------------------------------------------------------

def _opt(tmp_path, **finetune):
    return Config({
        "seed": 7, "exp_dir": str(tmp_path), "model_version": "gat2",
        "finetune": {
            "model": {k: v for k, v in SMALL.items()},
            "target_type": "regr", "batch_size": 2, "n_epochs": 2,
            "lr": 1e-3, "es_patience": 5, **finetune},
    })


def test_run_finetune_trains_and_checkpoints(tmp_path, ft_graphs,
                                             port_graphs):
    datasets = (port_graphs[:4], port_graphs[4:6], port_graphs[6:], 1,
                "regr")
    rmse, model = run_finetune(_opt(tmp_path, use_schedular=True),
                               quiet=True, datasets=datasets, device="cpu")
    for f in ("ft.ckpt", "scalars.jsonl", "preds_seed_7.pkl"):
        assert os.path.exists(tmp_path / f), f
    tags = [r["tag"] for r in read_scalars(str(tmp_path))]
    assert tags.count("train/loss") == 2 and tags.count("val/score") == 2
    assert tags[-1] == "test/rmse"
    with open(tmp_path / "preds_seed_7.pkl", "rb") as f:
        preds = pickle.load(f)
    assert preds["rmse"] == rmse and np.isfinite(preds["pred"]).all()

    # the test RMSE is the checkpoint's
    fresh = load_params(FragNetFineTune(**SMALL), str(tmp_path / "ft.ckpt"))
    spec = spec_for(port_graphs, batch_size=2)
    score, y, p = TrainerFineTune(fresh, device="cpu").test(
        BatchLoader(port_graphs[6:], 2, spec=spec))
    assert np.sqrt(score) == pytest.approx(rmse, rel=1e-6)
    np.testing.assert_array_equal(p, preds["pred"])

    # the checkpoint opens in the JAX package and predicts the same
    sd = torch.load(tmp_path / "ft.ckpt", weights_only=True)
    jparams = import_torch_state_dict(sd, strict=True)
    sj = jax_spec_for(ft_graphs, batch_size=2)
    _, _, pj = JaxTrainer(JaxModel(**SMALL), optax.sgd(0.0)).test(
        jparams, JaxLoader(ft_graphs[6:], 2, spec=sj))
    _close(p, pj)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with profile_trace(None):  # off: no directory
        pass
    assert sorted(os.listdir(tmp_path)) == ["prof"]
