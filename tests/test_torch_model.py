"""The port's model and eval path against fragnet_tpu's, on the CPU: weights
carried across with ``state_dict_from_jax``, FragNetFineTune predictions,
all four attention vectors and every parameter gradient (aligned TCSR batch,
the same batch under the dense-attr kernel policy, and the segment path),
the trainer's test RMSE, ``run_finetune`` with ``n_epochs=0`` and, under the
dense-attr policy, one epoch, and the opt dict that ``chip_smoke.py``
drives. Small model:
2 layers, emb 32, 4 heads. Tolerance: 1e-4 relative (f32 through two
frameworks and ~10 ops deep)."""

import dataclasses
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from fragnet_tpu.config import load_config
from fragnet_tpu.data.batcher import BatchLoader as JaxLoader
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.model.layers import KernelPolicy as JaxPolicy
from fragnet_tpu.model.layers import set_kernel_policy
from fragnet_tpu.train.checkpoint import import_torch_state_dict
from fragnet_tpu.train.loop import TrainerFineTune as JaxTrainer
from fragnet_tpu.train.loop import mse_loss as jax_mse
from fragnet_tpu.train.optim import make_optimizer

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.model.layers import KernelPolicy
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import run_finetune
from fragnet_tpu_torch.train.loop import TrainerFineTune, mse_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layer=2, num_heads=4, emb_dim=32, h1=16, h2=16, h3=16,
             h4=16)


def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


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


@pytest.fixture(scope="module")
def aligned(ft_graphs, port_graphs):
    """(jax batch, port batch) of all eight molecules, tile-aligned TCSR."""
    kw = dict(batch_size=len(ft_graphs), tcsr=True, align=True)
    bj = jax_pad_batch(ft_graphs, jax_spec_for(ft_graphs, **kw))
    bp = pad_batch(port_graphs, spec_for(port_graphs, **kw))
    assert bp.tm_atom is not None and bp.dp_bond is not None
    return _jnp(bj), bp


_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None)


def _init(model, aligned, seed):
    # init on the segment path: the params do not depend on the kernels
    batch = dataclasses.replace(aligned[0], **_NO_KERNELS)
    return model.init(jax.random.PRNGKey(seed), batch, deterministic=True)


@pytest.fixture(scope="module")
def carried(aligned):
    """A JAX model's params and the port model holding the same weights."""
    model = JaxModel(**SMALL)
    params = _init(model, aligned, 0)
    port = FragNetFineTune(**SMALL)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, params, port.eval()


@pytest.fixture
def path_models(aligned, carried, request):
    """(JAX model, params, port model, JAX batch, port batch) for the
    parametrised path: "aligned-tcsr" (default policy), "aligned-attr"
    (KernelPolicy(attr=True, fc="attr") in both packages, the JAX one
    installed process-wide and restored afterwards) or "segment" (no kernel
    metadata)."""
    model, params, port = carried
    bj, bp = aligned
    path = request.param
    if path == "segment":
        bj = dataclasses.replace(bj, **_NO_KERNELS)
        bp = dataclasses.replace(bp, **_NO_KERNELS)
    if path != "aligned-attr":
        yield model, params, port, bj, bp
        return
    assert bp.dp_atom is not None and bp.dp_frag is not None
    attr = FragNetFineTune(**SMALL, policy=KernelPolicy(attr=True, fc="attr"))
    attr.load_state_dict(port.state_dict(), strict=True)
    set_kernel_policy(JaxPolicy(attr=True, fc="attr"))
    try:
        yield model, params, attr.eval(), bj, bp
    finally:
        set_kernel_policy(JaxPolicy())


_PATHS = ["aligned-tcsr", "aligned-attr", "segment"]


_ACTS = ("silu", "gelu", "celu", "selu", "rrelu", "relu6", "leakyrelu",
         "prelu")
_HEADS = ([pytest.param(h, "relu", id=h) for h in
           ("FTHead1", "FTHead3", "FTHead4", "FTHead2", "FTHead5")]
          + [pytest.param("FTHead3", a, id=f"FTHead3-{a}") for a in _ACTS]
          + [pytest.param(h, "prelu", id=f"{h}-prelu")
             for h in ("FTHead4", "FTHead5")])


@pytest.mark.parametrize("fthead,act", _HEADS)
def test_state_dict_round_trip(aligned, fthead, act):
    """Every head, and every activation of FTHead3 (prelu also under
    FTHead4 and FTHead5): the weights cross to the port, which names every
    parameter and predicts as the JAX model does (segment path, 1e-4
    relative), and back, leaf for leaf. act=prelu's scalar slope, set away
    from its 0.25 init, crosses as fthead.act.weight; the JAX package's
    mapper skips that name, so on the way back the JAX side gets its slope
    by hand."""
    model = JaxModel(**SMALL, fthead=fthead, act=act)
    params = _init(model, aligned, 1)
    flat = traverse_util.flatten_dict(params["params"])
    alpha = [k for k in flat if k[-1] == "alpha"]
    assert len(alpha) == (act == "prelu")
    for k in alpha:
        flat[k] = jnp.asarray(0.1, jnp.float32)
    params = {"params": traverse_util.unflatten_dict(flat)}
    sd = state_dict_from_jax(params)
    template = {"params": traverse_util.unflatten_dict(
        {k: v for k, v in flat.items() if k not in alpha})}
    back = import_torch_state_dict(sd, template=template, strict=True)
    if alpha:  # by hand: the JAX package's mapper skips the slope
        fb = traverse_util.flatten_dict(back["params"])
        fb[alpha[0]] = sd["fthead.act.weight"].numpy().reshape(())
        back = {"params": traverse_util.unflatten_dict(fb)}
    lj = jax.tree_util.tree_leaves_with_path(params)
    lb = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(lj) == len(lb)
    for path, leaf in lj:
        np.testing.assert_array_equal(np.asarray(lb[path]), np.asarray(leaf))
    port = FragNetFineTune(**SMALL, fthead=fthead, act=act)
    port.load_state_dict(sd, strict=True)  # every port param is named
    bj = dataclasses.replace(aligned[0], **_NO_KERNELS)
    bp = dataclasses.replace(aligned[1], **_NO_KERNELS)
    with torch.no_grad():
        got = port.eval()(to_device(bp, "cpu")).numpy()
    want = np.asarray(model.apply(params, bj, deterministic=True))
    _close(got, want)
    print(f"{fthead} {act}: forward max diff "
          f"{np.abs(got - want).max() / np.abs(want).max():.2e} of scale")


@pytest.mark.parametrize("path_models", _PATHS, indirect=True)
def test_forward_and_attentions_match(path_models):
    model, params, port, bj, bp = path_models
    pred_j, attn_j = model.apply(params, bj, deterministic=True,
                                 return_attentions=True)
    with torch.no_grad():
        pred_p, attn_p = port(to_device(bp, "cpu"), return_attentions=True)
        pred_only = port(to_device(bp, "cpu"))
    _close(pred_p, pred_j)
    assert torch.equal(pred_only, pred_p)
    for level in ("atoms", "frags", "bonds", "fbonds"):
        _close(getattr(attn_p, level), getattr(attn_j, level))


@pytest.mark.parametrize("path_models", _PATHS, indirect=True)
def test_parameter_gradients_match(path_models):
    """MSE of the carried model (eval mode: dropout off, gradients on): the
    loss and every parameter's gradient against jax.grad, the grad tree
    mapped through state_dict_from_jax (names and transposes)."""
    model, params, port, bj, bp = path_models

    def loss(p):
        return jax_mse(model.apply(p, bj, deterministic=True), bj.y,
                       bj.graph_mask)

    loss_j, grads_j = jax.value_and_grad(loss)(params)
    want = state_dict_from_jax(jax.device_get(grads_j))
    b = to_device(bp, "cpu")
    port.zero_grad(set_to_none=True)
    loss_p = mse_loss(port(b), b.y, b.graph_mask)
    loss_p.backward()
    try:
        _close(loss_p, loss_j)
        names = dict(port.named_parameters())
        assert set(names) == set(want)
        scale = max(float(w.abs().max()) for w in want.values())
        for name, p in names.items():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            if float(want[name].abs().max()) <= 1e-6 * scale:
                # off the loss's path (layer 0's frag attention: the next
                # layer recomputes fragment features from atoms): zero in
                # both up to round-off
                assert float(got.abs().max()) <= 1e-6 * scale, name
            else:
                _close(got, want[name])
    finally:
        port.zero_grad(set_to_none=True)


def test_trainer_test_rmse_matches(ft_graphs, port_graphs, carried):
    model, params, port = carried
    sj = jax_spec_for(ft_graphs, batch_size=4)
    sp = spec_for(port_graphs, batch_size=4)
    tx = make_optimizer("adam", lr=1e-4)
    mse_j, y_j, p_j = JaxTrainer(model, tx, target_type="regr").test(
        params, JaxLoader(ft_graphs, 4, spec=sj))
    trainer = TrainerFineTune(port, target_type="regr", device="cpu")
    mse_p, y_p, p_p = trainer.test(BatchLoader(port_graphs, 4, spec=sp))
    np.testing.assert_array_equal(y_p, np.asarray(y_j))
    _close(p_p, p_j)
    assert abs(np.sqrt(mse_p) - np.sqrt(mse_j)) <= 1e-4 * np.sqrt(mse_j)
    assert abs(trainer.validate(BatchLoader(port_graphs, 4, spec=sp))
               - mse_j) <= 1e-3 * mse_j  # batch-mean of MSE, a looser sum


def test_losses_metrics_and_predict_step_match(aligned, carried):
    from fragnet_tpu.train import loop as jloop
    from fragnet_tpu_torch.train import loop as ploop

    rng = np.random.default_rng(5)
    pred = rng.standard_normal((6, 3)).astype(np.float32)
    y = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.choice([-1.0, 0.0, 1.0], (6, 3)).astype(np.float32)
    gm = np.array([1, 1, 1, 1, 0, 0], np.float32)
    t, j = torch.from_numpy, jnp.asarray
    _close(ploop.mse_loss(t(pred), t(y), t(gm)),
           jloop.mse_loss(j(pred), j(y), j(gm)), 1e-6)
    _close(ploop.bce_masked_loss(t(pred), t(labels), t(gm)),
           jloop.bce_masked_loss(j(pred), j(labels), j(gm)), 1e-6)
    assert ploop.mean_per_task_auc(labels, pred) == \
        jloop.mean_per_task_auc(labels, pred)
    assert ploop.rmse_metric(y, pred) == jloop.rmse_metric(y, pred)
    port = carried[2]
    predict = ploop.make_predict_step(port, device="cpu")
    with torch.no_grad():
        want = port(to_device(aligned[1], "cpu"))
    assert torch.equal(predict(aligned[1]), want)


def test_roc_auc_is_sklearns_bit_for_bit():
    """The port's numpy ROC-AUC (the card's machine may have no sklearn)
    equals sklearn's roc_auc_score exactly, with tied scores and without."""
    from sklearn.metrics import roc_auc_score

    from fragnet_tpu_torch.train.loop import roc_auc_score as port_auc

    rng = np.random.default_rng(11)
    for case in range(600):
        n = int(rng.integers(2, 80))
        y = rng.integers(0, 2, n)
        y[:2] = (0, 1)
        score = (rng.integers(0, 6, n).astype(np.float32) if case % 2
                 else rng.standard_normal(n).astype(np.float32))
        assert port_auc(y, score) == roc_auc_score(y, score), case


def _small_opt(tmp_path, **finetune):
    opt = Config({
        "seed": 7, "exp_dir": str(tmp_path), "model_version": "gat2",
        "finetune": {
            "data": {"name": "esol", "split": "random", "n_synthetic": 16},
            "model": dict(SMALL, drop_ratio=0.1, act="relu",
                          fthead="FTHead3"),
            "target_type": "regr", "batch_size": 4, "n_epochs": 0,
            **finetune},
    })
    return opt


def test_run_finetune_refuses_what_it_does_not_run(tmp_path):
    from fragnet_tpu_torch.train.finetune import _model_version

    # the segment EP mode (dist.tcsr=false) runs, in f32 and bf16
    # (tests/test_torch_ep.py); a CPU multihost run runs too
    # (tests/test_torch_dist.py::test_torchrun_processes_join_on_the_cpu);
    # EP of another family than gat2 is refused, as in the JAX package
    for dtype in ("f32", "bf16"):
        opt = _small_opt(tmp_path, dtype=dtype)
        opt.set_path("dist", {"mode": "ep", "n_devices": 2, "tcsr": False,
                              "multihost": True})
        assert _model_version(opt, ep=True) == "gat2"
    lite = _small_opt(tmp_path)
    lite.set_path("model_version", "gat2_lite")
    lite.set_path("dist", {"mode": "ep", "n_devices": 2})
    with pytest.raises(ValueError, match="supports model_version=gat2"):
        run_finetune(lite, device="cpu")
    # a single-device GAT pass off the CPU needs TCSR or dense metadata: a
    # batch without it raises (a meta-device tensor stands in for a CUDA
    # one); an edge-partitioned one takes the segment EP pass instead
    from fragnet_tpu_torch.model.layers import _gat_dispatch

    nf = torch.empty((8, 4, 8), device="meta")
    idx = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="without TCSR tile metadata"):
        _gat_dispatch(nf, torch.empty((8, 4), device="meta"), idx, idx,
                      torch.empty((8,), device="meta"),
                      torch.empty((4, 20), device="meta"), num_nodes=8,
                      tm=None, dp=None, mode="tcsr")
    with pytest.raises(ValueError, match="bond='attr' is refused"):
        run_finetune(_small_opt(tmp_path, kernel={"bond": "attr"}),
                     device="cpu")
    if not torch.cuda.is_available():  # no quiet drop to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            run_finetune(_small_opt(tmp_path))


def test_run_finetune_cpu_writes_predictions(tmp_path, capsys):
    rmse, model = run_finetune(_small_opt(tmp_path, tcsr=True), device="cpu")
    out = capsys.readouterr().out
    assert "test rmse:" in out and "tcsr=True" in out
    with open(tmp_path / "preds_seed_7.pkl", "rb") as f:
        preds = pickle.load(f)
    assert preds["pred"].shape == preds["y"].shape
    assert preds["pred"].shape[0] > 0
    assert np.isfinite(preds["pred"]).all()
    np.testing.assert_allclose(
        preds["rmse"], np.sqrt(np.mean((preds["y"] - preds["pred"]) ** 2)),
        rtol=1e-6)
    assert rmse == preds["rmse"]


def test_run_finetune_cpu_attr_policy_trains(tmp_path):
    """One epoch under the dense-attr kernel policy on the CPU (the plain
    versions of K7-K9 carry the atom, frag and fconn passes)."""
    from fragnet_tpu_torch.ops import dense_gat, tcsr_gat

    calls = {"attr": 0, "tcsr": 0}
    origs = {"attr": (dense_gat, "dense_attr_fwd_plain"),
             "tcsr": (tcsr_gat, "tcsr_gat_fwd_plain")}
    saved = {k: getattr(mod, name) for k, (mod, name) in origs.items()}

    def counting(key):
        def rec(*a, **kw):
            calls[key] += 1
            return saved[key](*a, **kw)
        return rec

    for k, (mod, name) in origs.items():
        setattr(mod, name, counting(k))
    try:
        rmse, model = run_finetune(
            _small_opt(tmp_path, tcsr=True, n_epochs=1,
                       kernel={"attr": True, "fc": "attr"}), device="cpu")
    finally:
        for k, (mod, name) in origs.items():
            setattr(mod, name, saved[k])
    assert model.pretrain.layers[0].policy == KernelPolicy(attr=True,
                                                           fc="attr")
    assert np.isfinite(rmse)
    # every batch of these molecules carries atom, frag and fconn planes
    assert calls["tcsr"] == 0
    assert calls["attr"] > 0 and calls["attr"] % (3 * SMALL["num_layer"]) == 0


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_chip_smoke_opt_is_the_esol_config():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    esol = load_config(os.path.join(REPO, "configs/ft/esol.yaml")).to_dict()
    assert cs.ESOL_CONFIG == esol
    ref = _flat(esol)
    for train, overrides, epochs in (
            (False, cs.SMOKE_OVERRIDES, 0),
            (True, {**cs.SMOKE_OVERRIDES, **cs.TRAIN_OVERRIDES}, 3)):
        smoke = _flat(cs.smoke_opt(train=train).to_dict())
        assert set(smoke) == set(ref)
        changed = {k for k in ref if smoke[k] != ref[k]}
        assert changed == set(overrides)
        assert smoke["finetune.n_epochs"] == epochs
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    attr = cs.smoke_opt(train=True, attr=True)
    assert resolve_kernel_policy(attr.finetune) == KernelPolicy(attr=True,
                                                                fc="attr")
    assert _flat(attr.to_dict())["finetune.n_epochs"] == 3
    assert resolve_kernel_policy(cs.smoke_opt(train=True).finetune) == \
        KernelPolicy()
