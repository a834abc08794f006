"""The port's model variants and ablations (fragnet_tpu_torch/model/
variants.py: gat2_lite, gat2_edge, gcn2; model/ablations.py: v1 gat, gcn,
gcn3) against fragnet_tpu's, on the CPU, with weights carried across by
``state_dict_from_jax(..., family=)``. Small models: 2 layers, emb 32, 2
heads (v1: its fixed 3), FTHead3 32-wide; ``edge_features`` stays 17, so
v1's bond heads are 5 wide and get padded to the kernels' 8.

* Each whole model on the aligned-tcsr route (the plain versions of the
  kernels), gat2_lite and gat2_edge also on the aligned-attr route, on a
  tile-aligned batch with two padding graphs: the prediction and every
  parameter's gradient against the JAX model and ``jax.grad`` within 1e-4
  relative (a gradient the port leaves None — an output computed and
  unused — is zero on the JAX side).
* v1's padded bond pass (K1's plain version on ``tm_bond``) against the
  unpadded segment pass, forward 1e-6, gradients 1e-5; it takes the TCSR
  route whatever ``kernel.bond`` says.
* gat2_edge's layer with ``add_frag_self_loops`` against the JAX layer on
  the kernel routes and the segment path.
* Adam on those gradients (None in the port, zeros in optax) step for
  step; the ablations' fixed 0.15 head dropout.
* ``import_torch_state_dict(..., family=)`` round trips for gat2_lite,
  gat2_edge, gcn2 and gat, exactly; strict loads for all six.
* Every JAX model_version builds in the port; ``run_finetune(device=
  "cpu")`` trains and predicts with each of the six (gat2_lite also under
  dense-attr), each kernel wrapper called as often as chip_smoke.py's
  phase 28 expects the kernel to launch on the card; phase 28's configs.
"""

import dataclasses
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.config import Config as JaxConfig
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model import variants as jv
from fragnet_tpu.train import optim as jax_optim
from fragnet_tpu.train.checkpoint import import_torch_state_dict
from fragnet_tpu.train.finetune import build_model as jax_build_model
from fragnet_tpu.train.loop import mse_loss as jax_mse

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model import ablations as pa
from fragnet_tpu_torch.model import layers as player
from fragnet_tpu_torch.model import variants as pv
from fragnet_tpu_torch.model.layers import KernelPolicy
from fragnet_tpu_torch.ops import dense_gat, tcsr_gat
from fragnet_tpu_torch.ops.segment import gat_attention_pass
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import (MODEL_VERSIONS, build_model,
                                              run_finetune)
from fragnet_tpu_torch.train.loop import mse_loss
from fragnet_tpu_torch.train.optim import make_optimizer

MODEL = dict(num_layer=2, num_heads=2, emb_dim=32, drop_ratio=0.1, h1=32,
             h2=32, h3=32, h4=32, act="relu", fthead="FTHead3")
NEW = ("gat2_lite", "gat2_edge", "gcn2", "gat", "gcn", "gcn3")
GAT_FAMILIES = ("gat2_lite", "gat2_edge")  # the kernel policy applies
# the modules whose output reaches no prediction, in every layer
UNUSED = {"gat": ("projection_b", "a_b", "edge_embed"),
          "gcn": ("edge_embed",), "gcn2": ("edge_embed",)}
# the fragment-level modules of each layer
FRAG_MODULES = {"gat2_edge": ("f", "cnx_attr_transform"),
                **{mv: ("frag_mlp",) for mv in ("gcn2", "gat", "gcn", "gcn3")}}
ROUND_TRIP = ("gat2_lite", "gat2_edge", "gcn2", "gat")  # JAX has a mapper
PORT_CLASS = {"gat2": "FragNetFineTune",
              "gat2_transformer": "FragNetFineTuneTransformer",
              "gat2_transformer2": "FragNetFineTuneTransformer2",
              "gat2_multitask": "FragNetFineTuneMultiTask",
              "gat2_lite": "FragNetFineTuneLite",
              "gat2_edge": "FragNetFineTuneEdge",
              "gcn2": "FragNetFineTuneGCN", "gat": "_AblationFineTune",
              "gcn": "_AblationFineTune", "gcn3": "_AblationFineTune"}
# ibuprofen last: its 33 atoms straddle the first 128-row tile, so the
# aligned batch has padding rows before it
ORDER = [0, 1, 2, 4, 5, 6, 7, 3]
ATTR = KernelPolicy(attr=True, fc="attr")
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None, dp_atom=None, dp_frag=None)


def _cfg(mv, **extra):
    return {"seed": 3, "model_version": mv,
            "finetune": {"model": dict(MODEL), **extra}}


def _module(name):
    """A parameter's module within its encoder layer (or its head's)."""
    return re.sub(r"^pretrain\.layers?\.?\d+\.", "", name).split(".")[0]


def _layer(name):
    """A parameter's encoder layer, from 0 (the head's: None)."""
    m = re.match(r"^pretrain\.layers?\.?(\d+)\.", name)
    if m is None:
        return None
    return int(m[1]) - (1 if name.startswith("pretrain.layer") and
                        not name.startswith("pretrain.layers") else 0)


def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


def _close(port, ref, rel):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch forwards: one intra-op thread, so that test workers
    sharing the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs(ft_graphs):
    """(JAX graphs, port graphs) of the eight molecules, in ORDER."""
    builder = PortBuilder("exp1s")
    jg = [ft_graphs[i] for i in ORDER]
    return jg, [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                              smiles=g.smiles) for g in jg]


@pytest.fixture(scope="module")
def aligned(graphs):
    """(JAX batch, port batch): the eight molecules and two padding graphs,
    tile-aligned with TCSR metadata and planes."""
    jg, pg = graphs
    kw = dict(batch_size=len(jg) + 2, tcsr=True, align=True)
    bj = jax_pad_batch(jg, jax_spec_for(jg, **kw))
    bp = pad_batch(pg, spec_for(pg, **kw))
    assert bp.tm_bond is not None and bp.dp_atom is not None
    assert (bp.graph_mask == 0).sum() == 2
    return _jnp(bj), to_device(bp, "cpu")


@pytest.fixture(scope="module")
def carried(aligned):
    """{model_version: (JAX model, params, loss and grads, port state)}:
    the JAX package's build_model at MODEL's widths, seeded params, the
    MSE loss and jax.grad on the aligned batch, and the port's
    state_dict carried by state_dict_from_jax(family=)."""
    # the JAX variants and ablations run the segment path: no kernel fields
    bj = dataclasses.replace(aligned[0], **_NO_KERNELS)
    out = {}
    for i, mv in enumerate(NEW):
        model = jax_build_model(JaxConfig(_cfg(mv)), n_classes=1)
        params = jax.jit(lambda k, b, m=model: m.init(
            k, b, deterministic=True))(jax.random.PRNGKey(i), bj)

        def loss(p, m=model):
            pred = m.apply(p, bj, deterministic=True)
            return jax_mse(pred, bj.y, bj.graph_mask), pred

        (l_j, pred_j), g_j = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        out[mv] = (model, params, (l_j, pred_j, jax.device_get(g_j)),
                   state_dict_from_jax(params, family=mv))
    return out


def _port(mv, sd, policy=KernelPolicy()):
    model = build_model(Config(_cfg(mv)), n_classes=1, policy=policy)
    model.load_state_dict(sd, strict=True)
    return model.eval()


ROUTES = [(mv, "aligned-tcsr") for mv in NEW] + \
    [(mv, "aligned-attr") for mv in GAT_FAMILIES]


@pytest.mark.parametrize("mv,route", ROUTES)
def test_model_matches_jax(aligned, carried, mv, route):
    """Prediction and every parameter's gradient (eval mode, the route's
    plain kernel versions) against the JAX model and jax.grad on the same
    tile-aligned batch with padding graphs, 1e-4 relative."""
    bj, bp = aligned
    _model, _params, (loss_j, pred_j, grads_j), sd = carried[mv]
    port = _port(mv, sd, ATTR if route == "aligned-attr" else KernelPolicy())
    pred_p = port(bp)
    assert pred_p.shape == pred_j.shape
    _close(pred_p, pred_j, 1e-4)
    loss_p = mse_loss(pred_p, bp.y, bp.graph_mask)
    loss_p.backward()
    _close(loss_p, loss_j, 1e-4)
    want = state_dict_from_jax(grads_j, family=mv)
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    unused = {n for n, p in names.items() if p.grad is None}
    for name, p in names.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert torch.isfinite(got).all(), name
        if float(want[name].abs().max()) <= 1e-6 * scale:
            # off the loss's path: zero in both up to round-off
            assert float(got.abs().max()) <= 1e-6 * scale, name
        else:
            _close(got, want[name], 1e-4)
    # None: the outputs computed and unused (the reference's quirks), and
    # the fragment modules before the last layer (each layer recomputes the
    # fragment state from atoms)
    assert unused == {n for n in names if _module(n) in UNUSED.get(mv, ())
                      or (_module(n) in FRAG_MODULES.get(mv, ())
                          and _layer(n) < MODEL["num_layer"] - 1)}


def test_v1_bond_pass_padded_matches_segment(aligned):
    """v1's bond pass, heads padded 5 → 8 on K1's plain version (the
    batch's tm_bond), against ops/segment.py's pass on the unpadded heads:
    forward 1e-6 of scale, the gradients of projection_b and a_b 1e-5. The
    pass takes the TCSR route under the default (planes) bond policy."""
    bp = aligned[1]
    assert bp.dp_bond is not None  # planes exist, yet the TCSR route runs
    layer = pa.FragNetLayerV1(
        atom_in=167, atom_out=32, edge_in=17, edge_out=32,
        generator=torch.Generator().manual_seed(5))
    assert (layer.num_heads, layer.head_dim) == (3, 5)
    E = bp.nf_bonds.shape[0]
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (E, 15)).astype(np.float32))

    def run(padded):
        layer.zero_grad(set_to_none=True)
        if padded:
            out = layer.bond_pass(bp.nf_bonds, bp)
        else:
            nf = layer.projection_b(bp.nf_bonds).reshape(E, 3, 5)
            ea = bp.ea_bonds[:, None, :].expand(-1, 3, 1)
            out, _ = gat_attention_pass(nf, ea, bp.bg_src, bp.bg_dst,
                                        layer.a_b, E, edge_mask=bp.bg_mask)
            out = out.reshape(E, 15) * bp.edge_mask[:, None]
        (out * g).sum().backward()
        return [out.detach(), layer.a_b.grad.clone(),
                layer.projection_b.weight.grad.clone()]

    calls = []
    orig = player.tcsr_gat_pass

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    player.tcsr_gat_pass = counted
    try:
        got = run(True)
    finally:
        player.tcsr_gat_pass = orig
    assert calls == [(E, 3, 8)]
    # the gradients sum over the edges in another order on each route
    for k, p, rel in zip(got, run(False), (1e-6, 1e-5, 1e-5)):
        assert float(p.abs().max()) > 0
        _close(k, p, rel)


def _carry_layer(params, prefix):
    """A JAX layer's params (its path ``prefix``) → the port layer's
    state_dict, through state_dict_from_jax."""
    tree = params["params"]
    for k in reversed(prefix):
        tree = {k: tree}
    sd = state_dict_from_jax(tree)
    return {k[len("pretrain.layers.0."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("route", ["aligned-tcsr", "aligned-attr",
                                   "segment"])
def test_edge_frag_self_loops_match_jax(aligned, route):
    """gat2_edge's layer with add_frag_self_loops (a field build_model never
    sets): the self-loops are the kernels' self_loops flag on the kernel
    routes and appended rows on the segment path; each against the JAX
    layer, 1e-4."""
    bj, bp = aligned
    jl = jv.FragNetLayerEdge(atom_in=167, atom_out=32, edge_in=17,
                             edge_out=32, cnx_in=6, num_heads=2,
                             add_frag_self_loops=True)
    bj = dataclasses.replace(bj, **_NO_KERNELS)
    params = jax.jit(jl.init)(jax.random.PRNGKey(7), bj.x_atoms,
                              bj.nf_bonds, bj)
    want = jax.jit(jl.apply)(params, bj.x_atoms, bj.nf_bonds, bj)
    pl = pv.FragNetLayerEdge(
        167, 32, 17, 32, cnx_in=6, num_heads=2, add_frag_self_loops=True,
        policy=ATTR if route == "aligned-attr" else KernelPolicy())
    pl.load_state_dict(_carry_layer(params, ("pretrain", "layers_0")),
                       strict=True)
    b = bp if route != "segment" else dataclasses.replace(
        bp, tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
        dp_bond=None, dp_fc=None, dp_atom=None, dp_frag=None)
    with torch.no_grad():
        got = pl(b.x_atoms, b.nf_bonds, b)
    for k, p in zip(got, want):
        _close(k, p, 1e-4)
    # the self-loops change the fragment output
    pl.add_frag_self_loops = False
    with torch.no_grad():
        assert not torch.allclose(pl(b.x_atoms, b.nf_bonds, b)[1], got[1])


def test_adam_skips_unused_parameters_as_optax(carried):
    """v1's bond GAT and edge embedding are off the loss's path: the
    port's gradients there are None (torch Adam skips the parameter),
    optax's zero (its update is then zero). Three Adam steps on the same
    gradients: every parameter within 1e-6 of optax's, those unchanged."""
    _model, params, (_l, _p, grads_j), sd = carried["gat"]
    port = _port("gat", sd)
    want = state_dict_from_jax(grads_j, family="gat")
    lr = 0.01
    tx = jax_optim.make_optimizer("adam", lr=lr)
    jp = params
    state = tx.init(jp)
    opt, _ = make_optimizer(port.parameters(), "adam", lr=lr)
    unused = UNUSED["gat"]
    step = jax.jit(lambda p, st: tx.update(grads_j, st, p))
    for _ in range(3):
        upd, state = step(jp, state)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for name, p in port.named_parameters():
            p.grad = None if _module(name) in unused \
                else want[name].clone()
        opt.step()
        back = state_dict_from_jax(jp, family="gat")
        for name, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       back[name].numpy(), rtol=1e-6,
                                       atol=1e-6)
    for name, p in port.named_parameters():
        if _module(name) in unused:
            assert torch.equal(p.detach(), sd[name]), name
            assert torch.equal(state_dict_from_jax(jp, family="gat")[name],
                               sd[name]), name


def test_ablation_head_dropout_is_fixed():
    """The ablations' head dropout is 0.15 whatever drop_ratio says (the
    encoder's input dropout takes drop_ratio), as in the JAX package."""
    cfg = _cfg("gcn3")
    cfg["finetune"]["model"]["drop_ratio"] = 0.4
    model = build_model(Config(cfg), n_classes=1)
    assert model.drop.p == 0.15 and model.pretrain.drop.p == 0.4


@pytest.mark.parametrize("mv", NEW)
def test_state_dict_round_trip(carried, mv):
    """Every JAX parameter has a port name and every port parameter is
    named (strict load); for the families the JAX package maps, the
    weights cross back through its import_torch_state_dict(family=) leaf
    for leaf. gat's layers are pretrain.layer{i+1}, the others'
    pretrain.layers.{i}."""
    _model, params, _g, sd = carried[mv]
    port = build_model(Config(_cfg(mv)), n_classes=1)
    assert set(sd) == set(port.state_dict())
    prefix = "pretrain.layer1." if mv == "gat" else "pretrain.layers.0."
    assert any(k.startswith(prefix) for k in sd)
    if mv not in ROUND_TRIP:
        return
    back = import_torch_state_dict(sd, template=params, strict=True,
                                   family=mv)
    lj = jax.tree_util.tree_leaves_with_path(params)
    lb = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(lj) == len(lb)
    for path, leaf in lj:
        np.testing.assert_array_equal(np.asarray(lb[path]), np.asarray(leaf))


@pytest.mark.parametrize("mv", MODEL_VERSIONS)
def test_every_model_version_builds(mv):
    """The JAX package's build_model and the port's build the same ten
    model_versions; an unknown one raises in both."""
    jax_build_model(JaxConfig(_cfg(mv)), n_classes=1)
    model = build_model(Config(_cfg(mv)), n_classes=1)
    assert type(model).__name__ == PORT_CLASS[mv]
    if mv == MODEL_VERSIONS[-1]:
        for build, cfg in ((jax_build_model, JaxConfig),
                           (build_model, Config)):
            with pytest.raises(ValueError, match="unknown model_version"):
                build(cfg(_cfg("gat3")), n_classes=1)


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py as a module."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WRAPPERS = {"tcsr_gat_fwd": tcsr_gat, "tcsr_gat_bwd": tcsr_gat,
            "dense_gat_fwd": dense_gat, "dense_gat_bwd": dense_gat,
            "dense_attr_fwd": dense_gat, "dense_attr_bwd": dense_gat}


@pytest.mark.parametrize("mv,attr", [(mv, False) for mv in NEW]
                         + [("gat2_lite", True)])
def test_run_finetune_cpu_trains_and_predicts(graphs, tmp_path, cs,
                                              monkeypatch, mv, attr):
    """One epoch through run_finetune on the CPU (aligned batches, the
    plain kernel versions), then the test predictions; each kernel
    wrapper is called as often as chip_smoke.py's finetune_expect counts
    the kernel's launches on the card (phase 28's check): none for gcn2,
    gcn and gcn3, K1 alone for v1 gat (its bond pass is off the loss's
    path), K1/K2 and K4/K5 (K7/K8 under dense-attr) for gat2_lite and
    gat2_edge."""
    _jg, pg = graphs
    kernel = {"kernel": {"attr": True, "fc": "attr"}} if attr else {}
    opt = Config(dict(_cfg(mv, target_type="regr", batch_size=4, n_epochs=1,
                           lr=1e-3, tcsr=True, **kernel),
                      exp_dir=str(tmp_path)))
    data = (pg, pg[:4], pg[4:], 1, "regr")
    spec = spec_for(pg + pg[:4] + pg[4:], batch_size=4, tcsr=True)
    test_w = list(BatchLoader(pg[4:], 4, spec=spec, n_tasks=1)._windows())
    expect = cs.finetune_expect(opt, data, spec, test_w)[0]
    calls = dict.fromkeys(WRAPPERS, 0)
    for name, mod in WRAPPERS.items():
        def counted(*a, _name=name, _orig=getattr(mod, name), **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    value, model = run_finetune(opt, quiet=True, datasets=data,
                                device="cpu")
    assert calls == {n: expect[n] for n in WRAPPERS}
    assert any(calls.values()) == (mv in ("gat2_lite", "gat2_edge", "gat"))
    assert type(model).__name__ == PORT_CLASS[mv]
    with open(tmp_path / "preds_seed_3.pkl", "rb") as f:
        preds = pickle.load(f)
    assert preds["pred"].shape == preds["y"].shape == (4, 1)
    assert np.isfinite(preds["pred"]).all() and np.isfinite(value)
    np.testing.assert_allclose(value, np.sqrt(np.mean(
        (preds["y"] - preds["pred"]) ** 2)), rtol=1e-6)


def test_chip_smoke_variant_opts_are_the_configs(cs):
    """chip_smoke.py phase 28's configs: the esol config's training path
    with the model_version, FAMILY_EPOCHS epochs and an exp_dir of their
    own; the six new families, gat2_lite also under dense-attr."""
    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {f"{prefix}{k}": v})
        return out

    assert set(cs.VARIANT_VERSIONS) == set(NEW)
    assert cs.VARIANT_RUNS == [(mv, False) for mv in cs.VARIANT_VERSIONS] \
        + [("gat2_lite", True)]
    for mv, attr in cs.VARIANT_RUNS:
        got = flat(cs.family_opt(mv, attr=attr).to_dict())
        want = flat(cs.smoke_opt(train=True, attr=attr).to_dict())
        assert set(got) == set(want)
        assert {k for k in got if got[k] != want[k]} == {
            "model_version", "finetune.n_epochs", "exp_dir"}
        assert got["model_version"] == mv
        assert got["finetune.n_epochs"] == cs.FAMILY_EPOCHS
        assert got["finetune.model.emb_dim"] == 128
        assert got["finetune.model.num_layer"] == 4
