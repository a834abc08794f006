"""The port's models on the gat2 encoder (fragnet_tpu_torch/model/
transformer.py: gat2_transformer, gat2_transformer2, gat2_multitask)
against fragnet_tpu's, on the CPU, with weights carried across by
``state_dict_from_jax``. Small models: 2 layers, emb 32, 2 heads,
TransformerConv with 2 heads, one EncoderBlock per level, max_seq_len 32
(so ibuprofen's 33 atoms reach past it).

* ``TransformerConv``, ``MultiheadAttention``, ``EncoderBlock`` and
  ``TransformerEncoder`` against the JAX modules on seeded numpy inputs
  with masked edges, padded nodes, padding graphs, padding rows between
  molecules and a molecule longer than max_seq_len: atol = rtol = 1e-5.
* ``_dense_mol_layout`` on a tile-aligned batch (padding rows between
  molecules): positions 0..n-1 per molecule; nodes past max_seq_len are
  dropped from the attention.
* Each whole model on the aligned-tcsr and aligned-attr routes (the plain
  versions of the kernels) on a tile-aligned batch with two padding
  graphs: the prediction and every parameter's gradient against
  ``jax.grad`` within 1e-4 relative; every gradient finite.
* frag_transformer's parameters do not reach the output (the reference's
  shared transformer), and do without compat_shared_transformer.
* Strict ``state_dict_from_jax`` loads for every family; the
  gat2_transformer round trip through ``import_torch_state_dict``.
* ``run_finetune(device="cpu")`` for each model_version (gat2_multitask as
  a 2-task classifier with missing labels); the refusals.
"""

import copy
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model import transformer as jt
from fragnet_tpu.model.layers import KernelPolicy as JaxPolicy
from fragnet_tpu.model.layers import set_kernel_policy
from fragnet_tpu.train.checkpoint import import_torch_state_dict
from fragnet_tpu.train.loop import bce_masked_loss as jax_bce
from fragnet_tpu.train.loop import mse_loss as jax_mse

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model import transformer as pt
from fragnet_tpu_torch.model.layers import KernelPolicy
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import build_model, run_finetune
from fragnet_tpu_torch.train.loop import bce_masked_loss, mse_loss

ENC = dict(num_layer=2, num_heads=2, emb_dim=32)
FAMILIES = {
    "gat2_transformer": (jt.FragNetFineTuneTransformer,
                         pt.FragNetFineTuneTransformer,
                         dict(h1=16, transformer_heads=2)),
    "gat2_transformer2": (jt.FragNetFineTuneTransformer2,
                          pt.FragNetFineTuneTransformer2,
                          dict(h1=16, num_attn_layer2=1, max_seq_len=32)),
    "gat2_multitask": (jt.FragNetFineTuneMultiTask,
                       pt.FragNetFineTuneMultiTask,
                       dict(n_multi_task_heads=2)),
}
# ibuprofen last: its 33 atoms straddle the first 128-row tile, so the
# aligned batch has padding rows before it
ORDER = [0, 1, 2, 4, 5, 6, 7, 3]
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None)


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
    assert bp.tm_atom is not None and bp.dp_atom is not None
    assert (bp.graph_mask == 0).sum() == 2
    return _jnp(bj), bp


@pytest.fixture(scope="module")
def carried(aligned):
    """{family: (JAX model, params, port model)} with the same weights."""
    init_batch = dataclasses.replace(aligned[0], **_NO_KERNELS)
    out = {}
    for i, (mv, (jcls, pcls, extra)) in enumerate(FAMILIES.items()):
        model = jcls(**ENC, **extra)
        params = jax.jit(lambda k, b, m=model: m.init(
            k, b, deterministic=True))(jax.random.PRNGKey(i), init_batch)
        port = pcls(**ENC, **extra)
        port.load_state_dict(state_dict_from_jax(params), strict=True)
        out[mv] = (model, params, port.eval())
    return out


def _carry_module(params, prefix):
    """A JAX submodule's params → the port submodule's state_dict, through
    state_dict_from_jax under the model-level path ``prefix``."""
    tree = params["params"]
    for k in reversed(prefix):
        tree = {k: tree}
    sd = state_dict_from_jax(tree)
    head = ".".join(p.replace("layers_", "layers.") for p in prefix) + "."
    return {k[len(head):]: v for k, v in sd.items()}


def _flat_inputs(rng):
    """A flat node batch: molecules of 5, 3, 11 (> S) and 4 nodes in graphs
    0, 1, 3, 4 (graph 2 and 5 empty: padding graphs), padding rows between
    molecules and at the end; edges within molecules, some masked, and
    padded edges (0 → 0, mask 0)."""
    batch_ids, node_mask, src, dst = [], [], [], []
    for gid, n in {0: 5, 1: 3, 3: 11, 4: 4}.items():
        first = len(batch_ids)
        src += list(first + rng.integers(0, n, 2 * n))
        dst += list(first + rng.integers(0, n, 2 * n))
        batch_ids += [gid] * n + [0, 0]
        node_mask += [1.0] * n + [0.0, 0.0]
    N = len(batch_ids)
    emask = np.r_[(rng.random(len(src)) > 0.2).astype(np.float32),
                  np.zeros(5, np.float32)]
    src, dst = src + [0] * 5, dst + [0] * 5
    x = rng.standard_normal((N, 16)).astype(np.float32)
    return dict(x=x, batch_ids=np.array(batch_ids, np.int32),
                node_mask=np.array(node_mask, np.float32),
                src=np.array(src, np.int32), dst=np.array(dst, np.int32),
                emask=emask, G=6)


MODULES = {
    # name: (JAX module, port module, its path in a model's params, args)
    "TransformerConv": (
        jt.TransformerConv(out_channels=8, heads=2),
        pt.TransformerConv(16, 8, 2), ("atom_transformer",), "conv"),
    "MultiheadAttention": (
        jt.MultiheadAttention(input_dim=16, embed_dim=16, num_heads=4,
                              max_seq_len=8),
        pt.MultiheadAttention(16, 16, 4, 8),
        ("transformer", "layers_0", "self_attn"), "seq"),
    "EncoderBlock": (
        jt.EncoderBlock(input_dim=16, num_heads=4, dim_feedforward=32,
                        max_seq_len=8),
        pt.EncoderBlock(16, 4, 32, 0.0, 8), ("transformer", "layers_0"),
        "seq"),
    "TransformerEncoder": (
        jt.TransformerEncoder(num_layers=2, input_dim=16, num_heads=4,
                              dim_feedforward=32, max_seq_len=8),
        pt.TransformerEncoder(2, 16, 4, 32, 0.0, 8), ("transformer",),
        "seq"),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    jmod, pmod, prefix, kind = MODULES[name]
    d = _flat_inputs(np.random.default_rng(3))
    if kind == "conv":
        args = (d["x"], d["src"], d["dst"], d["emask"], d["node_mask"])
        jargs, pargs = [jnp.asarray(a) for a in args], \
            [torch.from_numpy(a) for a in args]
    else:
        args = (d["x"], d["batch_ids"], d["node_mask"])
        jargs = [jnp.asarray(a) for a in args] + [d["G"]]
        pargs = [torch.from_numpy(a) for a in args] + [d["G"]]
    params = jmod.init(jax.random.PRNGKey(1), *jargs)
    # LayerNorm scale and bias away from 1 and 0, so they are checked
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * (1 + jnp.arange(v.size).reshape(v.shape) % 3)
        if "norm" in jax.tree_util.keystr(p) else v, params)
    pmod.load_state_dict(_carry_module(params, prefix), strict=True)
    want = jmod.apply(params, *jargs)
    got = pmod.eval()(*pargs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(got.detach().numpy()).all()
    # padded nodes are zero
    assert not got.detach().numpy()[d["node_mask"] == 0].any()


def test_dense_mol_layout_on_an_aligned_batch(aligned):
    """Positions are 0..n-1 within each molecule although padding rows lie
    between molecules; past max_seq_len a node is not valid; the port
    equals the JAX package's layout."""
    bj, bp = aligned
    mask = bp.atom_mask
    assert ((mask[:-1] == 0) & (mask[1:] == 1)).any()  # a gap
    G = bp.y.shape[0]
    for S in (32, 8):
        g, pos, valid = pt._dense_mol_layout(
            torch.from_numpy(bp.atom_batch), torch.from_numpy(mask), G, S)
        jg, jpos, jvalid = jt._dense_mol_layout(bj.atom_batch, bj.atom_mask,
                                                G, S)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        for gid in range(G):
            rows = np.flatnonzero((mask > 0) & (bp.atom_batch == gid))
            want = np.arange(len(rows))
            np.testing.assert_array_equal(valid.numpy()[rows], want < S)
            keep = rows[want < S]
            np.testing.assert_array_equal(pos.numpy()[keep], want[want < S])
            np.testing.assert_array_equal(g.numpy()[keep], gid)
        assert (g.numpy()[~valid.numpy()] == G).all()


def test_nodes_past_max_seq_len_do_not_reach_the_attention():
    """Changing a molecule's nodes past max_seq_len changes no other
    node's output, and their own output is o_proj of zero."""
    d = _flat_inputs(np.random.default_rng(4))
    mha = pt.MultiheadAttention(16, 16, 4, 8,
                                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mha.o_proj.bias.normal_(generator=torch.Generator().manual_seed(1))
    args = [torch.from_numpy(d[k]) for k in ("batch_ids", "node_mask")]
    x = torch.from_numpy(d["x"])
    _g, _pos, valid = pt._dense_mol_layout(*args, d["G"], 8)
    past = (~valid) & (args[1] > 0)
    assert int(past.sum()) == 3  # the 11-node molecule's last three
    x2 = x.clone()
    x2[past] += 5.0
    with torch.no_grad():
        a, b = mha(x, *args, d["G"]), mha(x2, *args, d["G"])
    assert torch.equal(a[~past], b[~past])
    assert torch.equal(a[past], mha.o_proj.bias.expand(3, -1))


@pytest.fixture
def route(request):
    """The kernel policy of the parametrised route, installed in the JAX
    package for the test and restored afterwards."""
    if request.param == "aligned-attr":
        set_kernel_policy(JaxPolicy(attr=True, fc="attr"))
        try:
            yield KernelPolicy(attr=True, fc="attr")
        finally:
            set_kernel_policy(JaxPolicy())
    else:
        yield KernelPolicy()


def _losses(mv, bj, bp):
    """(JAX loss of a prediction, port loss of one): masked BCE on seeded
    labels with missing ones (−1) for the multi-task model, else MSE."""
    if mv != "gat2_multitask":
        return (lambda p: jax_mse(p, bj.y, bj.graph_mask),
                lambda p: mse_loss(p, torch.from_numpy(bp.y),
                                   torch.from_numpy(bp.graph_mask)))
    labels = np.random.default_rng(6).choice(
        [-1.0, 0.0, 1.0], (bp.y.shape[0], 2)).astype(np.float32)
    return (lambda p: jax_bce(p, jnp.asarray(labels), bj.graph_mask),
            lambda p: bce_masked_loss(p, torch.from_numpy(labels),
                                      torch.from_numpy(bp.graph_mask)))


@pytest.mark.parametrize("route", ["aligned-tcsr", "aligned-attr"],
                         indirect=True)
@pytest.mark.parametrize("mv", list(FAMILIES))
def test_model_matches_jax(aligned, carried, mv, route):
    """Prediction and every parameter's gradient (eval mode, the route's
    plain kernel versions) against the JAX model and jax.grad on the same
    tile-aligned batch with padding graphs, 1e-4 relative."""
    bj, bp = aligned
    model, params, port = carried[mv]
    jloss, ploss = _losses(mv, bj, bp)

    def loss(p):
        pred = model.apply(p, bj, deterministic=True)
        return jloss(pred), pred

    (loss_j, pred_j), grads_j = jax.value_and_grad(loss, has_aux=True)(
        params)
    want = state_dict_from_jax(jax.device_get(grads_j))
    routed = copy.deepcopy(port)
    for layer in routed.pretrain.layers:
        layer.policy = route
    pred_p = routed(to_device(bp, "cpu"))
    assert pred_p.shape == pred_j.shape
    _close(pred_p, pred_j, 1e-4)
    loss_p = ploss(pred_p)
    loss_p.backward()
    _close(loss_p, loss_j, 1e-4)
    names = dict(routed.named_parameters())
    assert set(names) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in names.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert torch.isfinite(got).all(), name
        if float(want[name].abs().max()) <= 1e-6 * scale:
            # off the loss's path (frag_transformer; layer 0's frag
            # attention): zero in both up to round-off
            assert float(got.abs().max()) <= 1e-6 * scale, name
        else:
            _close(got, want[name], 1e-4)


@pytest.mark.parametrize("mv", list(FAMILIES))
def test_gradients_finite_with_padding_graphs(graphs, mv):
    """Three molecules in a batch of eight graphs (five padding graphs,
    whose every key is masked in the dense attention): the prediction and
    every gradient are finite, and the padding graphs' rows are the
    model's value on nothing."""
    _jg, pg = graphs
    b = to_device(pad_batch(pg[:3], spec_for(pg, batch_size=8, tcsr=True,
                                             align=True)), "cpu")
    _jcls, pcls, extra = FAMILIES[mv]
    model = pcls(**ENC, **extra, generator=torch.Generator().manual_seed(2))
    pred = model.eval()(b)
    assert torch.isfinite(pred).all()
    assert torch.equal(pred[3], pred[7])
    pred.square().sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name


def test_frag_transformer_is_unused_unless_asked(aligned, carried):
    """The port's copy of tests/test_model_family.py's check: perturbing
    frag_transformer leaves the output bit for bit; with
    compat_shared_transformer=False the fragment level uses it, as in the
    JAX package."""
    bj, bp = aligned
    model, params, port = carried["gat2_transformer"]
    b = to_device(bp, "cpu")
    mut = copy.deepcopy(port)
    with torch.no_grad():
        for p in mut.frag_transformer.parameters():
            p += 1.0
        assert torch.equal(mut(b), port(b))
    own = pt.FragNetFineTuneTransformer(
        **ENC, **FAMILIES["gat2_transformer"][2],
        compat_shared_transformer=False)
    own.load_state_dict(mut.state_dict(), strict=True)
    jmut = jax.tree.map(lambda x: x, params)
    jmut["params"]["frag_transformer"] = jax.tree.map(
        lambda x: x + 1.0, params["params"]["frag_transformer"])
    want = jt.FragNetFineTuneTransformer(
        **ENC, **FAMILIES["gat2_transformer"][2],
        compat_shared_transformer=False).apply(jmut, bj, deterministic=True)
    with torch.no_grad():
        got = own.eval()(b)
    _close(got, want, 1e-4)
    assert not torch.allclose(got, port(b))


@pytest.mark.parametrize("mv", list(FAMILIES))
def test_state_dict_from_jax_loads_strictly(carried, mv):
    """Every JAX parameter has a port name and every port parameter is
    named (strict load); the gat2_transformer weights also cross back
    through the JAX package's own mapper, leaf for leaf."""
    _model, params, port = carried[mv]
    sd = state_dict_from_jax(params)
    assert set(sd) == set(port.state_dict())
    if mv != "gat2_transformer":
        return  # the JAX package has no reverse mapper for these
    back = import_torch_state_dict(sd, template=params, strict=True,
                                   family="gat2_transformer")
    lj = jax.tree_util.tree_leaves_with_path(params)
    lb = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(lj) == len(lb)
    for path, leaf in lj:
        np.testing.assert_array_equal(np.asarray(lb[path]), np.asarray(leaf))


def _opt(tmp_path, mv, task):
    model = dict(ENC, drop_ratio=0.1, **FAMILIES[mv][2])
    model.pop("n_multi_task_heads", None)  # defaults to the task count
    return Config({
        "seed": 3, "exp_dir": str(tmp_path), "model_version": mv,
        "finetune": {"model": model, "target_type": task, "batch_size": 4,
                     "n_epochs": 1, "lr": 1e-3, "tcsr": True}})


@pytest.mark.parametrize("mv", list(FAMILIES))
def test_run_finetune_cpu_trains_and_predicts(graphs, tmp_path, mv):
    """One epoch through run_finetune on the CPU (aligned batches, the
    plain kernel versions), then the test predictions; gat2_multitask as
    a 2-task classifier with missing labels (−1), as the JAX package's
    tests/test_model_family.py runs it."""
    _jg, pg = graphs
    task, n_tasks = ("clsf", 2) if mv == "gat2_multitask" else ("regr", 1)
    if n_tasks == 2:
        labels = [[1, 0], [0, -1], [1, 1], [-1, 0], [0, 1], [1, 0], [0, 0],
                  [1, -1]]
        pg = [dataclasses.replace(g) for g in pg]
        for g, y in zip(pg, labels):
            g.y = np.asarray(y, np.float32)
    value, model = run_finetune(_opt(tmp_path, mv, task), quiet=True,
                                datasets=(pg, pg[:4], pg[4:], n_tasks, task),
                                device="cpu")
    assert type(model).__name__ == FAMILIES[mv][1].__name__
    with open(tmp_path / "preds_seed_3.pkl", "rb") as f:
        preds = pickle.load(f)
    assert preds["pred"].shape == preds["y"].shape == (4, n_tasks)
    assert np.isfinite(preds["pred"]).all() and np.isfinite(value)
    if task == "clsf":
        assert 0.0 <= value <= 1.0  # ROC-AUC
    else:
        np.testing.assert_allclose(value, np.sqrt(np.mean(
            (preds["y"] - preds["pred"]) ** 2)), rtol=1e-6)


def test_refusals(tmp_path):
    """Edge-partitioned training of a family other than gat2 raises
    ValueError before any rank starts, as in the JAX package; so does an
    unknown model_version."""
    opt = _opt(tmp_path, "gat2_transformer", "regr")
    opt.set_path("dist", {"mode": "ep", "n_devices": 2})
    with pytest.raises(ValueError, match="model_version=gat2"):
        run_finetune(opt, device="cpu")
    opt = _opt(tmp_path, "gat2_transformer", "regr")
    opt.set_path("model_version", "gat3")
    with pytest.raises(ValueError, match="unknown model_version"):
        build_model(opt, n_classes=1)


def test_chip_smoke_family_opts_are_the_configs():
    """chip_smoke.py phase 26's configs: the esol config's training path
    with the model_version, 2 epochs and an exp_dir of their own; the
    multi-task model's settings are configs/ft/clintox.yaml's. Its labels
    keep both classes of every task in every split, some missing."""
    import importlib.util
    import os

    from fragnet_tpu.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {f"{prefix}{k}": v})
        return out

    esol = flat(load_config(os.path.join(
        repo, "configs/ft/esol.yaml")).to_dict())
    clintox = flat(load_config(os.path.join(
        repo, "configs/ft/clintox.yaml")).to_dict())
    assert {k for k in esol if esol[k] != clintox[k]} == \
        set(cs.CLINTOX_OVERRIDES) | {"exp_dir"}
    assert set(cs.FAMILY_VERSIONS) == set(FAMILIES)
    for mv in cs.FAMILY_VERSIONS:
        for attr in (False, True):
            got = flat(cs.family_opt(mv, attr=attr).to_dict())
            want = flat(cs.smoke_opt(train=True, attr=attr).to_dict())
            assert set(got) == set(want)
            changed = {k for k in got if got[k] != want[k]}
            extra = set(cs.CLINTOX_OVERRIDES) if mv == "gat2_multitask" \
                else set()
            assert changed == {"model_version", "finetune.n_epochs",
                               "exp_dir"} | extra
            assert got["finetune.n_epochs"] == cs.FAMILY_EPOCHS
            for k in extra:
                assert got[k] == clintox[k]
    data = cs.multitask_datasets((_graph_stubs(20), _graph_stubs(10),
                                  _graph_stubs(10)))
    assert data[3:] == (2, "clsf")
    for split in data[:3]:
        y = np.stack([g.y for g in split])
        assert y.shape == (len(split), 2) and (y == -1).any()
        for t in range(2):
            assert {0.0, 1.0} <= set(y[:, t])


def _graph_stubs(n):
    @dataclasses.dataclass
    class Stub:
        y: np.ndarray

    return [Stub(np.zeros(1, np.float32)) for _ in range(n)]
