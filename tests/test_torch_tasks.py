"""The port's DTA and CDRP tasks (fragnet_tpu_torch/data/{dta,cdrp}.py,
model/{dta,cdrp}.py, FragNetFineTuneBase, train/tasks.py, the standardized
finetune) against fragnet_tpu's, on the CPU, with weights carried across by
``state_dict_from_jax``. Small models: encoder 2 layers, emb 32, 2 heads;
protein transformer 2 layers, 2 heads, FFN 64, max_len 64 (emb 32 alone;
the DTA model fixes it at 128, as the JAX package does); CNN seq_len 100,
emb 50, 4 filters alone (the DTA model's own at its defaults over 64
positions); gene_dim 50.

* ``encode_protein``, the synthetic DTA and CDRP rows and the built
  graphs' protein / gene_expr / y equal the JAX package's exactly.
* ``ProteinTransformer``, ``ProteinCNN`` and ``GeneMLP`` against the JAX
  modules: atol = rtol = 1e-5, a token row of all zeros (a padding graph)
  finite and equal to JAX's.
* ``FragNetFineTuneBase.encode``, ``DTAModel`` (both encoders) and
  ``CDRPModel`` on a tile-aligned batch with two padding graphs, on the
  aligned-tcsr and aligned-attr routes (the plain kernel versions): the
  prediction and every parameter's gradient of the standardized loss
  against ``jax.grad``, 1e-4 relative.
* ``make_standardized_steps`` / ``make_standardized_ft_steps``: the loss
  and the raw-space predictions of the JAX steps within 1e-5.
* Strict ``state_dict_from_jax`` loads; the round trips through
  ``import_dta_state_dict`` (both encoders) and
  ``import_torch_state_dict(family="cdrp")`` give back the JAX parameters
  exactly.
* ``run_task(device="cpu")`` for DTA (from a CSV through
  ``finetune.data.path``) and CDRP (synthetic) writes its checkpoint;
  ``run_finetune`` with ``finetune.standardize=true`` reports its metric
  in raw label space.
"""

import copy
import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.data import cdrp as jcdrp_data
from fragnet_tpu.data import dta as jdta_data
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model import cdrp as jcdrp
from fragnet_tpu.model import dta as jdta
from fragnet_tpu.model.finetune import FragNetFineTune as JaxFineTune
from fragnet_tpu.model.finetune import FragNetFineTuneBase as JaxBase
from fragnet_tpu.model.layers import KernelPolicy as JaxPolicy
from fragnet_tpu.model.layers import set_kernel_policy
from fragnet_tpu.train import tasks as jtasks
from fragnet_tpu.train.checkpoint import (import_dta_state_dict,
                                          import_torch_state_dict)
from fragnet_tpu.train.loop import TrainState
from fragnet_tpu.train.optim import make_optimizer as jax_optimizer

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data import cdrp as pcdrp_data
from fragnet_tpu_torch.data import dta as pdta_data
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model import cdrp as pcdrp
from fragnet_tpu_torch.model import dta as pdta
from fragnet_tpu_torch.model.finetune import (FragNetFineTune,
                                              FragNetFineTuneBase)
from fragnet_tpu_torch.model.layers import KernelPolicy
from fragnet_tpu_torch.train import tasks as ptasks
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import run_finetune
from fragnet_tpu_torch.train.optim import make_optimizer

ENC = dict(num_layer=2, num_heads=2, emb_dim=32)
PROT = dict(protein_layers=2, protein_heads=2, protein_intermediate=64,
            protein_max_len=64)
GENE_DIM = 50
# ibuprofen last: its 33 atoms straddle the first 128-row tile
ORDER = [0, 1, 2, 4, 5, 6, 7, 3]
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None)
MODELS = {
    # name: (JAX model, port model)
    "base": (lambda: JaxBase(**ENC),
             lambda: FragNetFineTuneBase(**ENC)),
    "dta-transformer": (lambda: jdta.DTAModel(**ENC, **PROT),
                        lambda: pdta.DTAModel(**ENC, **PROT)),
    "dta-cnn": (lambda: jdta.DTAModel(**ENC, **PROT, protein_encoder="cnn"),
                lambda: pdta.DTAModel(**ENC, **PROT, protein_encoder="cnn")),
    "cdrp": (lambda: jcdrp.CDRPModel(**ENC, gene_dim=GENE_DIM),
             lambda: pcdrp.CDRPModel(**ENC, gene_dim=GENE_DIM)),
}
MEAN, SDEV = -1.3, 1.7


def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


def _close(port, ref, rel):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _carry(params, prefix):
    """A JAX submodule's params → the port's state_dict entries of the
    model-level path ``prefix``, the prefix's torch name stripped."""
    tree = params["params"]
    for k in reversed(prefix):
        tree = {k: tree}
    head = prefix[0] + "."
    return {k[len(head):] if k.startswith(head) else k: v
            for k, v in state_dict_from_jax(tree).items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch forwards: one intra-op thread, so that test workers
    sharing the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_encode_protein_matches_jax():
    rng = np.random.default_rng(0)
    for seq in ("ACDY", "Z" * 70, "".join(rng.choice(list("ABXZOU"), 30)),
                ""):
        for max_len in (10, 64):
            got = pdta_data.encode_protein(seq, max_len)
            want = jdta_data.encode_protein(seq, max_len)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def task_data():
    """{task: (JAX rows, port rows, JAX graphs, port graphs)} of a few
    synthetic pairs, built by each package."""
    jd = jdta_data.synthetic_dta_dataset(n=5, seed=0, seq_len_range=(20, 80))
    pd_ = pdta_data.synthetic_dta_dataset(n=5, seed=0, seq_len_range=(20, 80))
    (jc, jgenes) = jcdrp_data.synthetic_cdrp_dataset(n=5, n_cells=3,
                                                     gene_dim=GENE_DIM,
                                                     seed=0)
    (pc, pgenes) = pcdrp_data.synthetic_cdrp_dataset(n=5, n_cells=3,
                                                     gene_dim=GENE_DIM,
                                                     seed=0)
    return {
        "dta": (jd, pd_, jdta_data.build_dta_graphs(jd, max_seq_len=64),
                pdta_data.build_dta_graphs(pd_, max_seq_len=64)),
        "cdrp": ((jc, jgenes), (pc, pgenes),
                 jcdrp_data.build_cdrp_graphs(jc, jgenes),
                 pcdrp_data.build_cdrp_graphs(pc, pgenes)),
    }


def test_synthetic_rows_and_graphs_match_jax(task_data):
    """The same numpy draws give the same rows; the built graphs and their
    padded batch carry the same protein tokens, expression rows and
    labels."""
    jd, pd_, jg, pg = task_data["dta"]
    for col in ("smiles", "protein"):
        assert list(jd[col]) == list(pd_[col])
    np.testing.assert_array_equal(np.asarray(jd["y"]), pd_["y"])
    (jc, jgenes), (pc, (cells, expr)), jcg, pcg = task_data["cdrp"]
    for col in ("smiles", "cell_line"):
        assert list(jc[col]) == list(pc[col])
    np.testing.assert_array_equal(np.asarray(jc["y"]), pc["y"])
    assert list(jgenes.index) == list(cells)
    np.testing.assert_array_equal(jgenes.to_numpy(), expr)
    for field, (jgs, pgs) in (("protein", (jg, pg)),
                              ("gene_expr", (jcg, pcg))):
        assert len(jgs) == len(pgs) > 0
        for a, b in zip(jgs, pgs):
            assert a.smiles == b.smiles
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
            np.testing.assert_array_equal(a.y, b.y)
        bj = jax_pad_batch(jgs, jax_spec_for(jgs, batch_size=8))
        bp = pad_batch(pgs, spec_for(pgs, batch_size=8))
        assert getattr(bp, field).dtype == getattr(bj, field).dtype
        np.testing.assert_array_equal(getattr(bp, field),
                                      getattr(bj, field))
        np.testing.assert_array_equal(bp.y, bj.y)
        assert not getattr(bp, field)[len(pgs):].any()  # padding graphs


def test_read_dta_csv(tmp_path):
    """A Davis/KIBA-style CSV reads as the JAX package's pd.read_csv does
    (columns smiles, protein, y; y as float64)."""
    import pandas as pd

    path = tmp_path / "dta.csv"
    pd.DataFrame({"smiles": ["CCO", "c1ccccc1"], "protein": ["ACDY", "MKV"],
                  "y": [5.25, 7.0]}).to_csv(path, index=False)
    got = pdta_data.read_dta_csv(str(path))
    want = pd.read_csv(path)
    assert got["smiles"] == list(want["smiles"])
    assert got["protein"] == list(want["protein"])
    assert got["y"].dtype == np.float64
    np.testing.assert_array_equal(got["y"], want["y"].to_numpy())


def _tokens(rng, B, L, vocab=26):
    """(B, L) int32 tokens of varying real lengths, row 1 all padding."""
    t = np.zeros((B, L), np.int32)
    for i in range(B):
        if i == 1:
            continue
        n = int(rng.integers(L // 4, L + 1))
        t[i, :n] = rng.integers(1, vocab, n)
    return t


ENCODERS = {
    # name: (JAX module, port module, its params' path in a model, input)
    "ProteinTransformer": (
        jdta.ProteinTransformer(n_layers=2, emb_dim=32, n_heads=2,
                                intermediate=64, max_len=64),
        pdta.ProteinTransformer(n_layers=2, emb_dim=32, n_heads=2,
                                intermediate=64, max_len=64),
        ("target_model",), "tokens64"),
    "ProteinCNN": (
        jdta.ProteinCNN(seq_len=100, emb_dim=50, n_filters=4, kernel_size=8,
                        out_dim=30),
        pdta.ProteinCNN(seq_len=100, emb_dim=50, n_filters=4, kernel_size=8,
                        out_dim=30),
        ("target_model",), "tokens100"),
    "GeneMLP": (jcdrp.GeneMLP(gene_dim=GENE_DIM),
                pcdrp.GeneMLP(gene_dim=GENE_DIM), ("cell_model",), "genes"),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax(name):
    jmod, pmod, prefix, kind = ENCODERS[name]
    rng = np.random.default_rng(5)
    if kind == "genes":
        x = rng.standard_normal((4, GENE_DIM)).astype(np.float32)
        x[1] = 0.0
    else:
        x = _tokens(rng, 4, int(kind[len("tokens"):]))
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    # LayerNorm scales and biases away from 1 and 0, so they are checked
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * (1 + jnp.arange(v.size).reshape(v.shape) % 3)
        if any(s in jax.tree_util.keystr(p) for s in ("LayerNorm", "ln"))
        else v, params)
    pmod.load_state_dict(_carry(params, prefix), strict=True)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    got = pmod.eval()(torch.from_numpy(x))
    assert got.shape == want.shape
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_protein_attention_all_masked_row_is_finite():
    """Every key of a padding graph's row is masked: the weights are
    uniform and finite (the f32-minimum fill), and so are the gradients,
    in train mode too; a −inf fill would give NaN."""
    m = pdta.ProteinTransformer(n_layers=2, emb_dim=32, n_heads=2,
                                intermediate=64, max_len=64,
                                generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(np.random.default_rng(1), 3, 64))
    for train in (False, True):
        m.train(train)
        out = m(toks)
        assert torch.isfinite(out).all()
        out.square().sum().backward()
        for n, p in m.named_parameters():
            assert torch.isfinite(p.grad).all(), n
            p.grad = None


@pytest.fixture(scope="module")
def graphs(ft_graphs):
    """(JAX graphs, port graphs) of the eight molecules in ORDER, each with
    a seeded protein (64 positions) and expression row."""
    builder = PortBuilder("exp1s")
    rng = np.random.default_rng(7)
    prots = _tokens(rng, len(ORDER) + 1, 64)[np.r_[0, 2:len(ORDER) + 1]]
    genes = rng.standard_normal((len(ORDER), GENE_DIM)).astype(np.float32)
    jg, pg = [], []
    for k, i in enumerate(ORDER):
        g = ft_graphs[i]
        extra = dict(protein=prots[k], gene_expr=genes[k])
        jg.append(dataclasses.replace(g, **extra))
        pg.append(dataclasses.replace(builder.build(
            *port_engine.mol_3d(g.smiles), g.y, smiles=g.smiles), **extra))
    return jg, pg


@pytest.fixture(scope="module")
def aligned(graphs):
    """(JAX batch, port batch): the eight molecules and two padding graphs
    (all-zero protein and expression rows), tile-aligned with TCSR
    metadata and planes."""
    jg, pg = graphs
    kw = dict(batch_size=len(jg) + 2, tcsr=True, align=True)
    bj = jax_pad_batch(jg, jax_spec_for(jg, **kw))
    bp = pad_batch(pg, spec_for(pg, **kw))
    assert bp.tm_atom is not None and bp.dp_atom is not None
    assert (bp.graph_mask == 0).sum() == 2
    assert not bp.protein[-2:].any() and bp.protein.dtype == np.int32
    return _jnp(bj), bp


@pytest.fixture(scope="module")
def carried(aligned):
    """{model: (JAX model, params, port model)} with the same weights."""
    init_batch = dataclasses.replace(aligned[0], **_NO_KERNELS)
    out = {}
    for i, (name, (jcls, pcls)) in enumerate(MODELS.items()):
        model = jcls()
        params = model.init(jax.random.PRNGKey(i), init_batch,
                            deterministic=True)
        port = pcls()
        port.load_state_dict(state_dict_from_jax(params), strict=True)
        out[name] = (model, params, port.eval())
    return out


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


def _std_loss_jax(pred, bj):
    """The JAX standardized train loss (tasks.py:make_standardized_steps);
    for the encoder alone, of a fixed projection of its representation."""
    if pred.shape[1] != 1:
        pred = pred @ jnp.linspace(-1.0, 1.0, pred.shape[1])[:, None]
    y = (bj.y[:, 0] - MEAN) / (jnp.float32(SDEV) + 1e-5)
    m = bj.graph_mask
    return jnp.sum((pred[:, 0] - y) ** 2 * m) / jnp.maximum(jnp.sum(m), 1.0)


def _std_loss_port(pred, bp):
    if pred.shape[1] != 1:
        pred = pred @ torch.linspace(-1.0, 1.0, pred.shape[1])[:, None]
    mean, sdev = ptasks._label_stats(MEAN, SDEV, "cpu")
    return ptasks.standardized_loss(pred, bp.y, bp.graph_mask, mean, sdev)


@pytest.mark.parametrize("route", ["aligned-tcsr", "aligned-attr"],
                         indirect=True)
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(aligned, carried, name, route):
    """Prediction (for the encoder alone: encode's representation) and
    every parameter's gradient of the standardized loss (eval mode, the
    route's plain kernel versions) against the JAX model and jax.grad on
    the same tile-aligned batch with two padding graphs, 1e-4 relative;
    the padding graphs' rows finite."""
    bj, bp = aligned
    model, params, port = carried[name]

    def loss(p):
        pred = model.apply(p, bj, deterministic=True)
        return _std_loss_jax(pred, bj), pred

    (loss_j, pred_j), grads_j = jax.value_and_grad(loss, has_aux=True)(
        params)
    want = state_dict_from_jax(jax.device_get(grads_j))
    routed = copy.deepcopy(port)
    enc = routed.pretrain if name == "base" else routed.drug_model.pretrain
    for layer in enc.layers:
        layer.policy = route
    b = to_device(bp, "cpu")
    pred_p = routed.encode(b) if name == "base" else routed(b)
    assert pred_p.shape == pred_j.shape
    assert torch.isfinite(pred_p).all()
    _close(pred_p, pred_j, 1e-4)
    loss_p = _std_loss_port(pred_p, b)
    loss_p.backward()
    _close(loss_p, loss_j, 1e-4)
    names = dict(routed.named_parameters())
    assert set(names) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for n, p in names.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert torch.isfinite(got).all(), n
        if float(want[n].abs().max()) <= 1e-6 * scale:
            # off the loss's path (layer 0's frag attention; embedding rows
            # no token uses): zero in both up to round-off
            assert float(got.abs().max()) <= 1e-6 * scale, n
        else:
            _close(got, want[n], 1e-4)


@pytest.mark.parametrize("name", ["dta-transformer", "dta-cnn", "cdrp"])
def test_state_dict_round_trip(carried, name):
    """Every JAX parameter has a port name and every port parameter is
    named (strict load, in the fixture); the port's state_dict crosses back
    through the JAX package's own importers, leaf for leaf."""
    _model, params, port = carried[name]
    sd = state_dict_from_jax(params)
    assert set(sd) == set(port.state_dict())
    if name == "cdrp":
        back = import_torch_state_dict(sd, template=params, strict=True,
                                       family="cdrp")
    else:
        back = import_dta_state_dict(sd, template=params, strict=True)
    lj = jax.tree_util.tree_leaves_with_path(params)
    lb = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(lj) == len(lb)
    for path, leaf in lj:
        np.testing.assert_array_equal(np.asarray(lb[path]), np.asarray(leaf))


def test_fine_tune_keeps_its_names():
    """FragNetFineTune on FragNetFineTuneBase: its parameters are still
    pretrain.* and fthead.*, and its forward is the head on encode's
    representation."""
    ft = FragNetFineTune(**ENC, generator=torch.Generator().manual_seed(0))
    assert {k.split(".")[0] for k in ft.state_dict()} == {"pretrain",
                                                          "fthead"}
    assert isinstance(ft, FragNetFineTuneBase)


@pytest.fixture(scope="module")
def plain(graphs):
    """(JAX batch, port batch) of the eight molecules and two padding
    graphs without kernel metadata (the segment path), two labels each."""
    jg, pg = graphs
    y2 = {g.smiles: np.array([g.y[0], 2.0 * g.y[0] + 1.0], np.float32)
          for g in jg}
    jg = [dataclasses.replace(g, y=y2[g.smiles]) for g in jg]
    pg = [dataclasses.replace(g, y=y2[g.smiles]) for g in pg]
    kw = dict(batch_size=len(jg) + 2)
    return (_jnp(jax_pad_batch(jg, jax_spec_for(jg, **kw), n_tasks=2)),
            pad_batch(pg, spec_for(pg, **kw), n_tasks=2))


def test_standardized_steps_match_jax(plain):
    """make_standardized_steps (CDRP, dropout 0) and
    make_standardized_ft_steps (FragNetFineTune with two tasks, per-task
    mean and sdev), one encoder layer: the train step's loss and the raw-space predictions
    equal the JAX steps' within 1e-5."""
    bj, bp = plain
    init_batch = dataclasses.replace(bj, **_NO_KERNELS)
    enc = dict(ENC, num_layer=1)  # one layer: the JAX steps compile
    cases = [
        ("steps", jcdrp.CDRPModel(**enc, gene_dim=GENE_DIM, drop_ratio=0.0),
         lambda: pcdrp.CDRPModel(**enc, gene_dim=GENE_DIM, drop_ratio=0.0),
         MEAN, SDEV),
        ("ft_steps", JaxFineTune(**enc, n_classes=2, drop_ratio=0.0),
         lambda: FragNetFineTune(**enc, n_classes=2, drop_ratio=0.0),
         np.array([MEAN, 0.4], np.float32), np.array([SDEV, 2.5],
                                                     np.float32)),
    ]
    for kind, jmodel, pcls, mean, sdev in cases:
        params = jmodel.init(jax.random.PRNGKey(3), init_batch,
                             deterministic=True)
        port = pcls()
        port.load_state_dict(state_dict_from_jax(params), strict=True)
        tx = jax_optimizer("adam", lr=1e-3)
        opt, _ = make_optimizer(port.parameters(), "adam", lr=1e-3)
        if kind == "steps":
            j_train, j_pred = jtasks.make_standardized_steps(jmodel, tx,
                                                             mean, sdev)
            p_train, p_pred = ptasks.make_standardized_steps(port, opt, mean,
                                                             sdev, "cpu")
            want_pred = j_pred(params, bj)
            got_pred = p_pred(bp)
        else:
            j_train, j_eval = jtasks.make_standardized_ft_steps(jmodel, tx,
                                                                mean, sdev)
            p_train, p_eval = ptasks.make_standardized_ft_steps(port, opt,
                                                                mean, sdev,
                                                                "cpu")
            want_l, want_pred = j_eval(params, bj)
            got_l, got_pred = p_eval(bp)
            np.testing.assert_allclose(float(got_l), float(want_l),
                                       rtol=1e-5)
        assert got_pred.shape == want_pred.shape
        np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                                   rtol=1e-5, atol=1e-5)
        # raw label space: the standardized output scaled back
        with torch.no_grad():
            out = port.eval()(to_device(bp, "cpu"))
        raw = out * (torch.as_tensor(sdev) + 1e-5) + torch.as_tensor(mean)
        np.testing.assert_allclose(
            got_pred.numpy(), (raw[:, 0] if kind == "steps" else raw).numpy(),
            rtol=1e-6, atol=1e-6)
        state = TrainState.create(jax.tree.map(jnp.copy, params), tx)
        _state, want_loss = j_train(state, bj, jax.random.PRNGKey(0))
        got_loss = p_train(bp)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)


def _task_opt(tmp_path, **model):
    return Config({
        "seed": 3, "exp_dir": str(tmp_path),
        "finetune": {"model": dict(ENC, **model), "batch_size": 4,
                     "n_epochs": 2, "lr": 1e-3, "es_patience": 5,
                     "data": {"n_synthetic": 10}}})


@pytest.mark.parametrize("task", ["dta", "cdrp"])
def test_run_task_cpu_trains_and_checkpoints(tmp_path, task, monkeypatch):
    """run_task on the CPU, 2 epochs: DTA from a small CSV through
    finetune.data.path (the protein transformer cut to one layer here, over
    the 1000 positions of encode_protein), CDRP from the synthetic
    generator; the test RMSE is finite and the checkpoint holds the
    returned model's parameters."""
    monkeypatch.setattr(pdta, "DTAModel", functools.partial(
        pdta.DTAModel, protein_layers=1, protein_heads=2,
        protein_intermediate=64))
    opt = _task_opt(tmp_path)
    if task == "dta":
        rows = pdta_data.synthetic_dta_dataset(n=10, seed=4,
                                               seq_len_range=(20, 40))
        path = tmp_path / "pairs.csv"
        with open(path, "w") as f:
            f.write("smiles,protein,y\n")
            for s, p, y in zip(rows["smiles"], rows["protein"], rows["y"]):
                f.write(f"{s},{p},{float(y)!r}\n")
        opt.set_path("finetune.data.path", str(path))
    rmse, model = ptasks.run_task(task, opt, quiet=True, device="cpu")
    assert np.isfinite(rmse)
    if task == "dta":
        assert len(model.target_model.encoder.layer) == 1
        assert model.target_model.emb.position_embeddings.weight.shape[0] \
            == pdta_data.MAX_SEQ_LEN
    else:
        assert model.cell_model.predictor[0].in_features == \
            pcdrp_data.GENE_DIM
    sd = torch.load(tmp_path / f"{task}.ckpt", weights_only=True)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_run_task_needs_a_card_unless_asked(tmp_path):
    """With no device named, run_task runs on CUDA, which raises here;
    an unknown task raises before any work."""
    with pytest.raises(ValueError, match="unknown task"):
        ptasks.run_task("gdsc", _task_opt(tmp_path), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptasks.run_task("cdrp", _task_opt(tmp_path))


def test_run_finetune_standardized_reports_raw_space(graphs, tmp_path):
    """finetune.standardize=true: the loss trains on standardized labels
    and the test predictions come back in raw label space — the model's
    output times (sdev + 1e-5) plus the mean of the train labels — and
    the reported RMSE is theirs."""
    _jg, pg = graphs
    offset = 50.0  # labels far from 0, so raw and standardized differ
    pg = [dataclasses.replace(g, y=g.y + offset) for g in pg]
    opt = Config({"seed": 3, "exp_dir": str(tmp_path),
                  "finetune": {"model": dict(ENC, drop_ratio=0.1),
                               "target_type": "regr", "batch_size": 4,
                               "n_epochs": 1, "lr": 1e-3, "tcsr": True,
                               "standardize": True}})
    value, model = run_finetune(opt, quiet=True,
                                datasets=(pg, pg[:4], pg[4:], 1, "regr"),
                                device="cpu")
    with open(tmp_path / "preds_seed_3.pkl", "rb") as f:
        preds = pickle.load(f)
    ys = np.stack([g.y for g in pg]).astype(np.float32)
    mean, sdev = ys.mean(axis=0), ys.std(axis=0) + np.float32(1e-5)
    spec = spec_for(pg + pg[:4] + pg[4:], batch_size=4, tcsr=True)
    b = to_device(pad_batch(pg[4:], spec), "cpu")
    with torch.no_grad():
        out = model.eval()(b).numpy()[:4]
    np.testing.assert_allclose(preds["pred"], out * sdev + mean, rtol=1e-5)
    assert abs(float(preds["pred"].mean()) - offset) < 10.0
    np.testing.assert_allclose(value, np.sqrt(np.mean(
        (preds["y"] - preds["pred"]) ** 2)), rtol=1e-6)


def test_chip_smoke_task_opts_and_chunks():
    """chip_smoke.py phase 27's configs are run_task's at the model
    defaults (the JAX DTAModel's and CDRPModel's), and its chunked
    featurization gives load_task_graphs' graphs in the same order."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    jdefaults = jdta.DTAModel()
    for task, enc, attr in (("dta", "transformer", False),
                            ("dta", "cnn", False), ("cdrp", "transformer",
                                                    False),
                            ("dta", "transformer", True)):
        opt = cs.task_opt(task, enc, attr)
        m = opt.finetune.model
        assert (m.num_layer, m.num_heads, m.emb_dim, m.drop_ratio) == (
            jdefaults.num_layer, jdefaults.num_heads, jdefaults.emb_dim,
            jdefaults.drop_ratio)
        assert opt.finetune.batch_size == 16
        assert opt.finetune.data.n_synthetic == cs.TASK_N == 96
        assert opt.finetune.n_epochs == (1 if attr else cs.TASK_EPOCHS)
        assert bool(opt.finetune.get("kernel", {}).get("attr")) == attr
    rows = pdta_data.synthetic_dta_dataset(n=5, seed=42)
    chunks = cs._row_chunks(rows, 3)
    assert [len(c["y"]) for c in chunks] == [2, 2, 1]
    for col in rows:
        assert list(np.concatenate([np.asarray(c[col]) for c in chunks])) \
            == list(np.asarray(rows[col]))
    df, genes = pcdrp_data.synthetic_cdrp_dataset(n=4, gene_dim=GENE_DIM,
                                                  seed=42)
    got = [g for c in cs._row_chunks(df, 3)
           for g in cs._task_chunk(("cdrp", c, genes, 42))]
    want = pcdrp_data.build_cdrp_graphs(df, genes, seed=42)
    assert [g.smiles for g in got] == [g.smiles for g in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.x_atoms, b.x_atoms)
        np.testing.assert_array_equal(a.gene_expr, b.gene_expr)


def test_chip_smoke_protein_bound_counts_real_residues():
    """chip_smoke.py's protein-encoder cost: over all positions by default;
    with each row's real length, the transformer's row-wise work scales
    with Σ L_i and its attention with Σ L_i² (a padding row adds
    nothing), while the CNN, whose padding positions carry token 0's
    embedding, costs the same."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    B, L, E, F, n_layers = 3, 10, 4, 8, 2
    dims = (n_layers, E, 2, F, 123)
    full = cs._protein_cost("transformer", B, L, dims)
    assert cs._protein_cost("transformer", B, L, dims, [L] * B) == full
    _nbytes, flops = cs._protein_cost("transformer", B, L, dims, [4, 6, 0])
    rows, pairs = 10, 16 + 36
    assert flops == 3 * n_layers * (8 * rows * E * E + 4 * pairs * E
                                    + 4 * rows * E * F)
    assert flops < full[1]
    cnn = (50, L, 4, 8, 16, 99)
    assert cs._protein_cost("cnn", B, L, cnn, [4, 6, 0]) == \
        cs._protein_cost("cnn", B, L, cnn)


def test_protein_and_genes_survive_the_loaders(graphs):
    """The protein tokens (int8 in the packed layout, widened to int32)
    and the expression rows reach the model intact through the
    device-cached loader (run_task's) and a packed buffer: int32 tokens
    that nn.Embedding takes, equal to pad_batch's."""
    from fragnet_tpu_torch.data.batcher import BatchLoader, DeviceCacheLoader
    from fragnet_tpu_torch.data.packing import (build_layout, pack_batch,
                                                unpack_batch)

    _jg, pg = graphs
    spec = spec_for(pg, batch_size=len(pg) + 2, tcsr=True)
    want = pad_batch(pg, spec)
    cached = list(DeviceCacheLoader(BatchLoader(pg, len(pg) + 2, spec=spec),
                                    device="cpu"))
    layout = build_layout(want, aligned=True)
    packed = unpack_batch(torch.from_numpy(pack_batch(want, layout,
                                                      validate=True)),
                          layout, planes=())
    for got in (cached[0], packed):
        assert got.protein.dtype == torch.int32
        np.testing.assert_array_equal(got.protein.numpy(), want.protein)
        assert got.gene_expr.dtype == torch.float32
        np.testing.assert_array_equal(got.gene_expr.numpy(), want.gene_expr)
    emb = pdta.ProteinTransformer(n_layers=1, emb_dim=32, n_heads=2,
                                  intermediate=64, max_len=64).eval()
    with torch.no_grad():
        assert torch.equal(emb(packed.protein),
                           emb(torch.from_numpy(want.protein)))
