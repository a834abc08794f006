"""The port's k-fold CV, bucketed loading and auxiliary pretraining against
fragnet_tpu's, on the CPU (small models: 2 layers, emb 32, 2 heads):

* CV: the folds equal the JAX split; with ``run_finetune`` stubbed in both
  packages every fold receives the same graphs (by SMILES) and
  ``cv_scores.pkl`` the same scores, mean and std; one real 2-fold run of
  one epoch is finite;
* buckets: the per-bucket PadSpecs equal the JAX package's field by
  field; over two shuffled epochs the batch stream (graph ids per batch,
  in order) equals the JAX package's, with and without the device cache,
  each graph once per epoch; ``run_finetune(finetune.n_buckets=3)`` is
  finite and calls each kernel wrapper as often as chip_smoke.py's
  ``bucket_expect`` counts its launches on the card;
* auxiliary pretraining: the SMILES, targets and class counts of the
  property (a CSV, one or all columns) and structure (ring counts) modes
  equal the JAX package's; the ``cel`` loss and its gradients against the
  JAX model with carried weights, 1e-4, padding graphs adding nothing;
  ``run_pretrain`` in both modes for one epoch is finite, calls the
  wrappers as ``aux_expect`` counts, and its checkpoint's encoder loads
  through ``pretrain.use`` into ``run_finetune``.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from fragnet_tpu.config import Config as JaxConfig
from fragnet_tpu.data import batcher as jax_batcher
from fragnet_tpu.data.splitters import cv_random_split as jax_cv_split
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel

from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data import batcher
from fragnet_tpu_torch.data.splitters import cv_random_split
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import MolGraph
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.ops import dense_gat, tcsr_gat
from fragnet_tpu_torch.train import pretrain as port_pretrain
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import run_finetune

SMALL = dict(num_layer=2, num_heads=2, emb_dim=32, drop_ratio=0.1, h1=32,
             h2=32, h3=32, h4=32, act="relu", fthead="FTHead3")
# small molecules, fast to embed, with 0-2 rings
AUX_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "C1CCCCC1", "c1ccncc1",
              "OCCO", "C1CC1", "c1ccc2ccccc2c1", "C1CCC2CCCCC2C1"]
WRAPPERS = {"tcsr_gat_fwd": tcsr_gat, "tcsr_gat_bwd": tcsr_gat,
            "dense_gat_fwd": dense_gat, "dense_gat_bwd": dense_gat,
            "dense_attr_fwd": dense_gat, "dense_attr_bwd": dense_gat}


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
def graphs(ft_graphs):
    """(JAX graphs, port graphs) of the eight molecules, y = their index
    (an id that survives batching)."""
    jg = [dataclasses.replace(g, y=np.array([float(i)], np.float32))
          for i, g in enumerate(ft_graphs)]
    # the port's MolGraphs by field copy (the featurizers agree array for
    # array; copying saves featurizing them again)
    pg = [MolGraph(**{f.name: getattr(g, f.name)
                      for f in dataclasses.fields(MolGraph)}) for g in jg]
    return jg, pg


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py as a module."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counting(monkeypatch):
    """Count each kernel wrapper's calls (the card's launches)."""
    calls = dict.fromkeys(WRAPPERS, 0)
    for name, mod in WRAPPERS.items():
        def counted(*a, _name=name, _orig=getattr(mod, name), **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _cfg(tmp_path, **finetune):
    return Config({"seed": 3, "exp_dir": str(tmp_path),
                   "model_version": "gat2",
                   "finetune": {"model": dict(SMALL), "target_type": "regr",
                                "batch_size": 2, "n_epochs": 1, "lr": 1e-3,
                                "tcsr": True, **finetune}})


# --------------------------------------------------------------------------
# cross-validation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,folds,seed", [(8, 2, 42), (23, 5, 0),
                                          (96, 3, 42)])
def test_cv_folds_match_jax(n, folds, seed):
    assert cv_random_split(n, n_folds=folds, seed=seed) == \
        jax_cv_split(n, n_folds=folds, seed=seed)


def test_cv_folds_get_the_jax_graphs(tmp_path, monkeypatch, graphs):
    """run_finetune_cv with load_datasets and run_finetune stubbed in both
    packages: each fold's train / val / test graphs (by SMILES) and
    exp_dir equal the JAX package's; cv_scores.pkl holds the same scores,
    mean and std."""
    import fragnet_tpu.train.finetune as jft
    from fragnet_tpu.train.cv import run_finetune_cv as jax_cv

    import fragnet_tpu_torch.train.finetune as pft
    from fragnet_tpu_torch.train.cv import run_finetune_cv

    seen = {"jax": [], "port": []}
    for mod, gs, tag in ((jft, graphs[0], "jax"), (pft, graphs[1], "port")):
        def load(opt, _gs=gs):
            return _gs[:5], _gs[5:7], _gs[7:], 1, "regr"

        def fake(opt, quiet=False, datasets=None, _tag=tag, **kw):
            names = [[g.smiles for g in part] for part in datasets[:3]]
            seen[_tag].append((os.path.basename(opt.exp_dir), names,
                               datasets[3:], kw.get("device")))
            return float(sum(len(s) for s in names[0])), None

        monkeypatch.setattr(mod, "load_datasets", load)
        monkeypatch.setattr(mod, "run_finetune", fake)
    cfg = {"seed": 5, "finetune": {}}
    jax_cv(JaxConfig(dict(cfg, exp_dir=str(tmp_path / "jax"))), n_folds=3,
           quiet=True)
    run_finetune_cv(Config(dict(cfg, exp_dir=str(tmp_path / "port"))),
                    n_folds=3, quiet=True)
    assert len(seen["port"]) == 3
    assert [s[:3] for s in seen["port"]] == [s[:3] for s in seen["jax"]]
    assert all(s[3] is None for s in seen["port"])  # the card by default
    load = [pickle.load(open(tmp_path / t / "cv_scores.pkl", "rb"))
            for t in ("port", "jax")]
    assert load[0] == load[1]


def test_run_finetune_cv_on_the_cpu(tmp_path, monkeypatch, graphs):
    """Two folds of one epoch through the port's run_finetune on the CPU:
    finite scores, each fold's checkpoint, cv_scores.pkl."""
    import fragnet_tpu_torch.train.finetune as pft
    from fragnet_tpu_torch.train.cv import run_finetune_cv

    pg = graphs[1]
    monkeypatch.setattr(pft, "load_datasets",
                        lambda opt: (pg[:6], pg[6:], pg[4:], 1, "regr"))
    mean, std, scores = run_finetune_cv(_cfg(tmp_path), n_folds=2,
                                        quiet=True, device="cpu")
    assert len(scores) == 2 and np.isfinite(scores).all()
    assert mean == pytest.approx(np.mean(scores))
    for k in range(2):
        assert os.path.exists(tmp_path / f"fold_{k}" / "ft.ckpt")
    with open(tmp_path / "cv_scores.pkl", "rb") as f:
        assert pickle.load(f)["scores"] == scores


# --------------------------------------------------------------------------
# size-bucketed loading
# --------------------------------------------------------------------------

def _bucketed(mod, gs, **kw):
    return mod.BucketedBatchLoader(gs, 2, n_buckets=3, n_tasks=1,
                                   spec_kwargs={"tcsr": True}, **kw)


def test_bucket_specs_match_jax(graphs):
    """Each bucket's PadSpec, field by field, and its molecules."""
    jl, pl = (_bucketed(jax_batcher, graphs[0]),
              _bucketed(batcher, graphs[1]))
    assert len(pl.specs) == len(jl.specs) == 3
    for a, b in zip(jl.specs, pl.specs):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert [[g.smiles for g in l.graphs] for l in pl.loaders] == \
        [[g.smiles for g in l.graphs] for l in jl.loaders]
    assert len(pl) == len(jl)


@pytest.mark.parametrize("cached", [False, True])
def test_bucket_stream_matches_jax(graphs, cached):
    """run_finetune's use of a shuffled train loader — (cached,) one init
    draw, then two epochs: the graph ids of every batch, in order, equal
    the JAX package's; each epoch holds every graph once."""
    def ids(b):
        y, m = np.asarray(b.y), np.asarray(b.graph_mask)
        return [int(v) for v in y[m > 0, 0]]

    streams = []
    for mod, gs in ((jax_batcher, graphs[0]), (batcher, graphs[1])):
        loader = _bucketed(mod, gs, shuffle=True, seed=3)
        if cached:
            loader = (mod.DeviceCacheLoader(loader, seed=3)
                      if mod is jax_batcher else
                      mod.DeviceCacheLoader(loader, seed=3, device="cpu"))
        next(iter(loader))
        streams.append([[ids(b) for b in loader] for _ in range(2)])
    assert streams[1] == streams[0]
    for epoch in streams[1]:
        assert sorted(i for b in epoch for i in b) == list(range(8))
    if not cached:  # the buckets' order reshuffles with each epoch
        assert streams[1][0] != streams[1][1]


@pytest.mark.parametrize("attr", [False, True])
def test_run_finetune_buckets_on_the_cpu(tmp_path, monkeypatch, graphs, cs,
                                         attr):
    """run_finetune with finetune.n_buckets=3 for two epochs on the CPU
    (aligned batches, the kernels' plain versions): finite, and each kernel
    wrapper called as often as chip_smoke.py's bucket_expect counts the
    launches on the card (phase 29)."""
    pg = graphs[1]
    kernel = {"kernel": {"attr": True, "fc": "attr"}} if attr else {}
    opt = _cfg(tmp_path, n_buckets=3, n_epochs=2, **kernel)
    data = (pg, pg[:4], pg[4:], 1, "regr")
    expect, n_train, _n_val, _n_test = cs.bucket_expect(opt, data)
    calls = _counting(monkeypatch)
    value, _model = run_finetune(opt, quiet=True, datasets=data,
                                 device="cpu")
    assert np.isfinite(value) and n_train >= 3
    assert calls == {n: expect[n] for n in WRAPPERS}
    assert calls["dense_attr_fwd" if attr else "tcsr_gat_fwd"] > 0


# --------------------------------------------------------------------------
# auxiliary pretraining
# --------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _aux_cfg(tmp_path, mode, csv_path, **pt):
    return {"seed": 3, "exp_dir": str(tmp_path / mode),
            "pretrain": {"mode": mode, "prop_csv": csv_path,
                         "loss": "cel" if mode == "structure" else "mse",
                         "model": {k: SMALL[k] for k in
                                   ("num_layer", "num_heads", "emb_dim",
                                    "drop_ratio")},
                         "batch_size": 4, "n_epochs": 1, "tcsr": True, **pt}}


@pytest.fixture(scope="module")
def prop_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aux") / "props.csv")
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        f.write("smiles,logp,tpsa\n")
        for s in AUX_SMILES:
            a, b = rng.standard_normal(2)
            f.write(f"{s},{float(a)!r},{float(b)!r}\n")
    return path


@pytest.mark.parametrize("mode,extra", [("property", {}),
                                        ("property", {"target_pos": 1}),
                                        ("structure", {})])
def test_aux_targets_match_jax(tmp_path, monkeypatch, prop_csv, mode, extra):
    """The SMILES and targets each package's run_aux_pretrain featurizes
    (captured at its build_graphs call), and the classes: property targets
    from the CSV's columns (or the target_pos one), structure targets the
    ring counts (31 classes)."""
    import fragnet_tpu.data.datasets as jds
    from fragnet_tpu.train.pretrain import run_aux_pretrain as jax_aux

    import fragnet_tpu_torch.data.datasets as pds

    seen = {}
    for mod, tag in ((jds, "jax"), (pds, "port")):
        def capture(smiles, targets, _tag=tag, **kw):
            seen[_tag] = (list(smiles), [list(map(float, t))
                                         for t in targets])
            raise _Stop

        monkeypatch.setattr(mod, "build_graphs", capture)
    aux_targets = port_pretrain.aux_targets

    def count_classes(opt):
        seen["aux_targets"] = aux_targets(opt)
        return seen["aux_targets"]

    monkeypatch.setattr(port_pretrain, "aux_targets", count_classes)
    cfg = _aux_cfg(tmp_path, mode, prop_csv, **extra)
    with pytest.raises(_Stop):
        jax_aux(JaxConfig(cfg), quiet=True)
    with pytest.raises(_Stop):
        port_pretrain.run_aux_pretrain(Config(cfg), quiet=True,
                                       device="cpu")
    assert seen["port"] == seen["jax"]
    smiles, targets = seen["port"]
    assert smiles == AUX_SMILES
    n_classes = seen["aux_targets"][2]
    if mode == "structure":
        assert n_classes == 31
        assert [t[0] for t in targets] == [0, 1, 0, 1, 1, 0, 1, 2, 2]
    else:
        assert n_classes == (1 if extra else 2)
        assert len(targets[0]) == n_classes


def test_cel_loss_matches_jax(graphs):
    """The structure objective on a batch of the eight molecules (labels
    0-30) and two padding graphs: loss and every gradient of the port's
    FragNetFineTune (31 classes, aligned-tcsr route) against the JAX
    model's optax softmax cross-entropy with carried weights, 1e-4; the
    padding graphs' labels change nothing."""
    labels = np.array([3, 0, 30, 7, 1, 12, 2, 5], np.float32)
    jg = [dataclasses.replace(g, y=labels[i:i + 1])
          for i, g in enumerate(graphs[0])]
    pg = [dataclasses.replace(g, y=labels[i:i + 1])
          for i, g in enumerate(graphs[1])]
    kw = dict(batch_size=10, tcsr=True, align=True)
    bj = jax_pad_batch(jg, jax_spec_for(jg, **kw))
    bj = jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                      dataclasses.replace(bj, tm_atom=None, tm_bond=None,
                                          tm_frag=None, tm_fc=None,
                                          dp_bond=None, dp_fc=None,
                                          dp_atom=None, dp_frag=None))
    model = JaxModel(n_classes=31, **{k: SMALL[k] for k in (
        "num_layer", "num_heads", "emb_dim", "drop_ratio")})
    params = jax.jit(lambda k: model.init(k, bj, deterministic=True))(
        jax.random.PRNGKey(1))

    def loss(p):  # the JAX package's cel objective (pretrain.py:258-265)
        out = model.apply(p, bj, deterministic=True)
        ls = optax.softmax_cross_entropy_with_integer_labels(
            out, bj.y[:, 0].astype(jnp.int32))
        m_ = bj.graph_mask
        return jnp.sum(ls * m_) / jnp.maximum(jnp.sum(m_), 1.0)

    l_j, g_j = jax.jit(jax.value_and_grad(loss))(params)
    cfg = Config({"pretrain": {"model": {k: SMALL[k] for k in (
        "num_layer", "num_heads", "emb_dim", "drop_ratio")}}})
    port = port_pretrain.build_aux_model(cfg, 31)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.eval()
    bp = to_device(pad_batch(pg, spec_for(pg, **kw)), "cpu")

    def run(b):
        port.zero_grad(set_to_none=True)
        value = port_pretrain.cel_loss(port(b), b.y, b.graph_mask)
        value.backward()
        return value.detach(), {n: (torch.zeros_like(p) if p.grad is None
                                    else p.grad.clone())
                                for n, p in port.named_parameters()}

    l_p, g_p = run(bp)
    np.testing.assert_allclose(float(l_p), float(l_j), rtol=1e-4)
    want = state_dict_from_jax(jax.device_get(g_j))
    scale = max(float(w.abs().max()) for w in want.values())
    for name, got in g_p.items():
        ref = want[name].numpy()
        if np.abs(ref).max() <= 1e-6 * scale:
            assert float(got.abs().max()) <= 1e-6 * scale, name
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
    pad = bp.graph_mask == 0
    assert int(pad.sum()) == 2 and float(bp.y[pad].abs().sum()) == 0
    y = bp.y.clone()
    y[pad] = 17.0
    l_q, g_q = run(dataclasses.replace(bp, y=y))
    assert torch.equal(l_q, l_p)
    assert all(torch.equal(g_q[n], g_p[n]) for n in g_p)


def test_run_aux_pretrain_trains_and_transfers(tmp_path, monkeypatch,
                                               prop_csv, cs):
    """run_pretrain with pretrain.mode=property (mse) and =structure (cel)
    for one epoch on the CPU: finite losses, the wrappers called as
    chip_smoke.py's aux_expect counts them; then run_finetune with
    pretrain.use on the structure checkpoint starts from its encoder."""
    import fragnet_tpu_torch.data.datasets as pds
    from fragnet_tpu_torch.obs import read_scalars

    build_graphs, made = pds.build_graphs, []

    def kept(*a, **kw):  # the graphs the run featurizes
        made.append(build_graphs(*a, **kw))
        return made[-1]

    ckpts = {}
    for mode in ("property", "structure"):
        opt = Config(_aux_cfg(tmp_path, mode, prop_csv, target_pos=0))
        calls = _counting(monkeypatch)
        monkeypatch.setattr(pds, "build_graphs", kept)
        best, ckpts[mode] = port_pretrain.run_pretrain(opt, quiet=True,
                                                       device="cpu")
        monkeypatch.undo()
        pg = made[-1]
        assert [g.smiles for g in pg] == AUX_SMILES
        expect = cs.aux_expect(opt, pg)[0]
        assert calls == {n: expect[n] for n in WRAPPERS}
        assert calls["tcsr_gat_bwd"] > 0
        vals = [r["value"] for r in read_scalars(opt.exp_dir)]
        assert len(vals) == 2 and np.isfinite(vals).all()
        assert np.isfinite(best)
    sd = torch.load(ckpts["structure"], map_location="cpu",
                    weights_only=True)
    assert any(v.shape[:1] == (31,) for k, v in sd.items()
               if k.startswith("fthead"))
    ft = Config({"seed": 3, "exp_dir": str(tmp_path / "ft"),
                 "pretrain": {"use": True, "chk": ckpts["structure"]},
                 "finetune": {"model": dict(SMALL), "n_epochs": 0,
                              "batch_size": 4, "tcsr": True}})
    _value, model = run_finetune(ft, quiet=True, device="cpu",
                                 datasets=(pg[:6], pg[6:], pg[6:], 1, "regr"))
    own = model.state_dict()
    enc = [k for k in sd if k.startswith("pretrain.")]
    assert enc and all(torch.equal(own[k], sd[k]) for k in enc)
