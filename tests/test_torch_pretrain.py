"""The port's geometric pretraining against fragnet_tpu's, on the CPU:
FragNetPreTrain's four outputs with carried weights (segment path and
aligned kernels' plain versions), ``pretrain_loss`` in both modes, every
parameter gradient against ``jax.grad``, the packed step against the
unpacked step, AdamW and Adagrad against optax, the encoder transfer and
the checkpoint bridge, ``run_pretrain`` (uncached, device-cached and the
three packed tiers) and a ``pretrain.use`` finetune started from its
checkpoint, and the PT config that ``chip_smoke.py`` carries. Small model:
1–2 layers, emb 16–32. Tolerances: 1e-4 relative through the model (f32
in two frameworks), 1e-5 for the loss alone, 1e-6 for optimizer steps and
for the packed step against the unpacked one (same arithmetic)."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fragnet_tpu.config import load_config
from fragnet_tpu.data.datasets import PretrainData as JaxPretrainData
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.pretrain import FragNetPreTrain as JaxPreTrain
from fragnet_tpu.train import optim as jax_optim
from fragnet_tpu.train.checkpoint import import_torch_state_dict
from fragnet_tpu.train.pretrain import pretrain_loss as jax_pretrain_loss

from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.data.datasets import PretrainData
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.model.pretrain import (FragNetPreTrain,
                                              FragNetPreTrainMasked,
                                              FragNetPreTrainMasked2,
                                              mask_atom_features)
from fragnet_tpu_torch.obs import read_scalars
from fragnet_tpu_torch.train import pretrain as port_pretrain
from fragnet_tpu_torch.train.checkpoint import (state_dict_from_jax,
                                                transfer_pretrained_encoder)
from fragnet_tpu_torch.train.finetune import run_finetune
from fragnet_tpu_torch.train.optim import make_optimizer
from fragnet_tpu_torch.train.pretrain import (make_pretrain_step,
                                              pretrain_loss, run_pretrain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "CC(=O)Oc1ccccc1C(=O)O",
             "OCC(O)C(O)CO"]
SMALL = dict(num_layer=2, num_heads=4, emb_dim=32, drop_ratio=0.0)
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None, dp_atom=None, dp_frag=None)


def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


def _close(port, ref, rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(scope="module")
def graphs():
    """(JAX, port) pretrain graphs of the same SMILES."""
    return (JaxPretrainData().get_pt_dataset(PT_SMILES, seed=0),
            PretrainData().get_pt_dataset(PT_SMILES, seed=0))


@pytest.fixture(scope="module")
def batches(graphs):
    """{path: (jax batch, port batch)} of all six molecules with targets:
    'segment' (no kernel metadata) and 'aligned' (tile-aligned TCSR + dense
    planes)."""
    jg, pg = graphs
    out = {}
    for path, kw in (("segment", {}), ("aligned", dict(tcsr=True,
                                                        align=True))):
        kw = dict(batch_size=len(jg), **kw)
        bj = jax_pad_batch(jg, jax_spec_for(jg, **kw), with_targets=True)
        bp = pad_batch(pg, spec_for(pg, **kw), with_targets=True)
        out[path] = (_jnp(bj), bp)
    assert out["aligned"][1].dp_bond is not None
    return out


@pytest.fixture(scope="module")
def carried(batches):
    """A JAX FragNetPreTrain's params and the port model holding them."""
    model = JaxPreTrain(**{k: v for k, v in SMALL.items()})
    seg = dataclasses.replace(batches["aligned"][0], **_NO_KERNELS)
    params = model.init(jax.random.PRNGKey(0), seg, deterministic=True)
    port = FragNetPreTrain(**SMALL)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, params, port.eval()


# --------------------------------------------------------------------------
# model, loss and gradients against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["segment", "aligned"])
def test_forward_matches_jax(batches, carried, path):
    model, params, port = carried
    bj, bp = batches[path]
    want = model.apply(params, bj, deterministic=True)
    with torch.no_grad():
        got = port(to_device(bp, "cpu"))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("compat", [False, True], ids=["intended", "compat"])
def test_pretrain_loss_matches_jax(batches, compat):
    bj, bp = batches["segment"]
    rng = np.random.default_rng(0)
    E, A, G = bp.edge_src.shape[0], bp.x_atoms.shape[0], bp.y.shape[0]
    preds = [rng.standard_normal(s).astype(np.float32)
             for s in ((E, 1), (A, 1), (E, 1), (G, 1))]
    want = jax_pretrain_loss([jnp.asarray(p) for p in preds], bj, compat)
    got = pretrain_loss([torch.from_numpy(p) for p in preds],
                        to_device(bp, "cpu"), compat)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_parameter_gradients_match_jax(batches, carried):
    model, params, port = carried
    bj, bp = batches["segment"]
    want = state_dict_from_jax(jax.grad(lambda p: jax_pretrain_loss(
        model.apply(p, bj, deterministic=True), bj))(params))
    port.zero_grad(set_to_none=True)
    pretrain_loss(port(to_device(bp, "cpu")), to_device(bp, "cpu")).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        if g is None:  # off the loss's path (layer 0's frag pass): JAX's 0
            assert not want[n].any(), n
            continue
        _close(g, want[n].numpy())


def test_packed_step_matches_unpacked_step(graphs):
    """make_pretrain_step on the packed buffer (decoded, planes rebuilt by
    the plane builder's plain version) equals the step on the host batch,
    over two Adam steps."""
    _jg, pg = graphs
    spec = spec_for(pg, batch_size=4, multiple=16, tcsr=True, tn=16, te=16,
                    align=True)
    b = next(iter(BatchLoader(pg, 4, spec=spec, with_targets=True)))
    packed = BatchLoader(pg, 4, spec=spec, with_targets=True, pack=True)
    buf = next(iter(packed))
    steps = []
    for layout in (None, packed.layout):
        m = FragNetPreTrain(num_layer=1, num_heads=2, emb_dim=16,
                            drop_ratio=0.0,
                            generator=torch.Generator().manual_seed(0))
        opt, _ = make_optimizer(m.parameters(), "adam", lr=1e-3)
        steps.append(make_pretrain_step(m, opt, layout=layout, device="cpu"))
    for _ in range(2):
        l1, l2 = float(steps[0](b)), float(steps[1](buf))
        np.testing.assert_allclose(l2, l1, rtol=1e-6)


# --------------------------------------------------------------------------
# optimizers, masks, checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,lr", [("adamw", 0.01), ("adagrad", 0.01),
                                     ("adagrad", 1e-4)])
def test_optimizer_steps_match_optax(name, lr):
    """The same gradient sequence through the JAX package's optimizer and
    the port's: parameters agree after every step."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.7).astype(np.float32)
              for k, s in shapes.items()} for _ in range(8)]
    tx = jax_optim.make_optimizer(name, lr=lr, weight_decay=0.0)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt, _ = make_optimizer(tp.values(), name, lr=lr, weight_decay=0.0)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        opt.zero_grad(set_to_none=True)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


def test_masks_follow_the_generator_in_train_mode_only(batches):
    bp = to_device(batches["segment"][1], "cpu")
    for cls in (FragNetPreTrainMasked, FragNetPreTrainMasked2):
        m = cls(num_layer=1, num_heads=2, emb_dim=16, drop_ratio=0.0,
                mask_seed=3, generator=torch.Generator().manual_seed(0))
        ref = FragNetPreTrain(num_layer=1, num_heads=2, emb_dim=16,
                              drop_ratio=0.0)
        ref.load_state_dict(m.state_dict())
        with torch.no_grad():
            m.eval()
            assert all(torch.equal(a, b) for a, b in zip(m(bp), ref(bp)))
            m.train()
            first = m(bp)
            assert not torch.equal(first[1], ref(bp)[1])
        again = cls(num_layer=1, num_heads=2, emb_dim=16, drop_ratio=0.0,
                    mask_seed=3, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            again.train()
            assert all(torch.equal(a, b) for a, b in zip(first, again(bp)))
    x = torch.ones((1000, 4))
    out = mask_atom_features(torch.Generator().manual_seed(0), x, 0.3)
    masked = (out == -1.0).all(1)
    assert torch.equal(out[~masked], x[~masked])
    assert 0.25 < float(masked.float().mean()) < 0.35


def test_checkpoint_bridge_and_encoder_transfer(tmp_path, batches, carried):
    """A port pretrain checkpoint opens in the JAX package against a
    FragNetPreTrain template (strict), and its encoder copies exactly into
    a finetune model whose head stays as it was."""
    model, params, port = carried
    from fragnet_tpu_torch.train.checkpoint import save_params

    path = tmp_path / "pt.ckpt"
    save_params(port, str(path))
    sd = torch.load(path, weights_only=True)
    back = import_torch_state_dict(sd, template=params, strict=True)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ft = FragNetFineTune(num_layer=2, num_heads=4, emb_dim=32, h1=8, h2=8,
                         h3=8, h4=8, generator=torch.Generator().manual_seed(5))
    head_before = {k: v.clone() for k, v in ft.state_dict().items()
                   if k.startswith("fthead.")}
    transfer_pretrained_encoder(ft, sd)
    for k, v in ft.state_dict().items():
        if k.startswith("pretrain."):
            assert torch.equal(v, sd[k]), k
        else:
            assert torch.equal(v, head_before[k]), k
    with pytest.raises(KeyError, match="encoder"):
        transfer_pretrained_encoder(ft, {k: v for k, v in sd.items()
                                         if "layers.1." not in k})


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------

def _pt_opt(tmp_path, **pretrain):
    return Config({
        "seed": 7, "exp_dir": str(tmp_path), "data_type": "exp1s",
        "pretrain": {
            "model_version": "gat2", "data_dir": None, "n_synthetic": 16,
            "model": {"num_layer": 2, "num_heads": 4, "drop_ratio": 0.0,
                      "emb_dim": 32},
            "batch_size": 4, "lr": 1e-3, "n_epochs": 2, "es_patience": 20,
            "val_every": 1, "optimizer": "adam", "chkpoint_name": "pt.ckpt",
            **pretrain},
    })


@pytest.fixture(scope="module")
def synth_graphs(tmp_path_factory):
    opt = _pt_opt(tmp_path_factory.mktemp("pt"))
    return port_pretrain.load_pretrain_graphs(opt)


def _losses(exp_dir, tag):
    return [r["value"] for r in read_scalars(str(exp_dir)) if r["tag"] == tag]


def test_run_pretrain_then_finetune_from_it(tmp_path, synth_graphs):
    """run_pretrain on the CPU (device-cached loaders) gives finite losses
    and a checkpoint; a pretrain.use finetune starts from its encoder."""
    assert len(synth_graphs) >= 12
    best, ckpt = run_pretrain(_pt_opt(tmp_path / "pt"), quiet=True,
                              device="cpu", graphs=synth_graphs)
    losses = _losses(tmp_path / "pt", "train/loss")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert len(_losses(tmp_path / "pt", "val/loss")) == 2
    assert np.isfinite(best) and os.path.exists(ckpt)
    sd = torch.load(ckpt, weights_only=True)
    assert any(k.startswith("head.bl_reduce_layer.") for k in sd)

    ft_opt = Config({
        "seed": 7, "exp_dir": str(tmp_path / "ft"), "model_version": "gat2",
        "pretrain": {"use": True, "chk": ckpt},
        "finetune": {"model": {"num_layer": 2, "num_heads": 4, "emb_dim": 32,
                               "h1": 8, "h2": 8, "h3": 8, "h4": 8},
                     "target_type": "regr", "batch_size": 4, "n_epochs": 0},
    })
    train = synth_graphs[:8]
    _rmse, model = run_finetune(ft_opt, quiet=True, device="cpu",
                                datasets=(train, synth_graphs[8:10],
                                          synth_graphs[10:12], 1, "regr"))
    for k, v in model.state_dict().items():
        if k.startswith("pretrain."):
            assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("tier", ["HBM", "host", "process stream"])
def test_run_pretrain_packed_tiers(tmp_path, synth_graphs, monkeypatch,
                                   capsys, tier):
    """The packed tiers, driven on the CPU (the gate that sends uncached
    CUDA runs to them opened for the test): each reports its tier and
    trains to finite losses; the process stream's epochs have exactly
    their windows' batches."""
    monkeypatch.setattr(port_pretrain, "_packed_transport", lambda dev: True)
    gb = {"HBM": {}, "host": {"hbm_cache_gb": 0},
          "process stream": {"hbm_cache_gb": 0, "host_cache_gb": 0}}[tier]
    opt = _pt_opt(tmp_path, cache="off", tcsr=True, stream_workers=2, **gb)
    seen = []
    real = port_pretrain.PretrainTrainer.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        step = self._step
        self._step = lambda b: (seen.append(b), step(b))[1]

    monkeypatch.setattr(port_pretrain.PretrainTrainer, "__init__", spy)
    _best, ckpt = run_pretrain(opt, device="cpu", graphs=synth_graphs)
    out = capsys.readouterr().out
    assert f"packed {tier}" in out
    losses = _losses(tmp_path, "train/loss")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(ckpt)
    assert seen and all(getattr(b, "dtype", None) in (np.uint8, torch.uint8)
                        for b in seen)
    train_g, _ = port_pretrain.split_graphs(synth_graphs, 7)
    sim = BatchLoader(train_g, 4, spec=spec_for(synth_graphs, 4, tcsr=True),
                      shuffle=True, seed=7)
    per_epoch = [len(list(sim._windows())) for _ in range(2)]
    want = sum(per_epoch) if tier == "process stream" else 2 * per_epoch[0]
    assert len(seen) == want


def test_jax_pickle_shards_load_as_port_graphs(tmp_path, graphs):
    """Shards the JAX package writes (pickles of its MolGraph) load as the
    port's MolGraph with equal arrays, without the JAX package's class."""
    from fragnet_tpu.data.datasets import save_ds_parts as jax_save_parts

    from fragnet_tpu_torch.data.datasets import load_data_parts
    from fragnet_tpu_torch.graphs.build import MolGraph

    jg, _pg = graphs
    jax_save_parts(jg, str(tmp_path), shard_size=4)
    got = load_data_parts(str(tmp_path), dedup=False)
    assert len(got) == len(jg) and all(type(g) is MolGraph for g in got)
    for a, b in zip(jg, got):
        for f in ("x_atoms", "edge_index", "ei_bonds", "ea_fbonds",
                  "bnd_lngth", "dh_angl", "y"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(load_data_parts(str(tmp_path))) == len(set(PT_SMILES))


def test_run_pretrain_refuses_what_it_does_not_run(tmp_path):
    with pytest.raises(ValueError, match="model_version"):
        port_pretrain.build_pretrain_model(_pt_opt(tmp_path,
                                                   model_version="lite"))


def test_chip_smoke_pt_config_is_the_yaml():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.PT_CONFIG == load_config(
        os.path.join(REPO, "configs/pt/unimol.yaml")).to_dict()
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    popt = cs.pt_opt(cs.PT_OVERRIDES, cs.ATTR_PT_OVERRIDES)
    assert resolve_kernel_policy(popt.pretrain) == KernelPolicy(attr=True,
                                                                fc="attr")
    assert resolve_kernel_policy(cs.pt_opt(cs.PT_OVERRIDES).pretrain) == \
        KernelPolicy()
