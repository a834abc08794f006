"""The port's edge-partitioned mode on the CPU against fragnet_tpu's: the
EP tile metadata, K3's plain forward and backward against the Pallas
``local_stats`` / ``local_unnorm`` of ``_make_ep_op`` (interpret mode), the
EP pass over two gloo ranks against the single-device pass and JAX's
``pallas_gat_pass_ep`` under shard_map, the whole EP model (two ranks,
carried weights) against the JAX single-device model, and
``run_finetune`` under ``dist.mode=ep``.

Ranks are spawned processes (dist/launch.py) that import torch and the
port only; their functions live in fragnet_tpu_torch/dist/checks.py. The
group meets through a file under tmp_path and every collective and the
whole run time out, so a rank that fails cannot hang the suite. Inputs are
made with numpy from a seed. Tolerances: 1e-5 for one pass (f32, the two
frameworks sum in different orders), 1e-4 relative for the model (two
layers deep).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fragnet_tpu.dist.edge_partition import EPMetaLoader as JaxEPMetaLoader
from fragnet_tpu.dist.edge_partition import pin_ep_widths as jax_pin
from fragnet_tpu.dist.edge_partition import (
    with_ep_tile_meta as jax_with_ep_tile_meta)
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.ops.pallas_gat import _make_ep_op, pallas_gat_pass_ep
from fragnet_tpu.ops.tcsr import EPTileMeta as JaxEPTileMeta
from fragnet_tpu.ops.tcsr import build_ep_tile_meta as jax_build_ep
from fragnet_tpu.train.loop import mse_loss as jax_mse

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.dist import checks
from fragnet_tpu_torch.dist.edge_partition import (EPMetaLoader,
                                                   pin_ep_widths,
                                                   with_ep_tile_meta)
from fragnet_tpu_torch.dist.launch import run_ranks
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.ops import tcsr_gat
from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta, build_tile_meta
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import run_finetune

TOL = dict(atol=1e-5, rtol=1e-5)
S = 2
SMALL = dict(num_layer=2, num_heads=4, emb_dim=32, h1=16, h2=16, h3=16,
             h4=16, drop_ratio=0.0)
_META = ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")


def _ranks(fn, args, tmp_path):
    return run_ranks(fn, S, args, device="cpu", timeout_s=120,
                     join_timeout_s=300, workdir=str(tmp_path))


def _torch_meta(meta):
    return dataclasses.replace(
        meta, **{f: torch.from_numpy(getattr(meta, f)) for f in _META})


def _close(port, ref, **tol):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = PortBuilder("exp1s")
    return [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                          smiles=g.smiles) for g in ft_graphs]


def _case(seed=0, N=64, E=128, H=4, D=8, Da=4, tn=8, te=8):
    """Edges sorted by destination with sources a few nodes away (the
    batcher's locality), some masked; node values, edge attrs, attention
    vector and an output cotangent drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    src = np.clip(dst + rng.integers(-6, 7, E), 0, N - 1).astype(np.int32)
    mask = (rng.random(E) > 0.1).astype(np.float32)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(N=N, tn=tn, te=te, src=src, dst=dst, mask=mask,
                nf=draw(N, H, D), ea=draw(E, Da), a=draw(H, 2 * D + Da),
                g=draw(N, H, D), dU=draw(E, H * D), dV=draw(E, H))


def test_ep_tile_meta_matches_jax(ft_graphs):
    spec = jax_spec_for(ft_graphs, batch_size=8, multiple=8 * S)
    b = jax_pad_batch(ft_graphs, spec)
    levels = {"atom": (b.edge_src, b.edge_dst, b.edge_mask, spec.n_atoms),
              "bond": (b.bg_src, b.bg_dst, b.bg_mask, spec.n_edges),
              "frag": (b.frag_src, b.frag_dst, b.fconn_mask, spec.n_frags),
              "fc": (b.fc_src, b.fc_dst, b.fc_mask, spec.n_fconn)}
    for lvl, (s, d, m, n) in levels.items():
        mj = jax_build_ep(s, d, m, n, S, tn=8, te=8)
        mp = build_ep_tile_meta(s, d, m, n, S, tn=8, te=8)
        assert mj is not None and mp is not None, lvl
        for f in _META:
            np.testing.assert_array_equal(getattr(mp, f), getattr(mj, f),
                                          err_msg=f"{lvl} {f}")
        for f in ("tn", "te", "n_chunks", "k_src", "n_tiles_grid"):
            assert getattr(mp, f) == getattr(mj, f), (lvl, f)
        # the failing cases: edges that do not split into S shards, and a
        # grid narrower than a shard's span
        odd = (s[:-1], d[:-1], m[:-1], n, S)
        assert build_ep_tile_meta(*odd, tn=8, te=8) is None
        assert jax_build_ep(*odd, tn=8, te=8) is None
        assert build_ep_tile_meta(s, d, m, n, S, tn=8, te=8,
                                  n_tiles_grid=1) is None
        assert jax_build_ep(s, d, m, n, S, tn=8, te=8, n_tiles_grid=1) is None


def test_ep_meta_loader_pins_and_raises_as_jax(ft_graphs, port_graphs):
    """pin_ep_widths gives the JAX package's pins over the same batches,
    EPMetaLoader attaches the JAX metas under them, and both loaders raise
    on a batch that exceeds the pins."""
    spec = jax_spec_for(ft_graphs, batch_size=8, multiple=8 * S)
    pspec = spec_for(port_graphs, batch_size=8, multiple=8 * S)
    jl = [jax_pad_batch(ft_graphs[:4], spec), jax_pad_batch(ft_graphs[4:],
                                                            spec)]
    pl = [pad_batch(port_graphs[:4], pspec), pad_batch(port_graphs[4:],
                                                       pspec)]
    pins = pin_ep_widths([pl], S, tn=8, te=8)
    assert pins == jax_pin([jl], S, tn=8, te=8)
    for bp, bj in zip(EPMetaLoader(pl, S, tn=8, te=8, pins=pins),
                      JaxEPMetaLoader(jl, S, tn=8, te=8, pins=pins)):
        for lvl in ("tm_atom", "tm_bond", "tm_frag", "tm_fc"):
            for f in _META:
                np.testing.assert_array_equal(getattr(getattr(bp, lvl), f),
                                              getattr(getattr(bj, lvl), f))
    tight = {lvl: (1, 1, 1) for lvl in pins}
    with pytest.raises(RuntimeError, match="pinned EP tile windows"):
        list(EPMetaLoader(pl, S, tn=8, te=8, pins=tight))
    with pytest.raises(RuntimeError, match="pinned EP tile windows"):
        list(JaxEPMetaLoader(jl, S, tn=8, te=8, pins=tight))


def test_k3_plain_matches_pallas_local_ops():
    """Per shard: K3's plain forward against ``local_stats``; U, V and the
    gradients of Σ U·dU + V·dV w.r.t. nf, ea and the attention vector
    (TcsrGatEpFn, K3's plain backward) against jax.vjp of
    ``local_unnorm``, at the global max of both shards' stats."""
    c = _case()
    N, tn, te = c["N"], c["tn"], c["te"]
    H, D = c["nf"].shape[1:]
    Da = c["ea"].shape[1]
    mj = jax_build_ep(c["src"], c["dst"], c["mask"], N, S, tn=tn, te=te)
    meta = _torch_meta(build_ep_tile_meta(c["src"], c["dst"], c["mask"], N,
                                          S, tn=tn, te=te))
    Tg, Es = mj.n_tiles_grid, len(c["src"]) // S
    Ng = Tg * tn
    local_stats, local_unnorm, _ = _make_ep_op(
        N, Es, H, D, Da, tn, te, mj.k_src, mj.n_chunks, Tg, 0.2, "float32",
        True)
    j = {k: jnp.asarray(c[k]) for k in ("nf", "ea", "a")}
    shard = lambda x, r: x[r * Es:(r + 1) * Es]
    args = []
    for r in range(S):
        sl = tuple(jnp.asarray(shard(c[k], r))
                   for k in ("src", "dst", "mask"))
        mrow = tuple(jnp.asarray(getattr(mj, f)[r]) for f in _META)
        args.append((sl, mrow))
    stats = [local_stats(j["nf"], shard(j["ea"], r), *sl, j["a"], t0, ew, sw,
                         cw)
             for r, (sl, (t0, ew, sw, _flat, cw)) in enumerate(args)]
    M = np.full((N, H), -1e30, np.float32)
    for r in range(S):
        r0 = int(mj.t0[r, 0]) * tn
        M[r0:r0 + Ng] = np.maximum(M[r0:r0 + Ng], np.asarray(stats[r][1]))
    Mg = np.where(M <= -5e29, 0.0, M).astype(np.float32)

    t = torch.from_numpy
    for r, (sl, (t0, ew, sw, flat, cw)) in enumerate(args):
        src, dst, mask = (t(shard(c[k], r)) for k in ("src", "dst", "mask"))
        xs = [t(c["nf"]).requires_grad_(), t(shard(c["ea"], r)).requires_grad_(),
              t(c["a"]).requires_grad_()]
        wn, w_ea = tcsr_gat.prologue(*xs)
        nf = xs[0].reshape(N, H * D)
        with torch.no_grad():
            got = tcsr_gat.tcsr_gat_ep_fwd(wn, nf, w_ea, src, dst, mask, meta,
                                           r)
        for gp, gj in zip(got, stats[r]):
            _close(gp, gj)
        r0 = int(mj.t0[r, 0]) * tn
        U, V = tcsr_gat.TcsrGatEpFn.apply(wn, nf, w_ea, src, dst, mask, meta,
                                          r, t(Mg[r0:r0 + Ng]), got, 0.2)
        dU, dV = c["dU"][:Ng], c["dV"][:Ng]
        grads = torch.autograd.grad((U * t(dU)).sum() + (V * t(dV)).sum(), xs)

        def f(nf_, ea_, a_):
            return local_unnorm(nf_, ea_, *sl, a_, jnp.asarray(Mg), stats[r],
                                t0, ew, sw, flat, cw)

        (Uj, Vj), vjp = jax.vjp(f, j["nf"], shard(j["ea"], r), j["a"])
        _close(U, Uj)
        _close(V, Vj)
        for gp, gj in zip(grads, vjp((jnp.asarray(dU), jnp.asarray(dV)))):
            _close(gp, gj)


def _jax_ep_pass(c, mj, self_loops):
    """JAX pallas_gat_pass_ep under shard_map over 2 of the virtual CPU
    devices: (out, attn) and the gradients of Σ out·g w.r.t. nf, ea, a."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("ep",))
    meta = jax.tree.map(jnp.asarray, mj)
    mspec = JaxEPTileMeta(t0=P("ep"), ew_blk=P("ep"), sw_tile=P("ep"),
                          flat_slot=P("ep"), cw=P("ep"), tn=mj.tn, te=mj.te,
                          n_chunks=mj.n_chunks, k_src=mj.k_src,
                          n_tiles_grid=mj.n_tiles_grid)
    fn = jax.shard_map(
        lambda nf, ea, s, d, m, a, mt: pallas_gat_pass_ep(
            nf, ea, s, d, m, a, mt, axis="ep", self_loops=self_loops,
            interpret=True),
        mesh=mesh, in_specs=(P(), P("ep"), P("ep"), P("ep"), P("ep"), P(),
                             mspec),
        out_specs=P(), check_vma=False)
    idx = tuple(jnp.asarray(c[k]) for k in ("src", "dst", "mask"))

    def loss(nf, ea, a):
        out, attn = fn(nf, ea, *idx, a, meta)
        return jnp.sum(out * jnp.asarray(c["g"])), (out, attn)

    grads, (out, attn) = jax.jit(jax.grad(loss, argnums=(0, 1, 2),
                                          has_aux=True))(
        jnp.asarray(c["nf"]), jnp.asarray(c["ea"]), jnp.asarray(c["a"]))
    return out, attn, grads


def _pass_args(self_loops):
    """ep_pass_rank's arguments for the seeded case of the pass test."""
    c = _case(seed=1)
    meta = build_ep_tile_meta(c["src"], c["dst"], c["mask"], c["N"], S,
                              tn=c["tn"], te=c["te"])
    t = torch.from_numpy
    return (t(c["nf"]), t(c["ea"]), t(c["src"]), t(c["dst"]), t(c["mask"]),
            t(c["a"]), meta, t(c["g"]), self_loops)


@pytest.fixture(scope="module")
def ep_batches(ft_graphs, port_graphs):
    """(JAX batch, port batch with 2-shard EPTileMeta) of all eight
    molecules, padded for S = 2 at tn = te = 8."""
    bj = jax_pad_batch(ft_graphs, jax_spec_for(ft_graphs, batch_size=8,
                                               multiple=8 * S))
    bp = pad_batch(port_graphs, spec_for(port_graphs, batch_size=8,
                                         multiple=8 * S))
    bp, ok = with_ep_tile_meta(bp, S, tn=8, te=8)
    assert ok
    _, ok_j = jax_with_ep_tile_meta(bj, S, tn=8, te=8)
    assert ok_j
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        bj), bp


@pytest.fixture(scope="module")
def jax_model(ep_batches):
    """(the JAX single-device model at SMALL, its seeded parameters)."""
    model = JaxModel(**SMALL)
    params = jax.jit(lambda b: model.init(jax.random.PRNGKey(0), b,
                                          deterministic=True))(ep_batches[0])
    return model, params


MODEL_LR = 0.05


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory, ep_batches, jax_model):
    """The rank side of the pass tests (both self_loops) and the model
    test, run in one start of two ranks: {"pass": {self_loops: [per rank]},
    "model": [per rank]}."""
    calls = [(checks.ep_pass_rank, _pass_args(sl)) for sl in (False, True)]
    calls.append((checks.ep_model_rank, (SMALL, state_dict_from_jax(
        jax_model[1]), ep_batches[1], MODEL_LR)))
    res = _ranks(checks.calls_rank, (calls,), tmp_path_factory.mktemp("ep"))
    return {"pass": {sl: [r[i] for r in res]
                     for i, sl in enumerate((False, True))},
            "model": [r[2] for r in res]}


@pytest.mark.parametrize("self_loops", [False, True])
def test_ep_pass_over_two_ranks_matches(rank_results, self_loops):
    c = _case(seed=1)
    N, tn, te = c["N"], c["tn"], c["te"]
    mj = jax_build_ep(c["src"], c["dst"], c["mask"], N, S, tn=tn, te=te)
    res = rank_results["pass"][self_loops]
    t = torch.from_numpy
    # the port's single-device pass
    xs = [t(c[k]).requires_grad_() for k in ("nf", "ea", "a")]
    tm = build_tile_meta(c["src"], c["dst"], c["mask"], N, tn=tn, te=te)
    out, attn = tcsr_gat.tcsr_gat_pass(xs[0], xs[1], t(c["src"]), t(c["dst"]),
                                       t(c["mask"]), xs[2], tm,
                                       self_loops=self_loops,
                                       return_attention=True)
    grads = torch.autograd.grad((out * t(c["g"])).sum(), xs)
    out_j, attn_j, grads_j = _jax_ep_pass(c, mj, self_loops)
    names = ("d_nf", "d_ea", "d_avec")
    for r in res:
        for ref_out, ref_attn, ref_grads in ((out.detach(), attn, grads),
                                             (out_j, attn_j, grads_j)):
            _close(r["out"], ref_out)
            _close(r["attn"], ref_attn)
            for n, gref in zip(names, ref_grads):
                _close(r[n], gref)


def test_ep_model_matches_jax_single_device(rank_results, ep_batches,
                                            jax_model):
    """FragNetFineTune under EP (2 ranks) against the JAX single-device
    model with the same weights: predictions, the four attention vectors,
    the loss and every averaged parameter gradient, and the parameters
    after one SGD step."""
    bj, _bp = ep_batches
    model, params = jax_model
    sd = state_dict_from_jax(params)
    lr = MODEL_LR
    res = rank_results["model"]
    pred_j, attn_j = jax.jit(lambda p: model.apply(
        p, bj, deterministic=True, return_attentions=True))(params)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_mse(model.apply(p, bj, deterministic=True), bj.y,
                          bj.graph_mask)))(params)
    want = state_dict_from_jax(jax.device_get(grads_j))
    scale = max(float(w.abs().max()) for w in want.values())
    rel = dict(rtol=1e-4)
    for r in res:
        _close(r["pred"], pred_j, atol=1e-4 * float(np.abs(pred_j).max()),
               **rel)
        assert abs(r["loss"] - float(loss_j)) <= 1e-4 * float(loss_j)
        for lvl in ("atoms", "frags", "bonds", "fbonds"):
            ref = np.asarray(getattr(attn_j, lvl))
            _close(r["attn"][lvl], ref, atol=1e-4 * np.abs(ref).max(), **rel)
        assert set(r["grads"]) == set(want)
        for name, w in want.items():
            got = r["grads"][name]
            got = torch.zeros_like(w) if got is None else got
            _close(got, w, atol=1e-4 * max(float(w.abs().max()),
                                           1e-2 * scale), **rel)
            p0 = sd[name]
            _close(r["params"][name], p0 - lr * w,
                   atol=1e-4 * float(p0.abs().max()) + lr * 1e-4 * scale,
                   **rel)


def test_run_finetune_ep_two_ranks(tmp_path, port_graphs):
    opt = Config({
        "seed": 7, "exp_dir": str(tmp_path), "model_version": "gat2",
        "dist": {"mode": "ep", "n_devices": S, "timeout_s": 120,
                 "join_timeout_s": 300},
        "finetune": {"model": dict(SMALL, act="relu", fthead="FTHead3"),
                     "target_type": "regr", "batch_size": 4,
                     "n_epochs": 1}})
    reports = []
    datasets = (port_graphs[:4], port_graphs[4:6], port_graphs[6:], 1,
                "regr")
    rmse, model = run_finetune(opt, datasets=datasets, device="cpu",
                               rank_reports=reports)
    assert np.isfinite(rmse)
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["backend"] == "gloo" for r in reports)
    assert reports[0]["value"] == reports[1]["value"] == rmse
    assert reports[0]["train_loss"] == reports[1]["train_loss"]
    assert isinstance(model, FragNetFineTune)
    with open(tmp_path / "scalars.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("train/loss") == 1  # rank 0 alone writes
    assert os.path.exists(tmp_path / "ft.ckpt")


def test_shard_edges_matches_jax():
    from fragnet_tpu.dist.edge_partition import shard_edges as jax_shard
    from fragnet_tpu_torch.dist.edge_partition import shard_edges

    c = _case(E=61)
    arrs = [c["ea"], c["src"], c["dst"], c["mask"]]
    for got, want in zip(shard_edges(arrs, 4, pad_value=-1),
                         jax_shard(arrs, 4, pad_value=-1)):
        np.testing.assert_array_equal(got, want)
