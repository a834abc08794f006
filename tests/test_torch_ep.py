"""The port's edge-partitioned mode on the CPU against fragnet_tpu's: the
EP tile metadata, K3's plain forward and backward against the Pallas
``local_stats`` / ``local_unnorm`` of ``_make_ep_op`` (interpret mode), the
EP pass over two gloo ranks against the single-device pass and JAX's
``pallas_gat_pass_ep`` under shard_map, the whole EP model (two ranks,
carried weights) against the JAX single-device model, and
``run_finetune`` under ``dist.mode=ep``; the same for the segment mode
(batches without tile metadata: ``edge_partitioned_gat_pass`` and
``edge_partitioned_segment_sum`` against the JAX package's on a 2-device
CPU mesh, the model in f32 and bf16, ``run_finetune`` with
``dist.tcsr=false`` and after a failed pin); and LayerHooks under both
modes against the single-device forward.

Ranks are spawned processes (dist/launch.py) that import torch and the
port only; their functions live in fragnet_tpu_torch/dist/checks.py. The
group meets through a file under tmp_path and every collective and the
whole run time out, so a rank that fails cannot hang the suite. Inputs are
made with numpy from a seed. Tolerances: 1e-5 for one pass (f32, the two
frameworks sum in different orders), 1e-4 relative for the model (two
layers deep); bf16: predictions 2e-2 of their scale, gradients 5e-2 of
their own scale, floor 1e-4 of the largest (tests/test_torch_bf16.py's
bounds); the EP forward with hooks against the port's single-device one
1e-5 of each output's scale.
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
    """``fn(*args)`` in S spawned ranks, each on one intra-op thread (their
    many small ops and gloo's waits oversubscribe the cores otherwise)."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return run_ranks(fn, S, args, device="cpu", timeout_s=120,
                         join_timeout_s=300, workdir=str(tmp_path))
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


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
def plain_batch(port_graphs):
    """The port batch of all eight molecules padded for S = 2, without tile
    metadata (the segment mode's batch)."""
    return pad_batch(port_graphs, spec_for(port_graphs, batch_size=8,
                                           multiple=8 * S))


@pytest.fixture(scope="module")
def ep_batches(ft_graphs, plain_batch):
    """(JAX batch, port batch with 2-shard EPTileMeta) of all eight
    molecules, padded for S = 2 at tn = te = 8."""
    bj = jax_pad_batch(ft_graphs, jax_spec_for(ft_graphs, batch_size=8,
                                               multiple=8 * S))
    bp, ok = with_ep_tile_meta(plain_batch, S, tn=8, te=8)
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
BF = torch.bfloat16


def _hooks(n_atoms):
    """One LayerHooks per layer of SMALL, every field set."""
    from fragnet_tpu_torch.model.layers import LayerHooks

    zero = torch.zeros(n_atoms)
    zero[5] = 1.0
    return [LayerHooks(bond_mask=2, frag_bond_mask=1, atom_mask=3,
                       atom_zero_vec=zero),
            LayerHooks(bond_rows=torch.tensor([0, 7]),
                       fconn_rows=torch.tensor([1]),
                       atom_rows=torch.tensor([4, 9]))]


def _ft_opt(exp_dir, **dist):
    return Config({
        "seed": 7, "exp_dir": str(exp_dir), "model_version": "gat2",
        "dist": {"mode": "ep", "n_devices": S, **dist},
        "finetune": {"model": dict(SMALL, act="relu", fthead="FTHead3"),
                     "target_type": "regr", "batch_size": 4,
                     "n_epochs": 1}}).to_dict()


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory, ep_batches, plain_batch, jax_model,
                 port_graphs):
    """The rank side of the pass tests (both self_loops, and the segment
    mode's pass), the model tests (fused; segment in f32 and bf16; both
    with hooks) and two segment-mode run_finetune runs (dist.tcsr=false,
    and tiles whose pins fail), in one start of two ranks."""
    sd = state_dict_from_jax(jax_model[1])
    tmp = tmp_path_factory.mktemp("ep")
    datasets = (port_graphs[:4], port_graphs[4:6], port_graphs[6:], 1,
                "regr")
    hooks = _hooks(plain_batch.x_atoms.shape[0])
    calls = {
        "pass": [(checks.ep_pass_rank, _pass_args(sl))
                 for sl in (False, True)],
        "model": (checks.ep_model_rank, (SMALL, sd, ep_batches[1],
                                         MODEL_LR)),
        "seg_pass": (checks.ep_segment_pass_rank, _segment_pass_args()),
        "seg_model": (checks.ep_model_rank, (SMALL, sd, plain_batch,
                                             MODEL_LR)),
        "seg_model_bf16": (checks.ep_model_rank,
                           (dict(SMALL, dtype=BF), sd, plain_batch,
                            MODEL_LR)),
        "hooks_fused": (checks.ep_model_rank, (SMALL, sd, ep_batches[1],
                                               MODEL_LR, "cpu", hooks)),
        "hooks_segment": (checks.ep_model_rank, (SMALL, sd, plain_batch,
                                                 MODEL_LR, "cpu", hooks)),
        "ft_segment": (checks.ep_finetune_rank,
                       (_ft_opt(tmp / "seg", tcsr=False), datasets)),
        # tn 12, te 8: shards of 12·k edges, not all a multiple of te
        "ft_pins_fail": (checks.ep_finetune_rank,
                         (_ft_opt(tmp / "pins", tile_tn=12, tile_te=8),
                          datasets)),
    }
    flat = calls.pop("pass") + list(calls.values())
    res = _ranks(checks.calls_rank, (flat,), tmp)
    out = {"pass": {sl: [r[i] for r in res]
                    for i, sl in enumerate((False, True))}}
    for i, key in enumerate(calls, start=2):
        out[key] = [r[i] for r in res]
    return out


@pytest.fixture(scope="module")
def jax_ref(ep_batches, jax_model):
    """The JAX single-device model on the EP batch (no tile metadata: its
    segment path): predictions, last-layer attentions, the MSE and its
    parameter gradients, under the port's names."""
    bj, _bp = ep_batches
    model, params = jax_model
    pred_j, attn_j = jax.jit(lambda p: model.apply(
        p, bj, deterministic=True, return_attentions=True))(params)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_mse(model.apply(p, bj, deterministic=True), bj.y,
                          bj.graph_mask)))(params)
    return pred_j, attn_j, float(loss_j), state_dict_from_jax(
        jax.device_get(grads_j))


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


def _check_model_against_jax(res, jax_model, jax_ref, lr=MODEL_LR):
    """Each rank's predictions, attentions, loss, averaged gradients and
    SGD update against the JAX single-device model (1e-4 relative)."""
    _model, params = jax_model
    pred_j, attn_j, loss_j, want = jax_ref
    sd = state_dict_from_jax(params)
    scale = max(float(w.abs().max()) for w in want.values())
    rel = dict(rtol=1e-4)
    for r in res:
        _close(r["pred"], pred_j, atol=1e-4 * float(np.abs(pred_j).max()),
               **rel)
        assert abs(r["loss"] - loss_j) <= 1e-4 * loss_j
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


def test_ep_model_matches_jax_single_device(rank_results, jax_model,
                                            jax_ref):
    """FragNetFineTune under EP (2 ranks) against the JAX single-device
    model with the same weights: predictions, the four attention vectors,
    the loss and every averaged parameter gradient, and the parameters
    after one SGD step."""
    _check_model_against_jax(rank_results["model"], jax_model, jax_ref)


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


# --------------------------------------------------------------------------
# the segment mode (batches without tile metadata)
# --------------------------------------------------------------------------

SEG_N = 37  # rows of the segment-sum case: not a multiple of S


def _segment_case():
    """The seeded pass case with per-head edge attributes, laid out in S
    shards (shard_edges), and a segment-sum case."""
    from fragnet_tpu_torch.dist.edge_partition import shard_edges

    c = _case(seed=2)
    rng = np.random.default_rng(5)
    H = c["nf"].shape[1]
    eh = rng.standard_normal((len(c["src"]), H, c["ea"].shape[1])).astype(
        np.float32)
    sh = shard_edges([eh, c["src"], c["dst"], c["mask"]], S)
    data = rng.standard_normal((2 * SEG_N, 3)).astype(np.float32)
    ids = rng.integers(0, 11, 2 * SEG_N).astype(np.int32)
    smask = (rng.random(2 * SEG_N) > 0.2).astype(np.float32)
    return c, eh, sh, (data, ids, 11, smask)


def _segment_pass_args():
    c, _eh, (ea, src, dst, mask), (data, ids, n, smask) = _segment_case()
    t = torch.from_numpy
    return (t(c["nf"]), t(ea), t(src), t(dst), t(mask), t(c["a"]),
            t(c["g"]), t(data), t(ids), n, t(smask))


def test_segment_ep_pass_and_sum_match_jax(rank_results):
    """``edge_partitioned_gat_pass`` and ``edge_partitioned_segment_sum``
    over two gloo ranks against the JAX package's on a 2-device CPU mesh,
    and the pass's averaged gradients against the JAX single-device
    pass's (1e-5)."""
    from fragnet_tpu.dist.edge_partition import (
        edge_partitioned_gat_pass as jax_ep_pass,
        edge_partitioned_segment_sum as jax_ep_sum)
    from fragnet_tpu.ops.segment import gat_attention_pass as jax_pass

    c, eh, (ea, src, dst, mask), (data, ids, n, smask) = _segment_case()
    mesh = Mesh(np.array(jax.devices()[:S]), ("data",))
    j = jnp.asarray
    out_j = jax_ep_pass(mesh, j(c["nf"]), j(ea), j(src), j(dst), j(mask),
                        j(c["a"]))
    sum_j = jax_ep_sum(mesh, j(data), j(ids), n, mask=j(smask))

    def loss(nf, e, a):
        out, _ = jax_pass(nf, e, j(c["src"]), j(c["dst"]), a, c["N"],
                          edge_mask=j(c["mask"]))
        return jnp.sum(out * j(c["g"]))

    grads_j = jax.grad(loss, argnums=(0, 1, 2))(j(c["nf"]), j(eh),
                                                j(c["a"]))
    Es = ea.shape[1]
    for r in rank_results["seg_pass"]:
        _close(r["out"], out_j)
        _close(r["segment_sum"], sum_j)
        _close(r["d_nf"], grads_j[0])
        _close(r["d_ea"].reshape(S * Es, *eh.shape[1:])[:len(eh)],
               grads_j[1])
        _close(r["d_avec"], grads_j[2])


def test_segment_ep_model_matches_jax_single_device(rank_results, jax_model,
                                                    jax_ref, plain_batch):
    """The segment mode (a batch with no tile metadata, two ranks) against
    the JAX single-device model: predictions, attentions, loss, averaged
    gradients and the SGD update (1e-4 relative); its local batch pads
    each sharded level to a multiple of S as shard_edges does."""
    from fragnet_tpu_torch.dist.edge_partition import ep_local_batch

    _check_model_against_jax(rank_results["seg_model"], jax_model, jax_ref)
    odd = dataclasses.replace(plain_batch,
                              edge_src=plain_batch.edge_src[:-1],
                              fc_mask=plain_batch.fc_mask[:-3])
    parts = [ep_local_batch(odd, r, S) for r in range(S)]
    n = len(odd.edge_src)
    assert all(len(p.edge_src) == (n + 1) // S for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([p.edge_src for p in parts])[:n], odd.edge_src)
    assert parts[-1].fc_mask[-1] == 0 and parts[-1].edge_src[-1] == 0
    with pytest.raises(ValueError, match="EPTileMeta"):
        one = dataclasses.replace(plain_batch, tm_atom=build_tile_meta(
            plain_batch.edge_src, plain_batch.edge_dst, plain_batch.edge_mask,
            plain_batch.x_atoms.shape[0], tn=8, te=8))
        ep_local_batch(one, 0, S)


def test_segment_ep_model_bf16_matches_jax(rank_results, ep_batches,
                                           jax_model):
    """The segment mode in bf16 (two ranks) against the JAX single-device
    bf16 model with the same weights: predictions within 2e-2 of their
    scale, every averaged gradient within 5e-2 of its own scale (floor
    1e-4 of the largest)."""
    bj, _bp = ep_batches
    _model, params = jax_model
    model = JaxModel(**SMALL, dtype=jnp.bfloat16)
    pred_j = np.asarray(jax.jit(lambda p: model.apply(
        p, bj, deterministic=True))(params), np.float32)
    grads_j = state_dict_from_jax(jax.device_get(jax.jit(jax.grad(
        lambda p: jax_mse(model.apply(p, bj, deterministic=True), bj.y,
                          bj.graph_mask)))(params)))
    top = max(float(w.abs().max()) for w in grads_j.values())
    for r in rank_results["seg_model_bf16"]:
        scale = float(np.abs(pred_j).max())
        assert float(np.abs(r["pred"].float().numpy() - pred_j).max()) \
            <= 2e-2 * scale
        for name, w in grads_j.items():
            g = r["grads"][name]
            g = torch.zeros_like(w) if g is None else g.float()
            assert bool(torch.isfinite(g).all()), name
            assert float((g - w).abs().max()) <= 5e-2 * max(
                float(w.abs().max()), 1e-4 * top), name


@pytest.mark.parametrize("mode", ["hooks_fused", "hooks_segment"])
def test_ep_forward_with_hooks_matches_single_device(rank_results, jax_model,
                                                     plain_batch, mode):
    """An EP forward with LayerHooks (every field, both layers), in the
    fused and the segment mode, against the port's single-device forward
    with the same hooks: predictions and the four attention vectors
    (1e-5 of each one's scale); the hooks change the prediction."""
    from fragnet_tpu_torch.graphs.batch import to_device

    model = FragNetFineTune(**SMALL)
    model.load_state_dict(state_dict_from_jax(jax_model[1]))
    model.eval()
    b = to_device(plain_batch, "cpu")
    with torch.no_grad():
        pred, attn = model(b, return_attentions=True,
                           hooks=_hooks(b.x_atoms.shape[0]))
        bare = model(b)
    assert float((pred - bare).abs().max()) > 1e-3 * float(bare.abs().max())
    for r in rank_results[mode]:
        _close(r["pred"], pred, atol=1e-5 * float(pred.abs().max()))
        for lvl in ("atoms", "frags", "bonds", "fbonds"):
            ref = getattr(attn, lvl)
            _close(r["attn"][lvl], ref, atol=1e-5 * float(ref.abs().max()))


def test_run_finetune_segment_ep_and_pin_fallback(rank_results):
    """``run_finetune`` with dist.mode=ep on two ranks in the segment mode:
    with dist.tcsr=false, and when the K3 pins fail (the JAX package's
    message on rank 0, then training on the segment mode): finite values
    and parameters, the same losses and test value on both ranks."""
    for key, reason in (("ft_segment", "dist.tcsr=false"),
                        ("ft_pins_fail", "EP tile-meta probe failed")):
        r0, r1 = rank_results[key]
        assert [r["rank"] for r in (r0, r1)] == [0, 1]
        assert np.isfinite(r0["value"] + sum(r0["train_loss"]))
        assert (r0["value"], r0["train_loss"], r0["val_score"]) == (
            r1["value"], r1["train_loss"], r1["val_score"])
        assert r0["finite"]
        assert f"ep fused kernel off: {reason}" in r0["printed"]
        assert "ep fused kernel active" not in r0["printed"]
        assert r1["printed"] == ""
