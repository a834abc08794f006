"""bf16 compute on the paths beyond the single-device finetune: the
dense-attr pass (the plain versions of K7, K8 and K9) and K3's local ops
against fragnet_tpu's in bf16, the packed transport's bf16 entry, the plane
builder's widening of bf16 attributes, gat2 under the dense-attr policy and
gat2_masked pretraining against the JAX models in bf16, and the trainers
on the CPU in bf16 (run_pretrain through the packed transport,
run_aux_pretrain, and data-parallel and edge-partitioned steps over two
gloo ranks against the one-device bf16 step).

Inputs are made with numpy from a seed and rounded to bf16 once, so both
packages see the same bf16 values; weights are carried across with
``state_dict_from_jax`` (parameters stay f32 in both). The JAX side runs
its Pallas kernels in interpret mode, as its own tests do. Tolerances, as
tests/test_torch_bf16.py states them:

* a pass's f32 outputs and gradients (the attention vector, K3's stats and
  U, V, the attention vector's gradient): atol = rtol = 1e-5, the same f32
  sums in another order;
* a pass's bf16 outputs and bf16 gradients (out, d_nf, d_ea): within one
  bf16 ulp of the larger value, or 1e-5 of the scale (a gradient that is 0
  in exact arithmetic, as at a one-neighbour row, is JAX round-off there);
* the packed bf16 entry: its bytes equal to the JAX package's, every
  decoded field exact;
* a whole model: predictions within 2e-2 of their scale of JAX bf16's, the
  port's distance from JAX f32 at most twice JAX bf16's own plus 1e-3 of
  the scale; every parameter gradient within 5e-2 of its own scale, floor
  1e-4 of the largest gradient (the embed biases' gradients are 0 in exact
  arithmetic). The distributed steps are held to the one-device bf16 step
  by the same bounds (the ranks sum in f32 in another order, and a bf16
  rounding may land on the other side). The measured values are printed
  (``-s``).

Small model: 2 layers, emb 32, 4 heads; torch and BLAS pinned to one
thread; the JAX compiles shared through module fixtures.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from fragnet_tpu.data.batcher import BatchLoader as JaxLoader
from fragnet_tpu.data.datasets import PretrainData as JaxPretrainData
from fragnet_tpu.data.packing import unpack_batch as jax_unpack_batch
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.model.layers import KernelPolicy as JaxPolicy
from fragnet_tpu.model.layers import set_kernel_policy
from fragnet_tpu.model.pretrain import FragNetPreTrainMasked as JaxMasked
from fragnet_tpu.ops.dense_gat import dense_attr_gat_pass as jax_attr_pass
from fragnet_tpu.ops.pallas_gat import _make_ep_op
from fragnet_tpu.ops.tcsr import build_ep_tile_meta as jax_build_ep
from fragnet_tpu.ops.tcsr import build_tile_meta as jax_tile_meta
from fragnet_tpu.train.loop import mse_loss as jax_mse
from fragnet_tpu.train.pretrain import pretrain_loss as jax_pretrain_loss

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data import packing
from fragnet_tpu_torch.dist import checks
from fragnet_tpu_torch.dist.data_parallel import DPBatchLoader, stack_for_dp
from fragnet_tpu_torch.dist.edge_partition import with_ep_tile_meta
from fragnet_tpu_torch.dist.launch import run_ranks
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.data.datasets import PretrainData
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.model.layers import KernelPolicy
from fragnet_tpu_torch.model.pretrain import FragNetPreTrainMasked
from fragnet_tpu_torch.obs import read_scalars
from fragnet_tpu_torch.ops import dense_gat, tcsr_gat
from fragnet_tpu_torch.ops.dense_gat import build_dense_planes
from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta, build_tile_meta
from fragnet_tpu_torch.train import pretrain as port_pretrain
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.loop import mse_loss
from fragnet_tpu_torch.train.pretrain import pretrain_loss

BF = torch.bfloat16
TOL32 = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(num_layer=2, num_heads=4, emb_dim=32)
HEAD = dict(h1=16, h2=16, h3=16, h4=16)
PRED_LIMIT, GRAD_LIMIT, GRAD_FLOOR = 2e-2, 5e-2, 1e-4
PT_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "CC(=O)Oc1ccccc1C(=O)O",
             "OCC(O)C(O)CO"]
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None, dp_atom=None, dp_frag=None)
_META = ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread and one BLAS thread, so that test workers
    sharing the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _bf16(x):
    """numpy f32 → (the port's bf16 tensor, the same values as a JAX bf16
    array)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close32(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), **TOL32)


def _within_ulp(port, ref, name, atol=0.0):
    """Both bf16: each element within one bf16 ulp of the larger of the
    two (ulp(x) = 2^(⌊log2 |x|⌋ − 7)), or within ``atol`` · max|ref|."""
    assert port.dtype == BF and ref.dtype == jnp.bfloat16, name
    p, r = _np(port), _np(ref)
    big = np.maximum(np.abs(p), np.abs(r))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    err = np.abs(p - r)
    n_ulp = np.where(err <= atol * float(np.abs(r).max()), 0.0, err / ulp)
    print(f"{name}: max {float(n_ulp.max()):.2f} bf16 ulp, "
          f"{int((p != r).sum())} of {p.size} differ")
    assert float(n_ulp.max()) <= 1.0, name


def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


def _launches(*kernels):
    return tuple(k.launches for k in kernels)


# --------------------------------------------------------------------------
# the passes: the dense-attr pass (K7, K8, K9) and K3's local ops
# --------------------------------------------------------------------------

def _attr_case(seed):
    """Tile-local edges sorted by dst without a repeated pair, one real
    edge masked, padded: tn 16, 3 tiles, H 4, D 8, Da 12, te 16."""
    rng = np.random.default_rng(seed)
    tn, n_tiles, E = 16, 3, 160
    N = tn * n_tiles
    src_l, dst_l = [], []
    for t in range(n_tiles):
        seen = set()
        for _ in range(int(rng.integers(12, 40))):
            i, j = (int(x) for x in rng.integers(0, tn, 2))
            if (i, j) not in seen:
                seen.add((i, j))
                src_l.append(t * tn + j)
                dst_l.append(t * tn + i)
    order = np.argsort(dst_l, kind="stable")
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    mask = np.zeros(E, np.float32)
    src[:len(order)] = np.array(src_l)[order]
    dst[:len(order)] = np.array(dst_l)[order]
    mask[:len(order)] = 1.0
    mask[5] = 0.0
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=16)
    meta = dataclasses.replace(
        meta, **{f: torch.from_numpy(getattr(meta, f))
                 for f in ("ew_blk", "sw_tile", "flat_slot", "cw")})
    adj = build_dense_planes(src, dst, mask, np.zeros((E, 0), np.float32), N,
                             tn=tn)
    return dict(rng=rng, N=N, E=E, src=src, dst=dst, mask=mask, meta=meta,
                meta_j=jax_tile_meta(src, dst, mask, N, tn=tn, te=16),
                adj=adj)


@pytest.mark.parametrize("self_loops", [False, True],
                         ids=["no-self-loops", "self-loops"])
def test_dense_attr_pass_bf16_matches_pallas(self_loops):
    """The dense-attr pass in bf16 — the plain versions of K7 and of K8
    with K9 (through DenseAttrGatFn) — against dense_attr_gat_pass(...,
    interpret=True) in bf16: out, the attention vector and jax.vjp's d_nf,
    d_ea, d_a."""
    c = _attr_case(61 + self_loops)
    rng, N, E = c["rng"], c["N"], c["E"]
    H, D, Da = 4, 8, 12
    nf_t, nf_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    ea_t, ea_j = _bf16(rng.standard_normal((E, Da)).astype(np.float32))
    g_t, g_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    ints_j = tuple(jnp.asarray(c[k]) for k in ("src", "dst", "mask"))

    def f(nf_, ea_, a_):
        return jax_attr_pass(nf_, ea_, *ints_j, a_, jnp.asarray(c["adj"]),
                             c["meta_j"], self_loops=self_loops,
                             interpret=True)

    (out_j, attn_j), vjp = jax.vjp(f, nf_j, ea_j, jnp.asarray(a))
    d_nf_j, d_ea_j, d_a_j = vjp((g_j, jnp.zeros_like(attn_j)))
    t = torch.from_numpy
    xs = [nf_t.clone().requires_grad_(), ea_t.clone().requires_grad_(),
          t(a).requires_grad_()]
    counters = (dense_gat.KERNEL_ATTR, dense_gat.KERNEL_ATTR_BWD,
                dense_gat.KERNEL_ATTR_BF16, dense_gat.KERNEL_ATTR_BWD_BF16)
    n0 = _launches(*counters)
    out_p, attn_p = dense_gat.dense_attr_gat_pass(
        xs[0], xs[1], t(c["src"]), t(c["dst"]), t(c["mask"]), xs[2],
        t(c["adj"]), c["meta"], self_loops=self_loops, return_attention=True)
    d_nf, d_ea, d_a = torch.autograd.grad(
        (out_p.float() * g_t.float()).sum(), xs)
    # CPU tensors: the plain versions, no launch
    assert _launches(*counters) == n0
    assert out_p.dtype == BF and d_nf.dtype == BF and d_ea.dtype == BF
    assert d_a.dtype == torch.float32
    name = f"dense-attr {'self-loops' if self_loops else 'no self-loops'}"
    _within_ulp(out_p, out_j, f"{name} out")
    _close32(attn_p, attn_j)
    _within_ulp(d_nf, d_nf_j, f"{name} d_nf", atol=1e-5)
    _within_ulp(d_ea, d_ea_j, f"{name} d_ea", atol=1e-5)
    _close32(d_a, d_a_j)


def test_k3_plain_bf16_matches_pallas_local_ops():
    """Per shard of 2: K3's plain forward with bf16 nf against
    ``local_stats`` of ``_make_ep_op`` built for bfloat16; U, V and the
    gradients of Σ U·dU + V·dV w.r.t. nf, ea (bf16) and the attention
    vector (TcsrGatEpFn, K3's plain backward, nf widened for the autograd
    side as tcsr_gat_pass_ep does) against jax.vjp of ``local_unnorm``,
    at the global max of both shards' stats."""
    rng = np.random.default_rng(71)
    S, N, E, H, D, Da, tn, te = 2, 64, 128, 4, 8, 4, 8, 8
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    src = np.clip(dst + rng.integers(-6, 7, E), 0, N - 1).astype(np.int32)
    mask = (rng.random(E) > 0.1).astype(np.float32)
    nf_t, nf_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    ea_t, ea_j = _bf16(rng.standard_normal((E, Da)).astype(np.float32))
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    dU_all = rng.standard_normal((N, H * D)).astype(np.float32)
    dV_all = rng.standard_normal((N, H)).astype(np.float32)
    mj = jax_build_ep(src, dst, mask, N, S, tn=tn, te=te)
    meta = build_ep_tile_meta(src, dst, mask, N, S, tn=tn, te=te)
    meta = dataclasses.replace(meta, **{f: torch.from_numpy(getattr(meta, f))
                                        for f in _META})
    Tg, Es = mj.n_tiles_grid, E // S
    Ng = Tg * tn
    local_stats, local_unnorm, _ = _make_ep_op(
        N, Es, H, D, Da, tn, te, mj.k_src, mj.n_chunks, Tg, 0.2, "bfloat16",
        True)
    a_j = jnp.asarray(a)
    shard = lambda x, r: x[r * Es:(r + 1) * Es]
    args = []
    for r in range(S):
        sl = tuple(jnp.asarray(shard(x, r)) for x in (src, dst, mask))
        args.append((sl, tuple(jnp.asarray(getattr(mj, f)[r])
                               for f in _META)))
    stats = [local_stats(nf_j, shard(ea_j, r), *sl, a_j, t0, ew, sw, cw)
             for r, (sl, (t0, ew, sw, _flat, cw)) in enumerate(args)]
    M = np.full((N, H), -1e30, np.float32)
    for r in range(S):
        r0 = int(mj.t0[r, 0]) * tn
        M[r0:r0 + Ng] = np.maximum(M[r0:r0 + Ng], np.asarray(stats[r][1]))
    Mg = np.where(M <= -5e29, 0.0, M).astype(np.float32)

    t = torch.from_numpy
    counters = (tcsr_gat.KERNEL_EP, tcsr_gat.KERNEL_EP_BWD,
                tcsr_gat.KERNEL_EP_BF16, tcsr_gat.KERNEL_EP_BWD_BF16)
    n0 = _launches(*counters)
    for r, (sl, (t0, ew, sw, flat, cw)) in enumerate(args):
        s_, d_, m_ = (t(np.ascontiguousarray(shard(x, r)))
                      for x in (src, dst, mask))
        xs = [nf_t.clone().requires_grad_(),
              shard(ea_t, r).clone().requires_grad_(), t(a).requires_grad_()]
        nf32 = xs[0].float()
        wn, w_ea = tcsr_gat.prologue(nf32, xs[1], xs[2])
        nf_k = xs[0].detach().reshape(N, H * D)
        with torch.no_grad():
            got = tcsr_gat.tcsr_gat_ep_fwd(wn, nf_k, w_ea, s_, d_, m_, meta, r)
        for gp, gj in zip(got, stats[r]):
            _close32(gp, gj)
        r0 = int(mj.t0[r, 0]) * tn
        U, V = tcsr_gat.TcsrGatEpFn.apply(
            wn, nf32.reshape(N, H * D), w_ea, s_, d_, m_, meta, r,
            t(Mg[r0:r0 + Ng]), got, 0.2, nf_k)
        dU, dV = dU_all[:Ng], dV_all[:Ng]
        d_nf, d_ea, d_a = torch.autograd.grad(
            (U * t(dU)).sum() + (V * t(dV)).sum(), xs)

        def f(nf_, ea_, a_):
            return local_unnorm(nf_, ea_, *sl, a_, jnp.asarray(Mg), stats[r],
                                t0, ew, sw, flat, cw)

        (Uj, Vj), vjp = jax.vjp(f, nf_j, shard(ea_j, r), a_j)
        _close32(U, Uj)
        _close32(V, Vj)
        d_nf_j, d_ea_j, d_a_j = vjp((jnp.asarray(dU), jnp.asarray(dV)))
        assert d_nf.dtype == BF and d_ea.dtype == BF
        _within_ulp(d_nf, d_nf_j, f"K3 shard {r} d_nf", atol=1e-5)
        _within_ulp(d_ea, d_ea_j, f"K3 shard {r} d_ea", atol=1e-5)
        _close32(d_a, d_a_j)
    assert _launches(*counters) == n0


# --------------------------------------------------------------------------
# the packed transport's bf16 entry and the plane builder's widening
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pt_graphs():
    """(JAX, port) pretrain graphs of the same SMILES."""
    return (JaxPretrainData().get_pt_dataset(PT_SMILES, seed=0),
            PretrainData().get_pt_dataset(PT_SMILES, seed=0))


def test_packed_bf16_layout_and_bytes_match_jax(pt_graphs):
    """A bf16 model's packed batches (tile-aligned, with targets): the
    port's layout lists the JAX package's entries — name, encoding, shape,
    decoded dtype — in its order, ea_bonds as bf16; each entry's bytes are
    the JAX package's (only the port's 16-byte offsets differ); decoding
    gives the JAX package's decoded fields exactly, ea_bonds in bf16, and
    the host batch's values rounded to bf16 once (the round trip)."""
    jg, pg = pt_graphs
    kw = dict(batch_size=4, multiple=16, tcsr=True, tn=16, te=16, align=True)
    sj, sp = jax_spec_for(jg, **kw), spec_for(pg, **kw)
    lj = JaxLoader(jg, 4, spec=sj, to_device=False, with_targets=True,
                   pack=True, compute_dtype=jnp.bfloat16)
    lp = BatchLoader(pg, 4, spec=sp, with_targets=True, pack=True,
                     compute_dtype=BF)
    n = 0
    for bj, bp, window in zip(lj, lp, lp._windows()):
        ej, ep = lj.layout.entries, lp.layout.entries
        assert [(e.name, e.enc, tuple(e.shape), e.out_dtype) for e in ep] \
            == [(e.name, e.enc, tuple(e.shape), e.out_dtype) for e in ej]
        assert lp.layout.entry("ea_bonds").enc == packing.BF16
        assert lp.layout.entry("ea_bonds").out_dtype == "bfloat16"
        for a, b in zip(ej, ep):
            size = (4 if a.enc == packing.MASKC
                    else int(np.prod(a.shape)) * packing._ITEM[a.enc])
            np.testing.assert_array_equal(
                bp[b.offset:b.offset + size], bj[a.offset:a.offset + size],
                err_msg=a.name)
        uj = jax_unpack_batch(jnp.asarray(bj), lj.layout)
        up = packing.unpack_batch(torch.from_numpy(bp), lp.layout)
        assert up.ea_bonds.dtype == BF and uj.ea_bonds.dtype == jnp.bfloat16
        host = pad_batch(window, sp, with_targets=True, build_dense=False)
        np.testing.assert_array_equal(
            up.ea_bonds.float().numpy(),
            torch.from_numpy(host.ea_bonds).to(BF).float().numpy())
        for f in dataclasses.fields(up):
            got, want = getattr(up, f.name), getattr(uj, f.name)
            if f.name.startswith(("tm_", "dp_")) or got is None:
                continue
            np.testing.assert_array_equal(_np(got), _np(want),
                                          err_msg=f.name)
        # the planes of the bf16 attributes are those of their widening
        for lvl, ea in (("dp_bond", up.ea_bonds), ("dp_fc", up.ea_fbonds)):
            assert getattr(up, lvl).dtype == torch.float32
            src_f, dst_f, mask_f = {"dp_bond": ("bg_src", "bg_dst",
                                                "bg_mask"),
                                    "dp_fc": ("fc_src", "fc_dst",
                                              "fc_mask")}[lvl]
            want = dense_gat.build_dense_planes_device_plain(
                getattr(up, src_f), getattr(up, dst_f), getattr(up, mask_f),
                ea.float(), getattr(up, lvl).shape[0]
                * getattr(up, lvl).shape[2],
                getattr(up, "tm_" + lvl[3:]))
            assert torch.equal(getattr(up, lvl), want), lvl
        n += 1
    assert n >= 2


@pytest.mark.parametrize("R", [1, 6])
def test_plane_builder_widens_bf16_attributes(R):
    """build_dense_planes_device with bf16 attributes gives, in f32, the
    planes of their f32 widening exactly (as the JAX package's widens
    them; K6 has no bf16 form), equal to the host builder's; another
    attribute type is refused."""
    c = _attr_case(80 + R)
    t = torch.from_numpy
    ea_t, _ = _bf16(c["rng"].standard_normal((c["E"], R)).astype(np.float32))
    args = (t(c["src"]), t(c["dst"]), t(c["mask"]))
    got = dense_gat.build_dense_planes_device(*args, ea_t, c["N"], c["meta"])
    want = dense_gat.build_dense_planes_device(*args, ea_t.float(), c["N"],
                                               c["meta"])
    assert got.dtype == torch.float32 and torch.equal(got, want)
    host = build_dense_planes(c["src"], c["dst"], c["mask"],
                              ea_t.float().numpy(), c["N"], tn=16)
    np.testing.assert_array_equal(got.numpy(), host)
    with pytest.raises(ValueError, match="dtype"):
        dense_gat.build_dense_planes_device(*args, ea_t.half(), c["N"],
                                            c["meta"])


# --------------------------------------------------------------------------
# whole models against the JAX models in bf16
# --------------------------------------------------------------------------

def _compare(label, want32, want16, got, grads_j, port):
    """The module docstring's model bounds: ``got`` (the port's bf16
    outputs) against JAX bf16's ``want16`` and f32's ``want32``, each
    output against its own scale; the port's parameter gradients against
    ``grads_j`` (the JAX bf16 model's, as a state dict)."""
    worst_p = 0.0
    for i, (g, w16, w32) in enumerate(zip(got, want16, want32)):
        g, w16, w32 = _np(g), np.asarray(w16, np.float32), np.asarray(
            w32, np.float32)
        assert np.isfinite(g).all() and g.shape == w16.shape, (label, i)
        scale = max(float(np.abs(w32).max()), 1e-30)
        d_pj = float(np.abs(g - w16).max()) / scale
        d_p32 = float(np.abs(g - w32).max()) / scale
        d_j32 = float(np.abs(w16 - w32).max()) / scale
        print(f"{label} output {i}: |port - jax bf16| {d_pj:.3e} of scale "
              f"(limit {PRED_LIMIT}); |port - jax f32| {d_p32:.3e}, |jax "
              f"bf16 - jax f32| {d_j32:.3e} (limit 2x + 1e-3)")
        assert d_pj <= PRED_LIMIT, (label, i)
        assert d_p32 <= 2 * d_j32 + 1e-3, (label, i)
        worst_p = max(worst_p, d_pj)
    names = dict(port.named_parameters())
    assert set(names) == set(grads_j)
    top = max(float(w.abs().max()) for w in grads_j.values())
    worst, worst_name = 0.0, None
    for n, p in names.items():
        assert p.dtype == torch.float32, n  # parameters stay f32
        got_g = torch.zeros_like(p) if p.grad is None else p.grad
        assert bool(torch.isfinite(got_g).all()), n
        w = grads_j[n]
        rel = float((got_g - w).abs().max()) / max(
            float(w.abs().max()), GRAD_FLOOR * top, 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    print(f"{label}: worst gradient {worst:.3e} of scale ({worst_name}; "
          f"limit {GRAD_LIMIT})")
    assert worst <= GRAD_LIMIT


@pytest.fixture(scope="module")
def ft_aligned(ft_graphs):
    """(JAX batch, port batch): seven of the eight molecules and one
    padding graph, tile-aligned with TCSR metadata and every plane level
    (the dense-attr policy reads dp_atom and dp_frag)."""
    builder = PortBuilder("exp1s")
    jg = ft_graphs[:7]
    pg = [builder.build(*port_engine.mol_3d(g.smiles), g.y, smiles=g.smiles)
          for g in jg]
    kw = dict(batch_size=len(jg) + 1, tcsr=True, align=True)
    bj = jax_pad_batch(jg, jax_spec_for(jg, **kw))
    bp = pad_batch(pg, spec_for(pg, **kw))
    assert bp.dp_atom is not None and bp.dp_frag is not None
    return _jnp(bj), bp


def test_gat2_dense_attr_bf16_matches_jax(ft_aligned):
    """gat2 in bf16 under the dense-attr policy (kernel.attr with
    kernel.fc=attr: the atom, frag and fconn passes on the plain K7 / K8 /
    K9, the bond pass on K4 / K5) against the JAX model in bf16 under the
    same policy: the prediction and every parameter's MSE gradient."""
    bj, bp = ft_aligned
    j16 = JaxModel(**SMALL, **HEAD, dtype=jnp.bfloat16)
    params = j16.init(jax.random.PRNGKey(5),
                      dataclasses.replace(bj, **_NO_KERNELS),
                      deterministic=True)
    policy = KernelPolicy(attr=True, fc="attr")
    port = FragNetFineTune(**SMALL, **HEAD, dtype=BF, policy=policy)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.eval()
    set_kernel_policy(JaxPolicy(attr=True, fc="attr"))
    try:
        y32 = JaxModel(**SMALL, **HEAD).apply(params, bj, deterministic=True)

        def loss(p):
            pred = j16.apply(p, bj, deterministic=True)
            return jax_mse(pred, bj.y, bj.graph_mask), pred

        (_, y16), grads = jax.value_and_grad(loss, has_aux=True)(params)
    finally:
        set_kernel_policy(JaxPolicy())
    b = to_device(bp, "cpu")
    counters = (dense_gat.KERNEL_ATTR_BF16, dense_gat.KERNEL_ATTR_BWD_BF16)
    n0 = _launches(*counters)
    pred = port(b)
    mse_loss(pred, b.y, b.graph_mask).backward()
    assert _launches(*counters) == n0
    assert all(layer.dtype == BF and layer.policy == policy
               for layer in port.pretrain.layers)
    _compare("gat2 dense-attr", [y32], [y16], [pred],
             state_dict_from_jax(jax.device_get(grads)), port)


def test_gat2_masked_pretrain_bf16_matches_jax(pt_graphs):
    """gat2_masked pretraining in bf16 (eval mode: no mask drawn) on the
    aligned-tcsr route against the JAX FragNetPreTrainMasked in bf16: the
    four geometric outputs, computed by the f32 head from the bf16
    encoder's outputs, and every parameter's gradient of the pretrain
    loss."""
    jg, pg = pt_graphs
    kw = dict(batch_size=len(jg), tcsr=True, align=True)
    bj = _jnp(jax_pad_batch(jg, jax_spec_for(jg, **kw), with_targets=True))
    bp = pad_batch(pg, spec_for(pg, **kw), with_targets=True)
    kw_m = dict(SMALL, drop_ratio=0.0)
    j16 = JaxMasked(**kw_m, dtype=jnp.bfloat16)
    params = j16.init(jax.random.PRNGKey(6),
                      dataclasses.replace(bj, **_NO_KERNELS),
                      deterministic=True)
    want32 = JaxMasked(**kw_m).apply(params, bj, deterministic=True)
    want16 = j16.apply(params, bj, deterministic=True)
    grads = jax.grad(lambda p: jax_pretrain_loss(
        j16.apply(p, bj, deterministic=True), bj))(params)
    port = FragNetPreTrainMasked(**kw_m, dtype=BF, mask_seed=0)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.eval()
    b = to_device(bp, "cpu")
    got = port(b)
    assert all(g.dtype == torch.float32 for g in got)
    pretrain_loss(got, b).backward()
    _compare("gat2_masked pretrain", want32, want16, got,
             state_dict_from_jax(jax.device_get(grads)), port)


# --------------------------------------------------------------------------
# the trainers on the CPU in bf16
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
            "dtype": "bf16", **pretrain},
    })


def _losses(exp_dir, tag):
    return [r["value"] for r in read_scalars(str(exp_dir)) if r["tag"] == tag]


@pytest.mark.parametrize("model_version", ["gat2", "gat2_masked",
                                           "gat2_masked2"])
def test_run_pretrain_bf16_packed_transport(tmp_path, monkeypatch, capsys,
                                            model_version):
    """run_pretrain in bf16 through the packed transport (its CUDA gate
    opened on the CPU): the layout carries ea_bonds in bf16, every step
    decodes them as bf16 and the model computes in bf16; the losses are
    finite and the checkpoint holds f32 parameters."""
    monkeypatch.setattr(port_pretrain, "_packed_transport", lambda dev: True)
    seen = []
    real = port_pretrain.PretrainTrainer.__init__

    def spy(self, model, *a, layout=None, **kw):
        real(self, model, *a, layout=layout, **kw)
        if layout is not None:
            seen.append((model, layout))

    monkeypatch.setattr(port_pretrain.PretrainTrainer, "__init__", spy)
    opt = _pt_opt(tmp_path, cache="off", tcsr=True, stream_workers=2,
                  model_version=model_version)
    best, ckpt = port_pretrain.run_pretrain(opt, device="cpu")
    out = capsys.readouterr().out
    assert "dtype=bf16" in out and "packed HBM" in out
    (model, layout), = seen
    assert layout.entry("ea_bonds").out_dtype == "bfloat16"
    assert all(layer.dtype == BF for layer in model.pretrain.layers)
    losses = _losses(tmp_path, "train/loss")
    assert len(losses) == 2 and np.isfinite(losses).all() \
        and np.isfinite(best)
    sd = torch.load(ckpt, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values()
               if v.is_floating_point())


def test_run_aux_pretrain_bf16_trains(tmp_path, capsys):
    """run_aux_pretrain (property mode) with pretrain.dtype=bf16: its
    FragNetFineTune computes in bf16, trains to finite losses and writes
    its checkpoint."""
    opt = _pt_opt(tmp_path, mode="property", n_epochs=1, n_synthetic=12)
    seen = []
    real = port_pretrain.build_aux_model

    def spy(*a, **kw):
        m = real(*a, **kw)
        seen.append(m)
        return m

    port_pretrain.build_aux_model = spy
    try:
        best, ckpt = port_pretrain.run_pretrain(opt, device="cpu")
    finally:
        port_pretrain.build_aux_model = real
    (model,) = seen
    assert all(layer.dtype == BF for layer in model.pretrain.layers)
    assert np.isfinite(best) and os.path.exists(ckpt)
    losses = _losses(tmp_path, "train/loss")
    assert len(losses) == 1 and np.isfinite(losses).all()


# --------------------------------------------------------------------------
# data-parallel and edge-partitioned steps over two gloo ranks
# --------------------------------------------------------------------------

S = 2
DIST_KW = dict(SMALL, **HEAD, drop_ratio=0.0, dtype=BF)
EP_LR = 0.05


@pytest.fixture(scope="module")
def dist_case(ft_graphs):
    """The eight molecules (port graphs), the bf16 model's seeded weights,
    the EP batch (padded for 2 shards at tn = te = 8, with EPTileMeta) and
    the same batch with single-device TCSR metadata at those tiles."""
    builder = PortBuilder("exp1s")
    pg = [builder.build(*port_engine.mol_3d(g.smiles), g.y, smiles=g.smiles)
          for g in ft_graphs]
    model = FragNetFineTune(**DIST_KW,
                            generator=torch.Generator().manual_seed(3))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    plain = pad_batch(pg, spec_for(pg, batch_size=8, multiple=8 * S))
    ep_np, ok = with_ep_tile_meta(plain, S, tn=8, te=8)
    assert ok
    one = dataclasses.replace(plain, **{
        lvl: build_tile_meta(getattr(plain, s_), getattr(plain, d_),
                             getattr(plain, m_), n_, tn=8, te=8)
        for lvl, (s_, d_, m_, n_) in {
            "tm_atom": ("edge_src", "edge_dst", "edge_mask",
                        plain.x_atoms.shape[0]),
            "tm_bond": ("bg_src", "bg_dst", "bg_mask",
                        plain.edge_src.shape[0]),
            "tm_frag": ("frag_src", "frag_dst", "fconn_mask",
                        plain.x_frags.shape[0]),
            "tm_fc": ("fc_src", "fc_dst", "fc_mask",
                      plain.nf_fbonds.shape[0])}.items()})
    return pg, sd, ep_np, one


@pytest.fixture(scope="module")
def bf16_ranks(tmp_path_factory, dist_case):
    """One start of two gloo ranks for both distributed checks: the bf16
    EP model's step (checks.ep_model_rank) and the bf16 DP step
    (checks.dp_step_rank), each rank's result."""
    pg, sd, ep_np, _one = dist_case
    spec = spec_for(pg, batch_size=4)
    calls = [(checks.ep_model_rank, (DIST_KW, sd, ep_np, EP_LR)),
             (checks.dp_step_rank, (DIST_KW, sd, pg, spec, 4, 1e-4))]
    res = run_ranks(checks.calls_rank, S, (calls,), device="cpu",
                    timeout_s=120, join_timeout_s=300,
                    workdir=str(tmp_path_factory.mktemp("bf16_ranks")))
    return {"ep": [r[0] for r in res], "dp": [r[1] for r in res],
            "spec": spec}


def _grads_close(label, got, want):
    """Each gradient within GRAD_LIMIT of its own scale, floor GRAD_FLOOR
    of the largest (the module docstring's model bound)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst, worst_name = 0.0, None
    for n, w in want.items():
        g = torch.zeros_like(w) if got[n] is None else got[n]
        assert bool(torch.isfinite(g).all()), (label, n)
        rel = float((g - w).abs().max()) / max(float(w.abs().max()),
                                               GRAD_FLOOR * top, 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    print(f"{label}: worst gradient {worst:.3e} of scale ({worst_name}; "
          f"limit {GRAD_LIMIT})")
    assert worst <= GRAD_LIMIT, label


def test_ep_bf16_two_ranks_matches_one_device(dist_case, bf16_ranks):
    """The edge-partitioned bf16 model (K3's bf16 plain versions on each
    rank's shard, the combine in f32) against the one-device bf16 model on
    the same batch with TCSR metadata: the predictions, every averaged
    gradient and the SGD update, on both ranks."""
    _pg, sd, _ep_np, one = dist_case
    model = FragNetFineTune(**DIST_KW)
    model.load_state_dict(sd)
    model.eval()
    b = to_device(one, "cpu")
    pred = model(b)
    loss = mse_loss(pred, b.y, b.graph_mask)
    loss.backward()
    want = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            for n, p in model.named_parameters()}
    pred = pred.detach()
    scale = float(pred.abs().max())
    for r, res in enumerate(bf16_ranks["ep"]):
        d = float((res["pred"] - pred).abs().max()) / scale
        print(f"EP bf16 rank {r}: prediction {d:.3e} of scale (limit "
              f"{PRED_LIMIT}); loss {res['loss']:.6f} / "
              f"{float(loss.detach()):.6f}")
        assert d <= PRED_LIMIT
        _grads_close(f"EP bf16 rank {r}", res["grads"], want)
        update = {n: res["params"][n] - sd[n] for n in want}
        _grads_close(f"EP bf16 rank {r} update", update,
                     {n: -EP_LR * g for n, g in want.items()})


def test_dp_bf16_two_ranks_matches_one_device(dist_case, bf16_ranks):
    """The data-parallel bf16 step's averaged gradients against the mean of
    the one-device bf16 gradients of its two micro-batches (the first
    window's round-robin split), on both ranks; the loss finite."""
    pg, sd, _ep_np, _one = dist_case
    spec = bf16_ranks["spec"]
    win = DPBatchLoader(pg, 4, S, spec).windows()[0]
    mean = {}
    for r in range(S):
        m_r = FragNetFineTune(**DIST_KW)
        m_r.load_state_dict(sd)
        m_r.eval()
        b_r = to_device(stack_for_dp(win, S, spec, r), "cpu")
        mse_loss(m_r(b_r), b_r.y, b_r.graph_mask).backward()
        for n, p in m_r.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            mean[n] = mean.get(n, 0) + g / S
    for r, res in enumerate(bf16_ranks["dp"]):
        assert np.isfinite(res["loss"])
        _grads_close(f"DP bf16 rank {r}", res["grads"], mean)
