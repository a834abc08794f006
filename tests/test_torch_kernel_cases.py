"""The plain versions of the TCSR kernels and the dense kernels against the
JAX package's Pallas kernels (interpret mode, on the CPU), on the seeded
graphs of tests/torch_kernel_cases.py: an empty destination row, a row of
64+ in-edges, edge windows that start with the previous tile's edges,
edges unsorted by destination within a tile, sources reaching other tiles
(TCSR source windows of k_src > 1) with repeated (dst, src) pairs, a
source or plane column with edges into rows of every slice; tn in {32,
128, 256} and H in {1, 4, 8}. The dense-attr kernels' plain versions (K7
forward, K8 backward, K9 emit, and the K8 wrapper's CPU route, which
gives the emit's output) are held on the tile-local cases, with and
without self-loops. The same cases hold the CUDA kernels against
these plain versions on the card (tests/test_torch_cuda_kernels.py).
Inputs are made with numpy from a seed and handed to both; the kernels'
raw inputs and outputs are compared (TCSR forward: out, m, den; dense
forward: out, m, den; dense backward: d_wd, d_ws, d_nf, d_vc; dense-attr
forward: out, m, den; dense-attr backward: d_wd, d_ws, d_wself, d_nf and
the d_zpre planes; emit: d_wea), and the
TCSR backward through the whole pass: the gradients of the port's
tcsr_gat_pass (plain kernels, the prologue by autograd) against jax.vjp of
the Pallas pass. Tolerance: atol = rtol = 1e-5 in f32 (the two sum in
different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.ops.dense_gat import _build as jax_dense_build
from fragnet_tpu.ops.dense_gat import _build_attr as jax_attr_build
from fragnet_tpu.ops.dense_gat import _pick_g
from fragnet_tpu.ops.pallas_gat import _build as jax_tcsr_build
from fragnet_tpu.ops.pallas_gat import pallas_gat_pass
from fragnet_tpu.ops.tcsr import build_tile_meta as jax_tile_meta

from fragnet_tpu_torch.ops import dense_gat, tcsr_gat
from fragnet_tpu_torch.ops.dense_gat import build_dense_planes
from fragnet_tpu_torch.ops.tcsr import build_tile_meta
from torch_kernel_cases import kernel_case

TOL = dict(atol=1e-5, rtol=1e-5)
TE, D, SLOPE = 64, 8, 0.2
SHAPES = [(32, 8), (128, 4), (256, 1)]  # (tn, H)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("tn,H", SHAPES)
def test_tcsr_fwd_plain_matches_pallas_on_cases(tn, H, self_loops):
    case = kernel_case(tn + H, tn)
    N, E = case.n_nodes, len(case.src)
    rng = np.random.default_rng(tn * H)
    wn, nf, w_ea = _draw(rng, N, 2 * H), _draw(rng, N, H * D), _draw(rng, E, H)
    mj = jax_tile_meta(case.src, case.dst, case.mask, N, tn=tn, te=TE)
    fwd, _bwd = jax_tcsr_build(N, E, H, D, 1, tn, TE, mj.k_src, mj.n_chunks,
                               self_loops, SLOPE, "float32", True)
    k = mj.k_src + 1
    want = fwd(np.zeros((1,), np.int32), jnp.asarray(mj.ew_blk),
               jnp.asarray(mj.sw_tile), jnp.asarray(mj.cw),
               *[jnp.asarray(wn)] * k, *[jnp.asarray(nf)] * k,
               jnp.asarray(w_ea), jnp.asarray(case.src.reshape(E, 1)),
               jnp.asarray(case.dst.reshape(E, 1)),
               jnp.asarray(case.mask.reshape(E, 1)))
    meta = build_tile_meta(case.src, case.dst, case.mask, N, tn=tn, te=TE)
    t = torch.from_numpy
    meta = dataclasses.replace(meta, ew_blk=t(meta.ew_blk), cw=t(meta.cw))
    n0 = tcsr_gat.KERNEL.launches
    got = tcsr_gat.tcsr_gat_fwd(t(wn), t(nf), t(w_ea), t(case.src),
                                t(case.dst), t(case.mask), meta, self_loops,
                                SLOPE)
    assert tcsr_gat.KERNEL.launches == n0  # CPU tensors: the plain version
    for g, w in zip(got, want):
        _close(g, w)
    kept = np.bincount(case.dst[case.mask > 0], minlength=N)
    assert kept[case.empty_row] == 0 and kept[case.hub_row] >= min(64, tn)
    assert meta.ew_blk[1] * TE < np.nonzero(case.dst // tn == 1)[0].min()
    if not self_loops:
        out, m, den = got
        assert float(out[case.empty_row].abs().max()) == 0.0
        assert float(den[case.empty_row].abs().max()) == 0.0
        assert bool((m[case.empty_row] == -1e30).all())


@pytest.mark.parametrize("tn,H,R", [(32, 8, 1), (128, 4, 6), (256, 1, 1)])
def test_dense_bwd_plain_matches_pallas_on_cases(tn, H, R):
    case = kernel_case(tn + R, tn, tile_local=True)
    N, E = case.n_nodes, len(case.src)
    rng = np.random.default_rng(tn + H + R)
    planes = build_dense_planes(case.src, case.dst, case.mask,
                                _draw(rng, E, R), N, tn=tn)
    assert planes is not None
    wd, ws, nf = _draw(rng, N, H), _draw(rng, N, H), _draw(rng, N, H * D)
    vc = _draw(rng, R + 1, H)
    g = _draw(rng, N, H * D)
    fwd, bwd = jax_dense_build(N, tn, H, D, R, _pick_g(N // tn, tn, R), SLOPE,
                               "float32", True)
    wsT = np.zeros((8, N), np.float32)
    wsT[:H] = ws.T
    vc8 = np.zeros((8, 128), np.float32)
    vc8[:R + 1, :H] = vc
    out_j, m_j, den_j = fwd(planes, wd, wsT, nf, vc8)
    s_j = np.einsum("nhd,nhd->nh", g.reshape(N, H, D),
                    np.asarray(out_j).reshape(N, H, D))
    d_wd, d_wsT, d_nf, d_vc = bwd(planes, wd, wsT, nf, vc8, m_j, den_j, g,
                                  s_j)
    want = (d_wd, np.asarray(d_wsT)[:H].T, d_nf,
            np.asarray(d_vc).sum(0)[:R + 1, :H])

    t = torch.from_numpy
    args = (t(planes), t(wd), t(ws), t(nf), t(vc))
    out, m, den = dense_gat.dense_gat_fwd(*args, SLOPE)
    for p, j in zip((out, m, den), (out_j, m_j, den_j)):
        _close(p, j)
    gt = t(g)
    s = (gt.view(N, H, D) * out.view(N, H, D)).sum(-1)
    n0 = dense_gat.KERNEL_BWD.launches
    got = dense_gat.dense_gat_bwd(*args, m, den, gt, s, SLOPE)
    assert dense_gat.KERNEL_BWD.launches == n0  # the plain version
    for p, j in zip(got, want):
        _close(p, j)
    adj = planes[0, :tn]
    assert adj[case.hub_row % tn].sum() >= min(64, tn)
    rows = np.nonzero(adj[:, case.hub_col])[0]
    assert len(set(rows // 16)) == tn // 16  # every 16-row slice


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("tn,H", SHAPES)
def test_tcsr_bwd_plain_matches_pallas_vjp_on_cases(tn, H, self_loops):
    """The TCSR backward's plain version (K2's), inside the port's pass on
    the CPU, against jax.vjp of the Pallas pass: out and the gradients
    w.r.t. the node features, the edge attrs and the attention vector for a
    seeded cotangent of out, on a graph whose source windows span several
    tiles."""
    case = kernel_case(tn + H + 1, tn)
    N, E, Da = case.n_nodes, len(case.src), 3
    rng = np.random.default_rng(tn * H + 2)
    nf, ea = _draw(rng, N, H, D), _draw(rng, E, Da)
    a, g = _draw(rng, H, 2 * D + Da), _draw(rng, N, H, D)
    mj = jax_tile_meta(case.src, case.dst, case.mask, N, tn=tn, te=TE)
    assert mj.k_src > 1
    idx = [jnp.asarray(x) for x in (case.src, case.dst, case.mask)]

    def jax_out(nf_, ea_, a_):
        return pallas_gat_pass(nf_, ea_, *idx, a_, mj, self_loops, SLOPE,
                               interpret=True)[0]

    out_j, vjp = jax.vjp(jax_out, jnp.asarray(nf), jnp.asarray(ea),
                         jnp.asarray(a))
    want = vjp(jnp.asarray(g))

    t = torch.from_numpy
    meta = build_tile_meta(case.src, case.dst, case.mask, N, tn=tn, te=TE)
    meta = dataclasses.replace(meta, ew_blk=t(meta.ew_blk), cw=t(meta.cw),
                               sw_tile=t(meta.sw_tile))
    xs = [t(x).requires_grad_() for x in (nf, ea, a)]
    n0 = tcsr_gat.KERNEL_BWD.launches
    out, _ = tcsr_gat.tcsr_gat_pass(xs[0], xs[1], t(case.src), t(case.dst),
                                    t(case.mask), xs[2], meta, self_loops,
                                    SLOPE)
    got = torch.autograd.grad((out * t(g)).sum(), xs)
    assert tcsr_gat.KERNEL_BWD.launches == n0  # CPU tensors: the plain version
    _close(out, out_j)
    for p, j in zip(got, want):
        _close(p, j)
    pairs = list(zip(case.dst[case.mask > 0], case.src[case.mask > 0]))
    assert len(set(pairs)) < len(pairs)  # repeated (dst, src) pairs


@pytest.mark.parametrize("R", [1, 6])
@pytest.mark.parametrize("tn,H", SHAPES)
def test_dense_fwd_plain_matches_pallas_on_cases(tn, H, R):
    """The dense forward's plain version (K4's) against the Pallas forward
    on tile-local cases: out, m, den, with the empty row's m = -1e30,
    den = 0, out = 0 and the hub row's 64+ nonzeros (32 at tn = 32)."""
    case = kernel_case(tn + H + R, tn, tile_local=True)
    N, E = case.n_nodes, len(case.src)
    rng = np.random.default_rng(tn + 10 * H + R)
    planes = build_dense_planes(case.src, case.dst, case.mask,
                                _draw(rng, E, R), N, tn=tn)
    assert planes is not None
    wd, ws, nf = _draw(rng, N, H), _draw(rng, N, H), _draw(rng, N, H * D)
    vc = _draw(rng, R + 1, H)
    fwd, _bwd = jax_dense_build(N, tn, H, D, R, _pick_g(N // tn, tn, R),
                                SLOPE, "float32", True)
    wsT = np.zeros((8, N), np.float32)
    wsT[:H] = ws.T
    vc8 = np.zeros((8, 128), np.float32)
    vc8[:R + 1, :H] = vc
    want = fwd(planes, wd, wsT, nf, vc8)

    t = torch.from_numpy
    n0 = dense_gat.KERNEL.launches
    got = dense_gat.dense_gat_fwd(t(planes), t(wd), t(ws), t(nf), t(vc),
                                  SLOPE)
    assert dense_gat.KERNEL.launches == n0  # CPU tensors: the plain version
    for p, j in zip(got, want):
        _close(p, j)
    out, m, den = got
    assert planes[0, case.hub_row % tn].sum() >= min(64, tn)
    assert float(out[case.empty_row].abs().max()) == 0.0
    assert float(den[case.empty_row].abs().max()) == 0.0
    assert bool((m[case.empty_row] == -1e30).all())


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("tn,H", SHAPES)
def test_dense_attr_plain_matches_pallas_on_cases(tn, H, self_loops):
    """The dense-attr plain versions (K7's forward, K8's backward, K9's
    emit) against the JAX package's Pallas attr kernels, interpreted, on a
    tile-local case: the adjacency plane of the kept edges, a window that
    starts in the tile before, edges shuffled within the tile, an empty
    row, a hub row of 64+ nonzeros (32 at tn = 32), a column with edges
    into every 8-row slice and masked edges; the backward gets each
    package's own forward state and s = Σ_d g·out."""
    case = kernel_case(tn + H + 7, tn, tile_local=True, hub_step=7)
    N, E = case.n_nodes, len(case.src)
    rng = np.random.default_rng(tn + H + 3 * self_loops)
    adj = build_dense_planes(case.src, case.dst, case.mask,
                             np.zeros((E, 0), np.float32), N, tn=tn)
    assert adj is not None
    wd, ws, nf = _draw(rng, N, H), _draw(rng, N, H), _draw(rng, N, H * D)
    w_ea, g = _draw(rng, E, H), _draw(rng, N, H * D)
    mj = jax_tile_meta(case.src, case.dst, case.mask, N, tn=tn, te=TE)
    fwd, bwd, emit = jax_attr_build(N, E, tn, TE, mj.n_chunks, H, D,
                                    self_loops, SLOPE, "float32", True)
    wsT = np.zeros((8, N), np.float32)
    wsT[:H] = ws.T
    lead = (np.zeros((1,), np.int32), jnp.asarray(mj.ew_blk),
            jnp.asarray(mj.cw))
    edges = tuple(jnp.asarray(x.reshape(E, 1))
                  for x in (case.src, case.dst, case.mask))
    out_j, m_j, den_j = fwd(*lead, adj, wd, wsT, ws, nf, w_ea, *edges)
    s_j = np.einsum("nhd,nhd->nh", g.reshape(N, H, D),
                    np.asarray(out_j).reshape(N, H, D))
    d_wd, d_wsT, d_wself, d_nf, dz = bwd(*lead, adj, wd, wsT, ws, nf, w_ea,
                                         *edges, m_j, den_j, g, s_j)
    d_wea = (np.asarray(emit(*lead, dz, *edges)).reshape(-1, H)[mj.flat_slot]
             * case.mask[:, None])
    want_bwd = (d_wd, np.asarray(d_wsT)[:H].T, d_wself, d_nf, dz)

    t = torch.from_numpy
    meta = build_tile_meta(case.src, case.dst, case.mask, N, tn=tn, te=TE)
    meta = dataclasses.replace(meta, ew_blk=t(meta.ew_blk), cw=t(meta.cw))
    ints = (t(case.src), t(case.dst), t(case.mask))
    args = (t(adj), t(wd), t(ws), t(nf), t(w_ea)) + ints + (meta,)
    n0 = (dense_gat.KERNEL_ATTR.launches, dense_gat.KERNEL_ATTR_BWD.launches)
    out, m, den = dense_gat.dense_attr_fwd(*args, self_loops, SLOPE)
    for p, j in zip((out, m, den), (out_j, m_j, den_j)):
        _close(p, j)
    gt = t(g)
    s = (gt.view(N, H, D) * out.view(N, H, D)).sum(-1)
    bargs = args + (m, den, gt, s, self_loops, SLOPE)
    got = dense_gat.dense_attr_bwd_plain(*bargs)
    for p, j in zip(got, want_bwd):
        _close(p, j)
    _close(dense_gat.dense_attr_emit_plain(got[4], *ints, meta), d_wea)
    # the wrapper's CPU route: the four gradients and the emitted d_wea
    fused = dense_gat.dense_attr_bwd(*bargs)
    for p, j in zip(fused, want_bwd[:4] + (d_wea,)):
        _close(p, j)
    assert (dense_gat.KERNEL_ATTR.launches,
            dense_gat.KERNEL_ATTR_BWD.launches) == n0  # the plain versions
    a0 = adj[0]
    assert a0[case.hub_row % tn].sum() >= min(64, tn)
    rows = np.nonzero(a0[:, case.hub_col])[0]
    assert len(set(rows // 8)) == tn // 8  # every 8-row slice
    assert a0[case.empty_row].sum() == 0
    assert meta.ew_blk[1] * TE < np.nonzero(case.dst // tn == 1)[0].min()
    assert (case.mask[:np.count_nonzero(case.dst)] == 0).any()
    if not self_loops:
        assert float(out[case.empty_row].abs().max()) == 0.0
        assert bool((m[case.empty_row] == -1e30).all())
