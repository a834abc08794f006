"""The port's device-side ops on the CPU against fragnet_tpu's: the segment
ops (ops/segment.py), the TCSR pass's plain version against
``pallas_gat_pass(..., interpret=True)`` and the dense pass's plain version
against ``dense_gat_pass(..., interpret=True)``. Inputs are made with numpy
from a seed and handed to both. Tolerance: atol = rtol = 1e-5 in f32 (the
two frameworks sum in different orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.ops import segment as jseg
from fragnet_tpu.ops.dense_gat import dense_gat_pass as jax_dense_pass
from fragnet_tpu.ops.pallas_gat import pallas_gat_pass
from fragnet_tpu.ops.tcsr import build_tile_meta as jax_tile_meta

from fragnet_tpu_torch.ops import dense_gat, segment, tcsr_gat
from fragnet_tpu_torch.ops.dense_gat import build_dense_planes
from fragnet_tpu_torch.ops.tcsr import build_tile_meta

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _segment_case(seed=0, E=64, N=12, H=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N - 3, E).astype(np.int32)  # last 3 segments empty
    mask = (rng.random(E) > 0.3).astype(np.float32)
    data = rng.standard_normal((E, H)).astype(np.float32)
    return ids, mask, data, N


@pytest.mark.parametrize("masked", [False, True])
def test_segment_ops_match(masked):
    ids, mask, data, N = _segment_case()
    m = mask if masked else None
    t = torch.from_numpy
    tm = t(mask) if masked else None
    _close(segment.segment_sum(t(data), t(ids), N, mask=tm),
           jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), N, mask=m))
    _close(segment.segment_max(t(data), t(ids), N, mask=tm),
           jseg.segment_max(jnp.asarray(data), jnp.asarray(ids), N, mask=m))
    _close(segment.segment_softmax(t(data), t(ids), N, mask=tm),
           jseg.segment_softmax(jnp.asarray(data), jnp.asarray(ids), N,
                                mask=m))


def test_gat_attention_pass_matches():
    rng = np.random.default_rng(1)
    N, E, H, D, Da = 10, 40, 4, 8, 6
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N - 2, E).astype(np.int32)
    mask = (rng.random(E) > 0.2).astype(np.float32)
    nf = rng.standard_normal((N, H, D)).astype(np.float32)
    ea = rng.standard_normal((E, H, Da)).astype(np.float32)
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    t = torch.from_numpy
    out_p, attn_p = segment.gat_attention_pass(t(nf), t(ea), t(src), t(dst),
                                               t(a), N, edge_mask=t(mask))
    out_j, attn_j = jseg.gat_attention_pass(
        jnp.asarray(nf), jnp.asarray(ea), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(a), N, edge_mask=jnp.asarray(mask))
    _close(out_p, out_j)
    _close(attn_p, attn_j)


def _tile_local_graph(rng, tn, n_tiles, E, lo=12, hi=40):
    """Tile-local edges sorted by dst, one empty tile, padded to E."""
    src_l, dst_l = [], []
    for t in range(n_tiles - 1):  # the last tile stays empty
        seen = set()
        for _ in range(int(rng.integers(lo, hi))):
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
    return src, dst, mask


@pytest.mark.parametrize("self_loops", [False, True])
def test_tcsr_plain_pass_matches_pallas_interpret(self_loops):
    rng = np.random.default_rng(2)
    tn, te, n_tiles, H, D, Da, E = 16, 16, 3, 4, 8, 12, 160
    N = tn * n_tiles
    src, dst, mask = _tile_local_graph(rng, tn, n_tiles, E)
    nf = rng.standard_normal((N, H, D)).astype(np.float32)
    ea = rng.standard_normal((E, Da)).astype(np.float32)
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    meta_j = jax_tile_meta(src, dst, mask, N, tn=tn, te=te)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    meta = dataclasses.replace(
        meta, **{f: torch.from_numpy(getattr(meta, f))
                 for f in ("ew_blk", "sw_tile", "flat_slot", "cw")})
    out_j, attn_j = pallas_gat_pass(
        jnp.asarray(nf), jnp.asarray(ea), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(mask), jnp.asarray(a), meta_j, self_loops=self_loops,
        interpret=True)
    t = torch.from_numpy
    n0 = tcsr_gat.KERNEL.launches
    out_p, attn_p = tcsr_gat.tcsr_gat_pass(
        t(nf), t(ea), t(src), t(dst), t(mask), t(a), meta,
        self_loops=self_loops, return_attention=True)
    assert tcsr_gat.KERNEL.launches == n0  # CPU tensors: plain version
    _close(out_p, out_j)
    _close(attn_p, attn_j)
    out_n, attn_n = tcsr_gat.tcsr_gat_pass(
        t(nf), t(ea), t(src), t(dst), t(mask), t(a), meta,
        self_loops=self_loops)
    assert attn_n is None
    assert torch.equal(out_n, out_p)


@pytest.mark.parametrize("R", [1, 6])
def test_dense_plain_pass_matches_pallas_interpret(R):
    rng = np.random.default_rng(3 + R)
    tn, n_tiles, H, D, Da, E = 16, 3, 4, 8, 8, 160
    N = tn * n_tiles
    src, dst, mask = _tile_local_graph(rng, tn, n_tiles, E, 10, 48)
    ea_raw = rng.standard_normal((E, R)).astype(np.float32)
    planes = build_dense_planes(src, dst, mask, ea_raw, N, tn=tn)
    assert planes is not None
    nf = rng.standard_normal((N, H, D)).astype(np.float32)
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    W = (rng.standard_normal((R, Da)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((Da,)) * 0.1).astype(np.float32)
    ea_emb = ea_raw @ W + b
    a_ea = a[:, D:D + Da]
    v = (W @ a_ea.T).astype(np.float32)
    c = (b @ a_ea.T).astype(np.float32)
    out_j, attn_j = jax_dense_pass(
        jnp.asarray(nf), jnp.asarray(planes), jnp.asarray(v), jnp.asarray(c),
        jnp.asarray(ea_emb), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(mask), jnp.asarray(a), interpret=True)
    t = torch.from_numpy
    n0 = dense_gat.KERNEL.launches
    out_p, attn_p = dense_gat.dense_gat_pass(
        t(nf), t(planes), t(v), t(c), t(ea_emb), t(src), t(dst), t(mask),
        t(a), return_attention=True)
    assert dense_gat.KERNEL.launches == n0
    _close(out_p, out_j)
    _close(attn_p, attn_j)
    assert float(out_p[2 * tn:].abs().max()) == 0.0  # the empty tile


# --------------------------------------------------------------------------
# backward: the autograd boundaries against jax.vjp of the Pallas passes
# (interpret mode), and each plain backward against autograd of its plain
# forward
# --------------------------------------------------------------------------

def _cross_tile_graph(rng, tn, n_tiles, E):
    """Edges sorted by dst whose sources reach into the next tile, so the
    TCSR source windows span two tiles (k_src = 2)."""
    src, dst = [], []
    for t in range(n_tiles - 1):
        for _ in range(int(rng.integers(12, 30))):
            dst.append(t * tn + int(rng.integers(0, tn)))
            src.append(t * tn + int(rng.integers(0, 2 * tn)))
    order = np.argsort(dst, kind="stable")
    s = np.zeros(E, np.int32)
    d = np.zeros(E, np.int32)
    m = np.zeros(E, np.float32)
    s[:len(order)] = np.array(src)[order]
    d[:len(order)] = np.array(dst)[order]
    m[:len(order)] = 1.0
    m[2] = 0.0  # a masked real edge
    return s, d, m


def _torch_meta(meta):
    return dataclasses.replace(
        meta, **{f: torch.from_numpy(getattr(meta, f))
                 for f in ("ew_blk", "sw_tile", "flat_slot", "cw")})


@pytest.mark.parametrize("case", ["local", "local-self-loops",
                                  "cross-tile-self-loops"])
def test_tcsr_pass_gradients_match_pallas_vjp(case):
    import jax

    rng = np.random.default_rng(11)
    self_loops = case.endswith("self-loops")
    tn, te, n_tiles, H, D, Da, E = 16, 16, 3, 4, 8, 12, 160
    N = tn * n_tiles
    if case.startswith("cross"):
        src, dst, mask = _cross_tile_graph(rng, tn, n_tiles, E)
    else:
        src, dst, mask = _tile_local_graph(rng, tn, n_tiles, E)
    nf = rng.standard_normal((N, H, D)).astype(np.float32)
    ea = rng.standard_normal((E, Da)).astype(np.float32)
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    g = rng.standard_normal((N, H, D)).astype(np.float32)
    meta_j = jax_tile_meta(src, dst, mask, N, tn=tn, te=te)
    assert meta_j.k_src == (2 if case.startswith("cross") else 1)
    meta = _torch_meta(build_tile_meta(src, dst, mask, N, tn=tn, te=te))

    def f(nf_, ea_, a_):
        return pallas_gat_pass(nf_, ea_, jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(mask), a_, meta_j,
                               self_loops=self_loops, interpret=True)

    (out_j, attn_j), vjp = jax.vjp(f, jnp.asarray(nf), jnp.asarray(ea),
                                   jnp.asarray(a))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(attn_j)))
    t = torch.from_numpy
    xs = [t(x).requires_grad_() for x in (nf, ea, a)]
    out_p, _ = tcsr_gat.tcsr_gat_pass(xs[0], xs[1], t(src), t(dst), t(mask),
                                      xs[2], meta, self_loops=self_loops)
    grads_p = torch.autograd.grad((out_p * t(g)).sum(), xs)
    _close(out_p, out_j)
    for gp, gj in zip(grads_p, grads_j):
        _close(gp, gj)


@pytest.mark.parametrize("R", [1, 6])
def test_dense_pass_gradients_match_pallas_vjp(R):
    import jax

    rng = np.random.default_rng(13 + R)
    tn, n_tiles, H, D, Da, E = 16, 3, 4, 8, 8, 160
    N = tn * n_tiles
    src, dst, mask = _tile_local_graph(rng, tn, n_tiles, E, 10, 48)
    planes = build_dense_planes(src, dst, mask,
                                rng.standard_normal((E, R)).astype(np.float32),
                                N, tn=tn)
    nf = rng.standard_normal((N, H, D)).astype(np.float32)
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    v = rng.standard_normal((R, H)).astype(np.float32)
    c = rng.standard_normal((H,)).astype(np.float32)
    ea_emb = rng.standard_normal((E, Da)).astype(np.float32)  # epilogue only
    g = rng.standard_normal((N, H, D)).astype(np.float32)

    def f(nf_, v_, c_, a_):
        return jax_dense_pass(nf_, jnp.asarray(planes), v_, c_,
                              jnp.asarray(ea_emb), jnp.asarray(src),
                              jnp.asarray(dst), jnp.asarray(mask), a_,
                              interpret=True)

    (out_j, attn_j), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (nf, v, c, a)))
    grads_j = vjp((jnp.asarray(g), jnp.zeros_like(attn_j)))
    t = torch.from_numpy
    xs = [t(x).requires_grad_() for x in (nf, v, c, a)]
    out_p, _ = dense_gat.dense_gat_pass(xs[0], t(planes), xs[1], xs[2],
                                        t(ea_emb), t(src), t(dst), t(mask),
                                        xs[3])
    grads_p = torch.autograd.grad((out_p * t(g)).sum(), xs)
    _close(out_p, out_j)
    for gp, gj in zip(grads_p, grads_j):
        _close(gp, gj)


@pytest.mark.parametrize("self_loops", [False, True])
def test_tcsr_plain_bwd_is_autograd_of_plain_fwd(self_loops):
    rng = np.random.default_rng(17)
    tn, te, n_tiles, H, D, E = 16, 16, 3, 4, 8, 160
    N = tn * n_tiles
    src, dst, mask = _cross_tile_graph(rng, tn, n_tiles, E)
    meta = _torch_meta(build_tile_meta(src, dst, mask, N, tn=tn, te=te))
    t = torch.from_numpy
    xs = [t(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
          for shape in ((N, 2 * H), (N, H * D), (E, H))]
    g = t(rng.standard_normal((N, H * D)).astype(np.float32))
    ints = (t(src), t(dst), t(mask), meta, self_loops)
    out, m, den = tcsr_gat.tcsr_gat_fwd_plain(*xs, *ints)
    want = torch.autograd.grad((out * g).sum(), xs)
    s = (g.view(N, H, D) * out.detach().view(N, H, D)).sum(-1)
    got = tcsr_gat.tcsr_gat_bwd(*(x.detach() for x in xs), *ints[:4],
                                m.detach(), den.detach(), g, s, self_loops)
    for k, w in zip(got, want):
        _close(k, w)
    assert float(got[2][t(mask) == 0].abs().max()) == 0.0


@pytest.mark.parametrize("R", [1, 6])
def test_dense_plain_bwd_is_autograd_of_plain_fwd(R):
    rng = np.random.default_rng(19 + R)
    tn, n_tiles, H, D, E = 16, 3, 4, 8, 160
    N = tn * n_tiles
    src, dst, mask = _tile_local_graph(rng, tn, n_tiles, E, 10, 48)
    t = torch.from_numpy
    planes = t(build_dense_planes(
        src, dst, mask, rng.standard_normal((E, R)).astype(np.float32), N,
        tn=tn))
    xs = [t(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
          for shape in ((N, H), (N, H), (N, H * D), (R + 1, H))]
    g = t(rng.standard_normal((N, H * D)).astype(np.float32))
    out, m, den = dense_gat.dense_gat_fwd_plain(planes, *xs)
    want = torch.autograd.grad((out * g).sum(), xs)
    s = (g.view(N, H, D) * out.detach().view(N, H, D)).sum(-1)
    got = dense_gat.dense_gat_bwd(planes, *(x.detach() for x in xs),
                                  m.detach(), den.detach(), g, s)
    for k, w in zip(got, want):
        _close(k, w)
    assert float(got[2][2 * tn:].abs().max()) == 0.0  # the empty tile


def test_attention_epilogues_carry_no_gradient():
    """The attention vectors are interpretability outputs built from
    detached tensors (the JAX package's stop_gradient); ``out`` keeps its
    gradient."""
    rng = np.random.default_rng(23)
    tn, te, n_tiles, H, D, Da, E = 16, 16, 3, 4, 8, 12, 160
    N = tn * n_tiles
    src, dst, mask = _tile_local_graph(rng, tn, n_tiles, E)
    meta = _torch_meta(build_tile_meta(src, dst, mask, N, tn=tn, te=te))
    t = torch.from_numpy
    nf = t(rng.standard_normal((N, H, D)).astype(np.float32)).requires_grad_()
    ea = t(rng.standard_normal((E, Da)).astype(np.float32)).requires_grad_()
    a = t(rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
          ).requires_grad_()
    out, attn = tcsr_gat.tcsr_gat_pass(nf, ea, t(src), t(dst), t(mask), a,
                                       meta, self_loops=True,
                                       return_attention=True)
    assert out.requires_grad and not attn.requires_grad
    planes = t(build_dense_planes(src, dst, mask,
                                  rng.standard_normal((E, 1)).astype(
                                      np.float32), N, tn=tn))
    v = t(np.ones((1, H), np.float32)).requires_grad_()
    c = t(np.zeros((H,), np.float32)).requires_grad_()
    out, attn = dense_gat.dense_gat_pass(nf, planes, v, c, ea, t(src),
                                         t(dst), t(mask), a,
                                         return_attention=True)
    assert out.requires_grad and not attn.requires_grad
