"""The port's dense-attr GAT pass (ops/dense_gat.py, the plain versions of
K7-K9) on the CPU against fragnet_tpu's ``dense_attr_gat_pass`` with its
Pallas kernels interpreted: forward and summed attention, with and without
self-loops; gradients w.r.t. node features, edge attrs and the attention
vector against ``jax.vjp``; the plain backward (K8 + K9 plain) against
autograd of the plain forward; and an adjacency given as the first tn rows
of an R = 6 planes tensor (a strided view) against the same adjacency made
contiguous. Shapes of tests/test_dense_gat.py::TestDenseAttrKernel: tn 16,
3 tiles, H 4, D 8, Da 12, te 16; one real edge masked. Inputs are made with
numpy from a seed and handed to both. Tolerance: atol = rtol = 1e-5 in f32
(the two frameworks sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.ops.dense_gat import dense_attr_gat_pass as jax_attr_pass
from fragnet_tpu.ops.tcsr import build_tile_meta as jax_tile_meta

from fragnet_tpu_torch.ops import dense_gat
from fragnet_tpu_torch.ops.dense_gat import build_dense_planes
from fragnet_tpu_torch.ops.tcsr import build_tile_meta

TOL = dict(atol=1e-5, rtol=1e-5)
tn, n_tiles, H, D, Da, te, E = 16, 3, 4, 8, 12, 16, 160
N = tn * n_tiles


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _case(seed):
    """Tile-local edges sorted by dst (no repeated pair), one real edge
    masked, padded to E; numpy inputs and both packages' metadata."""
    rng = np.random.default_rng(seed)
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
    meta_j = jax_tile_meta(src, dst, mask, N, tn=tn, te=te)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    meta = dataclasses.replace(
        meta, **{f: torch.from_numpy(getattr(meta, f))
                 for f in ("ew_blk", "sw_tile", "flat_slot", "cw")})
    adj = build_dense_planes(src, dst, mask, np.zeros((E, 0), np.float32), N,
                             tn=tn)
    assert meta_j is not None and adj is not None
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(src=src, dst=dst, mask=mask, meta_j=meta_j, meta=meta,
                adj=adj, nf=draw(N, H, D), ea=draw(E, Da),
                a=draw(H, 2 * D + Da), g=draw(N, H, D))


def _port_pass(c, nf, ea, a, self_loops, adj=None, attn=False):
    t = torch.from_numpy
    return dense_gat.dense_attr_gat_pass(
        nf, ea, t(c["src"]), t(c["dst"]), t(c["mask"]), a,
        t(c["adj"]) if adj is None else adj, c["meta"],
        self_loops=self_loops, return_attention=attn)


@pytest.mark.parametrize("self_loops", [False, True])
def test_plain_pass_matches_pallas_interpret(self_loops):
    c = _case(0)
    out_j, attn_j = jax_attr_pass(
        *(jnp.asarray(c[k]) for k in ("nf", "ea", "src", "dst", "mask", "a",
                                      "adj")),
        c["meta_j"], self_loops=self_loops, interpret=True)
    t = torch.from_numpy
    n0 = dense_gat.KERNEL_ATTR.launches
    out_p, attn_p = _port_pass(c, t(c["nf"]), t(c["ea"]), t(c["a"]),
                               self_loops, attn=True)
    assert dense_gat.KERNEL_ATTR.launches == n0  # CPU tensors: plain version
    _close(out_p, out_j)
    _close(attn_p, attn_j)
    out_n, attn_n = _port_pass(c, t(c["nf"]), t(c["ea"]), t(c["a"]),
                               self_loops)
    assert attn_n is None and torch.equal(out_n, out_p)


@pytest.mark.parametrize("self_loops", [False, True])
def test_pass_gradients_match_pallas_vjp(self_loops):
    c = _case(1)
    ints = tuple(jnp.asarray(c[k]) for k in ("src", "dst", "mask"))

    def f(nf_, ea_, a_):
        return jax_attr_pass(nf_, ea_, *ints, a_, jnp.asarray(c["adj"]),
                             c["meta_j"], self_loops=self_loops,
                             interpret=True)

    (out_j, attn_j), vjp = jax.vjp(
        f, *(jnp.asarray(c[k]) for k in ("nf", "ea", "a")))
    grads_j = vjp((jnp.asarray(c["g"]), jnp.zeros_like(attn_j)))
    t = torch.from_numpy
    xs = [t(c[k]).requires_grad_() for k in ("nf", "ea", "a")]
    out_p, _ = _port_pass(c, *xs, self_loops)
    grads_p = torch.autograd.grad((out_p * t(c["g"])).sum(), xs)
    _close(out_p, out_j)
    for gp, gj in zip(grads_p, grads_j):
        _close(gp, gj)


@pytest.mark.parametrize("self_loops", [False, True])
def test_plain_bwd_and_emit_are_autograd_of_plain_fwd(self_loops):
    """K8's and K9's plain versions (with the self-loop terms joined as
    DenseAttrGatFn joins them) against autograd of K7's plain version, with
    respect to wd, ws, nf and w_ea; the masked edge and the padding edges
    get exactly 0."""
    c = _case(2)
    rng = np.random.default_rng(3)
    t = torch.from_numpy
    xs = [t(rng.standard_normal(s).astype(np.float32)).requires_grad_()
          for s in ((N, H), (N, H), (N, H * D), (E, H))]
    ints = (t(c["src"]), t(c["dst"]), t(c["mask"]), c["meta"])
    adj = t(c["adj"])
    g = t(c["g"]).reshape(N, H * D)
    out, m, den = dense_gat.dense_attr_fwd_plain(adj, *xs, *ints, self_loops)
    want = torch.autograd.grad((out * g).sum(), xs)
    s = (g.view(N, H, D) * out.detach().view(N, H, D)).sum(-1)
    d_wd, d_ws, d_wself, d_nf, dz = dense_gat.dense_attr_bwd_plain(
        adj, *(x.detach() for x in xs), *ints, m.detach(), den.detach(), g,
        s, self_loops)
    if not self_loops:
        assert float(d_wself.abs().max()) == 0.0
    d_wea = dense_gat.dense_attr_emit_plain(dz, *ints)
    got = (d_wd + d_wself, d_ws + d_wself, d_nf, d_wea)
    for k, w in zip(got, want):
        _close(k, w)
    assert float(d_wea[t(c["mask"]) == 0].abs().max()) == 0.0
    # the planes are 0 off the adjacency
    off = (adj == 0).repeat(1, H, 1)
    assert float(dz[off].abs().max()) == 0.0


@pytest.mark.parametrize("self_loops", [False, True])
def test_bwd_cpu_route_is_the_plain_pair_and_matches_pallas_vjp(self_loops):
    """``dense_attr_bwd`` on CPU tensors (the kernel's function: K8 with the
    emit folded in) returns the plain backward's four gradients and the
    plain emit of its d_zpre planes, bit for bit, with no launch; its d_wea
    (and d_nf with the prologue's terms) match jax.vjp of the JAX package's
    interpret-mode Pallas op (op_bwd: the attr backward, the emit and the
    flat_slot gather) with respect to w_ea and nf; the masked edge and the
    padding edges get exactly 0."""
    from fragnet_tpu.ops.dense_gat import _make_attr_op

    c = _case(6)
    rng = np.random.default_rng(7)
    w_ea = rng.standard_normal((E, H)).astype(np.float32)
    a2 = np.concatenate([c["a"][:, :D], c["a"][:, D + Da:]], axis=-1)
    mj = c["meta_j"]
    op = _make_attr_op(N, E, tn, te, mj.n_chunks, H, D, self_loops, 0.2,
                       "float32", True)
    j = jnp.asarray
    rest = (j(c["adj"]), j(a2), j(c["src"]), j(c["dst"]), j(c["mask"]),
            jnp.zeros((1,), jnp.int32), j(mj.ew_blk), j(mj.flat_slot),
            j(mj.cw))
    (out_j, _m, _d), vjp = jax.vjp(lambda nf_, wea_: op(nf_, wea_, *rest),
                                   j(c["nf"]), j(w_ea))
    d_nf_j, d_wea_j = vjp((j(c["g"]), jnp.zeros_like(_m),
                           jnp.zeros_like(_d)))

    t = torch.from_numpy
    nf = t(c["nf"]).reshape(N, H * D)
    a_dst, a_src = t(c["a"][:, :D]), t(c["a"][:, D + Da:])
    wd = torch.einsum("nhd,hd->nh", t(c["nf"]), a_dst)
    ws = torch.einsum("nhd,hd->nh", t(c["nf"]), a_src)
    ints = (t(c["src"]), t(c["dst"]), t(c["mask"]), c["meta"])
    adj = t(c["adj"])
    out, m, den = dense_gat.dense_attr_fwd(adj, wd, ws, nf, t(w_ea), *ints,
                                           self_loops)
    _close(out.view(N, H, D), out_j)
    g = t(c["g"]).reshape(N, H * D)
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    bargs = (adj, wd, ws, nf, t(w_ea), *ints, m, den, g, s, self_loops)
    n0 = dense_gat.KERNEL_ATTR_BWD.launches
    got = dense_gat.dense_attr_bwd(*bargs)
    assert dense_gat.KERNEL_ATTR_BWD.launches == n0  # the plain versions
    *grads, dz = dense_gat.dense_attr_bwd_plain(*bargs)
    want = (*grads, dense_gat.dense_attr_emit_plain(dz, *ints))
    for k, w in zip(got, want):
        assert torch.equal(k, w)
    d_wd, d_ws, d_wself, d_nf, d_wea = got
    _close(d_wea, d_wea_j)
    if self_loops:
        d_wd, d_ws = d_wd + d_wself, d_ws + d_wself
    d_nf = (d_nf.view(N, H, D) + d_wd[..., None] * a_dst
            + d_ws[..., None] * a_src)
    _close(d_nf, d_nf_j)
    assert float(d_wea[t(c["mask"]) == 0].abs().max()) == 0.0


def test_strided_adjacency_equals_contiguous():
    """The fconn level reads its adjacency as ``dp_fc[:, :tn, :]`` of the
    R = 6 planes: a view with tile stride 7·tn·tn. Forward, attention and
    gradients equal those of the same adjacency made contiguous."""
    c = _case(4)
    rng = np.random.default_rng(5)
    ea6 = rng.standard_normal((E, 6)).astype(np.float32)
    planes = torch.from_numpy(build_dense_planes(
        c["src"], c["dst"], c["mask"], ea6, N, tn=tn))
    view = planes[:, :tn, :]
    assert not view.is_contiguous() and view.stride(0) == 7 * tn * tn
    assert np.array_equal(view.numpy(), c["adj"])
    t = torch.from_numpy
    res = []
    for adj in (view, view.contiguous()):
        xs = [t(c[k]).requires_grad_() for k in ("nf", "ea", "a")]
        out, attn = _port_pass(c, *xs, False, adj=adj, attn=True)
        grads = torch.autograd.grad((out * t(c["g"])).sum(), xs)
        res.append((out, attn) + grads)
    for a, b in zip(*res):
        assert torch.equal(a, b)
