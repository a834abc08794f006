"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run on a machine
with an H100 (no JAX needed there, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs are random tile-local graphs made with numpy from a seed, at the
esol model's head shapes (H = 4, D = 32) and both node tiles the batcher
uses (128, 256); the backward kernels also get sources outside the
destination tile (TCSR) and an empty tile. Tolerance: the GAT kernels sum
in another order than the plain versions (with atomics, in an order that
varies from run to run), so outputs agree to f32 rounding:
|k - p| ≤ 1e-4 · max|p|. The plane builder adds at most one value per slot
on tile-local graphs without repeated pairs, so it is held to equality.
The dense-attr kernels (K7-K9) are checked at every node tile their
wrappers take (32, 64, 128, 256), with and without self-loops, on
adjacency planes that are contiguous or the first tn rows of R = 6 planes
(the fconn level's strided view).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fragnet_tpu_torch.ops import dense_gat, tcsr_gat
from fragnet_tpu_torch.ops.tcsr import build_tile_meta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(rng, tn, n_tiles, deg, te, empty_tile=None, cross=False):
    """Tile-local edges sorted by dst, padded to a multiple of te; with
    ``cross`` every third edge takes its source from the next tile."""
    src, dst = [], []
    N = n_tiles * tn
    for t in range(n_tiles):
        if t == empty_tile:
            continue
        seen = set()
        for _ in range(deg * tn):
            i, j = (int(x) for x in rng.integers(0, tn, 2))
            if (i, j) not in seen:
                seen.add((i, j))
                off = tn if cross and len(src) % 3 == 0 else 0
                src.append((t * tn + j + off) % N)
                dst.append(t * tn + i)
    order = np.argsort(dst, kind="stable")
    n = len(order)
    E = ((n + te - 1) // te + 1) * te
    s = np.zeros(E, np.int32)
    d = np.zeros(E, np.int32)
    m = np.zeros(E, np.float32)
    s[:n] = np.array(src)[order]
    d[:n] = np.array(dst)[order]
    m[:n] = 1.0
    return s, d, m


def _close(k, p):
    k, p = k.float().cpu(), p.float().cpu()
    scale = float(p.abs().max())
    assert torch.isfinite(k).all()
    assert float((k - p).abs().max()) <= 1e-4 * max(scale, 1e-30)


def _close_m(k, p):
    """m: the −1e30 empty-row marker must agree exactly, the rest closely."""
    k, p = k.cpu(), p.cpu()
    empty = p <= -1e29
    assert torch.equal(k <= -1e29, empty)
    _close(k[~empty], p[~empty])


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("self_loops", [False, True])
def test_tcsr_gat_fwd_matches_plain(cuda, tn, self_loops):
    rng = np.random.default_rng(tn + self_loops)
    H, D, te, n_tiles = 4, 32, 256, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, te, empty_tile=1)
    N = n_tiles * tn
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    assert meta is not None
    E = len(src)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    wn = T(rng.standard_normal((N, 2 * H)).astype(np.float32))
    nf = T(rng.standard_normal((N, H * D)).astype(np.float32))
    w_ea = T(rng.standard_normal((E, H)).astype(np.float32))
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                                 sw_tile=T(meta.sw_tile),
                                 flat_slot=T(meta.flat_slot))
    args = (wn, nf, w_ea, T(src), T(dst), T(mask), meta_t, self_loops)
    n0 = tcsr_gat.KERNEL.launches
    out, m, den = tcsr_gat.tcsr_gat_fwd(*args)
    torch.cuda.synchronize()
    assert tcsr_gat.KERNEL.launches == n0 + 1
    out_p, m_p, den_p = tcsr_gat.tcsr_gat_fwd_plain(*args)
    _close(out, out_p)
    _close(den, den_p)
    _close_m(m, m_p)
    if not self_loops:  # the empty tile: m = -1e30, den = 0, out = 0
        assert float(out[tn:2 * tn].abs().max()) == 0.0
        assert float(den[tn:2 * tn].abs().max()) == 0.0
        assert bool((m[tn:2 * tn] == -1e30).all())


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("R", [1, 6])
def test_dense_gat_fwd_matches_plain(cuda, tn, R):
    rng = np.random.default_rng(tn + R)
    H, D, n_tiles = 4, 32, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, 32, empty_tile=2)
    N = n_tiles * tn
    ea = rng.standard_normal((len(src), R)).astype(np.float32)
    planes = dense_gat.build_dense_planes(src, dst, mask, ea, N, tn=tn)
    assert planes is not None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    args = (T(planes), T(rng.standard_normal((N, H)).astype(np.float32)),
            T(rng.standard_normal((N, H)).astype(np.float32)),
            T(rng.standard_normal((N, H * D)).astype(np.float32)),
            T(rng.standard_normal((R + 1, H)).astype(np.float32)))
    n0 = dense_gat.KERNEL.launches
    out, m, den = dense_gat.dense_gat_fwd(*args)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL.launches == n0 + 1
    out_p, m_p, den_p = dense_gat.dense_gat_fwd_plain(*args)
    _close(out, out_p)
    _close(den, den_p)
    _close_m(m, m_p)
    assert float(out[2 * tn:].abs().max()) == 0.0


def _tcsr_case(cuda, rng, tn, self_loops):
    H, D, te, n_tiles = 4, 32, 256, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, te, empty_tile=1,
                            cross=True)
    mask[3] = 0.0  # one masked real edge
    N = n_tiles * tn
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    assert meta is not None and meta.k_src > 1
    E = len(src)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    wn = T(rng.standard_normal((N, 2 * H)).astype(np.float32))
    nf = T(rng.standard_normal((N, H * D)).astype(np.float32))
    w_ea = T(rng.standard_normal((E, H)).astype(np.float32))
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                                 sw_tile=T(meta.sw_tile),
                                 flat_slot=T(meta.flat_slot))
    return (wn, nf, w_ea, T(src), T(dst), T(mask), meta_t, self_loops)


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("self_loops", [False, True])
def test_tcsr_gat_bwd_matches_plain(cuda, tn, self_loops):
    rng = np.random.default_rng(10 + tn + self_loops)
    args = _tcsr_case(cuda, rng, tn, self_loops)
    wn, nf = args[0], args[1]
    N, HD = nf.shape
    H = wn.shape[1] // 2
    out, m, den = tcsr_gat.tcsr_gat_fwd(*args)
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32)
                         ).to(cuda)
    s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
    n0 = tcsr_gat.KERNEL_BWD.launches
    got = tcsr_gat.tcsr_gat_bwd(*args[:7], m, den, g, s, self_loops)
    torch.cuda.synchronize()
    assert tcsr_gat.KERNEL_BWD.launches == n0 + 1
    want = tcsr_gat.tcsr_gat_bwd_plain(*args[:7], m, den, g, s, self_loops)
    for k, p in zip(got, want):
        _close(k, p)
    d_w_ea = got[2]
    assert float(d_w_ea[args[5] == 0].abs().max()) == 0.0  # masked edges
    if not self_loops:  # the empty tile gets nothing as a destination
        assert float(got[0][tn:2 * tn, :H].abs().max()) == 0.0


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("R", [1, 6])
def test_dense_gat_bwd_matches_plain(cuda, tn, R):
    rng = np.random.default_rng(20 + tn + R)
    H, D, n_tiles = 4, 32, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, 32, empty_tile=2)
    N = n_tiles * tn
    ea = rng.standard_normal((len(src), R)).astype(np.float32)
    planes = dense_gat.build_dense_planes(src, dst, mask, ea, N, tn=tn)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    args = (T(planes), T(rng.standard_normal((N, H)).astype(np.float32)),
            T(rng.standard_normal((N, H)).astype(np.float32)),
            T(rng.standard_normal((N, H * D)).astype(np.float32)),
            T(rng.standard_normal((R + 1, H)).astype(np.float32)))
    out, m, den = dense_gat.dense_gat_fwd(*args)
    g = T(rng.standard_normal((N, H * D)).astype(np.float32))
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    n0 = dense_gat.KERNEL_BWD.launches
    got = dense_gat.dense_gat_bwd(*args, m, den, g, s)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_BWD.launches == n0 + 1
    want = dense_gat.dense_gat_bwd_plain(*args, m, den, g, s)
    for k, p in zip(got, want):
        _close(k, p)
    for k in got[:3]:  # the empty tile
        assert float(k[2 * tn:].abs().max()) == 0.0


def test_tcsr_pass_gradients_match_cpu(cuda):
    """The TCSR autograd boundary on the card against the same Function on
    the CPU (plain versions): gradients w.r.t. wn, nf and w_ea."""
    rng = np.random.default_rng(7)
    args = _tcsr_case(cuda, rng, 128, True)
    N, HD = args[1].shape
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32))

    def run(dev):
        xs = [t.detach().to(dev).requires_grad_() for t in args[:3]]
        src, dst, mask = (t.to(dev) for t in args[3:6])
        meta = dataclasses.replace(args[6], **{
            f: getattr(args[6], f).to(dev)
            for f in ("ew_blk", "cw", "sw_tile", "flat_slot")})
        out = tcsr_gat.TcsrGatFn.apply(*xs, src, dst, mask, meta, True, 0.2)
        return torch.autograd.grad((out[0] * g.to(dev)).sum(), xs)

    for k, p in zip(run(cuda), run(torch.device("cpu"))):
        _close(k, p)


def test_wrappers_refuse_bad_inputs(cuda):
    N, H, D, R, tn = 128, 4, 32, 1, 128
    planes = torch.zeros((1, (R + 1) * tn, tn), device=cuda)
    wd = torch.zeros((N, H), device=cuda)
    nf = torch.zeros((N, H * D), device=cuda)
    vc = torch.zeros((R + 1, H), device=cuda)
    with pytest.raises(ValueError):
        dense_gat.dense_gat_fwd(planes, wd, wd.double(), nf, vc)
    with pytest.raises(ValueError):
        dense_gat.dense_gat_fwd(planes, wd, wd, nf.t(), vc)
    with pytest.raises(ValueError):  # s of the wrong shape
        dense_gat.dense_gat_bwd(planes, wd, wd, nf, vc, wd, wd, nf, nf)


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("R", [0, 1, 6])
def test_dense_planes_matches_plain_and_host(cuda, tn, R):
    """The plane builder (K6) equals its plain version and the host builder
    exactly, on a tile-local graph with an empty tile and a masked edge;
    TCSR windows from build_tile_meta."""
    rng = np.random.default_rng(30 + tn + R)
    te, n_tiles = 256, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, te, empty_tile=1)
    mask[5] = 0.0
    N = n_tiles * tn
    ea = rng.standard_normal((len(src), R)).astype(np.float32)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    host = dense_gat.build_dense_planes(src, dst, mask, ea, N, tn=tn)
    assert meta is not None and host is not None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                                 sw_tile=T(meta.sw_tile),
                                 flat_slot=T(meta.flat_slot))
    args = (T(src), T(dst), T(mask), T(ea) if R else None, N, meta_t)
    n0 = dense_gat.KERNEL_PLANES.launches
    got = dense_gat.build_dense_planes_device(*args)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_PLANES.launches == n0 + 1
    assert torch.equal(got, dense_gat.build_dense_planes_device_plain(*args))
    assert np.array_equal(got.cpu().numpy(), host)


def test_dense_planes_refuses_bad_inputs(cuda):
    from fragnet_tpu_torch.ops.tcsr import TileMeta

    E, tn = 256, 128
    i32 = torch.zeros(E, dtype=torch.int32, device=cuda)
    mask = torch.zeros(E, device=cuda)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    meta = TileMeta(ew_blk=one, sw_tile=one, flat_slot=i32, cw=one + 1,
                    tn=tn, te=256, n_chunks=1, k_src=1)
    with pytest.raises(ValueError):  # R = 2 has no kernel
        dense_gat.build_dense_planes_device(
            i32, i32, mask, torch.zeros((E, 2), device=cuda), tn, meta)
    with pytest.raises(ValueError):  # int64 indices
        dense_gat.build_dense_planes_device(i32.long(), i32, mask, None, tn,
                                            meta)


def test_packed_batch_decodes_on_the_card(cuda):
    """A packed buffer moved through pinned memory and decoded on the card
    equals its decode on the CPU, field by field (the planes by K6)."""
    from fragnet_tpu_torch.data import packing
    from fragnet_tpu_torch.graphs.batch import PackedUploader

    rng = np.random.default_rng(5)
    tn, te = 128, 256
    src, dst, mask = _graph(rng, tn, 2, 2, te)
    N, E = 2 * tn, len(src)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    ea = rng.standard_normal((E, 1)).astype(np.float32)
    layout = packing.PackLayout(
        entries=(packing.Entry("bg_src", packing.U16, 0, (E,), "int32"),
                 packing.Entry("bg_dst", packing.U16, 2048, (E,), "int32"),
                 packing.Entry("bg_mask", packing.I8, 4096, (E,), "float32"),
                 packing.Entry("ea_bonds", packing.F32, 5120, (E, 1),
                               "float32")),
        total_bytes=8192, aliases=(), recompute_x_frags=(0, 0),
        tm_static=(), dp_specs=())
    assert 2 * E <= 2048 and 4 * E <= 8192 - 5120
    buf = np.zeros(8192, np.uint8)
    for e, arr in zip(layout.entries, (src.astype(np.uint16),
                                       dst.astype(np.uint16),
                                       mask.astype(np.int8), ea)):
        raw = np.frombuffer(arr.tobytes(), np.uint8)
        buf[e.offset:e.offset + raw.size] = raw
    up = PackedUploader(cuda)
    for _ in range(PackedUploader.DEPTH + 1):  # a pinned buffer is reused
        dev_buf = up(buf)
        assert dev_buf.device.type == "cuda"
        got = [packing._decode(dev_buf, e).cpu() for e in layout.entries]
        want = [packing._decode(torch.from_numpy(buf), e)
                for e in layout.entries]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw))
    planes = dense_gat.build_dense_planes_device(
        *(packing._decode(dev_buf, e) for e in layout.entries), N, meta_t)
    assert np.array_equal(planes.cpu().numpy(), dense_gat.build_dense_planes(
        src, dst, mask, ea, N, tn=tn))


def _attr_case(cuda, rng, tn, self_loops, strided=False):
    """Dense-attr kernel inputs on a tile-local graph with an empty tile and
    a masked real edge: (adj, wd, ws, nf, w_ea, src, dst, emask, meta,
    self_loops)."""
    H, D, te, n_tiles = 4, 32, 256, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, te, empty_tile=1)
    mask[4] = 0.0
    N, E = n_tiles * tn, len(src)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    R = 6 if strided else 0
    planes = dense_gat.build_dense_planes(
        src, dst, mask, rng.standard_normal((E, R)).astype(np.float32), N,
        tn=tn)
    assert meta is not None and planes is not None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    adj = T(planes)[:, :tn, :]
    assert adj.is_contiguous() != strided
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                                 sw_tile=T(meta.sw_tile),
                                 flat_slot=T(meta.flat_slot))
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    return (adj, draw(N, H), draw(N, H), draw(N, H * D), draw(E, H), T(src),
            T(dst), T(mask), meta_t, self_loops)


@pytest.mark.parametrize("tn", [32, 64, 128, 256])
@pytest.mark.parametrize("self_loops", [False, True])
def test_dense_attr_fwd_matches_plain(cuda, tn, self_loops):
    rng = np.random.default_rng(40 + tn + self_loops)
    args = _attr_case(cuda, rng, tn, self_loops, strided=tn == 128)
    n0 = dense_gat.KERNEL_ATTR.launches
    out, m, den = dense_gat.dense_attr_fwd(*args)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_ATTR.launches == n0 + 1
    out_p, m_p, den_p = dense_gat.dense_attr_fwd_plain(*args)
    _close(out, out_p)
    _close(den, den_p)
    _close_m(m, m_p)
    if not self_loops:  # the empty tile: m = -1e30, den = 0, out = 0
        assert float(out[tn:2 * tn].abs().max()) == 0.0
        assert bool((m[tn:2 * tn] == -1e30).all())


@pytest.mark.parametrize("tn", [32, 64, 128, 256])
@pytest.mark.parametrize("self_loops", [False, True])
def test_dense_attr_bwd_and_emit_match_plain(cuda, tn, self_loops):
    """K8's five outputs (the d_zpre planes at every slot: both write 0 off
    the adjacency) and K9's per-edge gradient against the plain versions;
    the masked edge and the padding edges get exactly 0."""
    rng = np.random.default_rng(50 + tn + self_loops)
    args = _attr_case(cuda, rng, tn, self_loops, strided=tn == 128)
    nf = args[3]
    N, HD = nf.shape
    H = args[1].shape[1]
    out, m, den = dense_gat.dense_attr_fwd(*args)
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32)
                         ).to(cuda)
    s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
    bargs = args[:9] + (m, den, g, s, self_loops)
    n0 = dense_gat.KERNEL_ATTR_BWD.launches
    got = dense_gat.dense_attr_bwd(*bargs)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_ATTR_BWD.launches == n0 + 1
    want = dense_gat.dense_attr_bwd_plain(*bargs)
    for k, p in zip(got, want):
        _close(k, p)
    eargs = (want[4],) + args[5:9]
    n0 = dense_gat.KERNEL_ATTR_EMIT.launches
    d_wea = dense_gat.dense_attr_emit(*eargs)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_ATTR_EMIT.launches == n0 + 1
    assert torch.equal(d_wea, dense_gat.dense_attr_emit_plain(*eargs))
    assert float(d_wea[args[7] == 0].abs().max()) == 0.0


def test_dense_attr_pass_gradients_match_cpu(cuda):
    """DenseAttrGatFn on the card (K7, K8, K9) against the same Function on
    the CPU (plain versions), with self-loops, on the strided adjacency:
    out and the gradients w.r.t. wd, ws, nf and w_ea."""
    rng = np.random.default_rng(60)
    args = _attr_case(cuda, rng, 128, True, strided=True)
    N, HD = args[3].shape
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32))

    def run(dev):
        xs = [t.detach().to(dev).requires_grad_() for t in args[1:5]]
        adj = args[0].to(dev)
        src, dst, mask = (t.to(dev) for t in args[5:8])
        meta = dataclasses.replace(args[8], **{
            f: getattr(args[8], f).to(dev)
            for f in ("ew_blk", "cw", "sw_tile", "flat_slot")})
        out = dense_gat.DenseAttrGatFn.apply(adj, *xs, src, dst, mask, meta,
                                             True, 0.2)[0]
        grads = torch.autograd.grad((out * g.to(dev)).sum(), xs)
        return (out.detach(),) + grads

    for k, p in zip(run(cuda), run(torch.device("cpu"))):
        _close(k, p)


def test_dense_attr_wrappers_refuse_bad_inputs(cuda):
    rng = np.random.default_rng(61)
    args = _attr_case(cuda, rng, 64, False)
    with pytest.raises(ValueError):  # a transposed adjacency
        dense_gat.dense_attr_fwd(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):  # int64 indices
        dense_gat.dense_attr_fwd(*args[:5], args[5].long(), *args[6:])
    meta96 = dataclasses.replace(args[8], tn=96)
    with pytest.raises(ValueError):  # no kernel for tn = 96
        dense_gat.dense_attr_fwd(*args[:8], meta96, False)


def _ep_case(cuda, rng, tn, S=2):
    """A tile-local graph with sources across tiles, split into S edge
    shards with every shard's EPTileMeta (on the card), seeded node values
    and edge attrs, and for each shard the (rank, its edge arrays)."""
    from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta

    te = 256
    s, d, m = _graph(rng, tn, 6, 3, S * te, empty_tile=2, cross=True)
    N, H, D = 6 * tn, 4, 32
    meta = build_ep_tile_meta(s, d, m, N, S, tn=tn, te=te)
    assert meta is not None
    meta = dataclasses.replace(meta, **{
        f: torch.from_numpy(getattr(meta, f)).to(cuda)
        for f in ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")})

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)

    wn, nf = t(N, 2 * H), t(N, H * D)
    Es = len(s) // S
    shards = []
    for r in range(S):
        sl = slice(r * Es, (r + 1) * Es)
        shards.append((r, torch.from_numpy(s[sl]).to(cuda),
                       torch.from_numpy(d[sl]).to(cuda),
                       torch.from_numpy(m[sl]).to(cuda), t(Es, H)))
    return wn, nf, meta, shards


@pytest.mark.parametrize("tn", [128, 256])
def test_tcsr_gat_ep_fwd_and_bwd_match_plain(cuda, tn):
    """K3 on each of two shards: the forward's (out, m, den) on the grid
    rows, then the backward at m = the forward's max (0 on empty rows) and
    seeded cotangents dU, dV."""
    rng = np.random.default_rng(tn + 3)
    wn, nf, meta, shards = _ep_case(cuda, rng, tn)
    Ng = meta.n_tiles_grid * tn
    for r, s, d, m, w_ea in shards:
        args = (wn, nf, w_ea, s, d, m, meta, r)
        k = tcsr_gat.tcsr_gat_ep_fwd(*args)
        p = tcsr_gat.tcsr_gat_ep_fwd_plain(*args)
        assert tuple(k[0].shape) == (Ng, nf.shape[1])
        _close(k[0], p[0])
        _close_m(k[1], p[1])
        _close(k[2], p[2])
        mg = torch.where(p[1] <= -1e29, torch.zeros_like(p[1]), p[1])
        dU = torch.from_numpy(rng.standard_normal((Ng, nf.shape[1])).astype(
            np.float32)).to(cuda)
        dV = torch.from_numpy(rng.standard_normal(tuple(mg.shape)).astype(
            np.float32)).to(cuda)
        kb = tcsr_gat.tcsr_gat_ep_bwd(*args, mg, dU, dV)
        pb = tcsr_gat.tcsr_gat_ep_bwd_plain(*args, mg, dU, dV)
        for a, b in zip(kb, pb):
            _close(a, b)
        assert torch.equal(kb[2][m == 0], torch.zeros_like(kb[2][m == 0]))


def test_tcsr_gat_ep_wrappers_refuse_bad_inputs(cuda):
    rng = np.random.default_rng(7)
    wn, nf, meta, shards = _ep_case(cuda, rng, 128)
    r, s, d, m, w_ea = shards[0]
    with pytest.raises(ValueError, match="rank"):
        tcsr_gat.tcsr_gat_ep_fwd(wn, nf, w_ea, s, d, m, meta, 2)
    with pytest.raises(ValueError, match="dtype"):
        tcsr_gat.tcsr_gat_ep_fwd(wn, nf, w_ea, s.long(), d, m, meta, r)
    with pytest.raises(ValueError, match="contiguous"):
        tcsr_gat.tcsr_gat_ep_fwd(wn, nf.t().contiguous().t(), w_ea, s, d, m,
                                 meta, r)
