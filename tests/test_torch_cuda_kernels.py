"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run on a machine
with an H100 (no JAX needed there, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs are random tile-local graphs made with numpy from a seed, at the
esol model's head shapes (H = 4, D = 32) and both node tiles the batcher
uses (128, 256); the backward kernels also get sources outside the
destination tile (TCSR) and an empty tile. The TCSR kernels (K1 forward,
K2 backward, and K2's edge-partitioned entry point for K3 on both shards)
and the dense kernels (K4 forward, K5 backward) are also held on the
seeded cases of tests/torch_kernel_cases.py at tn 32, 128, 256 and H 1, 4,
8, and must give the same bits twice (they sum in a fixed order, with no
atomics). Tolerance: the GAT kernels sum in another order than the plain
versions, so outputs agree to f32 rounding: |k - p| ≤ 1e-4 · max|p|. The
plane builder adds at most one value per slot
on tile-local graphs without repeated pairs, so it is held to equality.
The dense-attr kernels (K7-K9) are checked at every node tile their
wrappers take (32, 64, 128, 256), with and without self-loops, on
adjacency planes that are contiguous or the first tn rows of R = 6 planes
(the fconn level's strided view), on random graphs and on the seeded
tile-local cases at H 1, 4, 8 (K7 and K8 twice, to equal bits); K8's
per-head dot is pinned to torch's order by an exact cancellation.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fragnet_tpu_torch.ops import dense_gat, tcsr_gat
from fragnet_tpu_torch.ops.tcsr import build_tile_meta
from torch_kernel_cases import kernel_case

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
    """Besides bad layouts, types and tiles: K7 and K8 read the adjacency
    rows and nf (K8 also g) in float4 and K8 sums a head's D/4 lanes by
    shuffles, so D not a multiple of 4, H*D > 256, D/4 not a power of two
    (K8) and an nf that is not 16-byte aligned are refused, with no
    fallback."""
    rng = np.random.default_rng(61)
    args = _attr_case(cuda, rng, 64, False)
    with pytest.raises(ValueError):  # a transposed adjacency
        dense_gat.dense_attr_fwd(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):  # int64 indices
        dense_gat.dense_attr_fwd(*args[:5], args[5].long(), *args[6:])
    meta96 = dataclasses.replace(args[8], tn=96)
    with pytest.raises(ValueError):  # no kernel for tn = 96
        dense_gat.dense_attr_fwd(*args[:8], meta96, False)

    adj = args[0]
    N, E = adj.shape[0] * adj.shape[1], args[4].shape[0]
    z = lambda *shape: torch.zeros(shape, device=cuda)

    def fwd(H, D, nf=None):
        nf = z(N, H * D) if nf is None else nf
        return dense_gat.dense_attr_fwd(adj, z(N, H), z(N, H), nf, z(E, H),
                                        *args[5:9], False)

    def bwd(H, D, nf=None):
        nf = z(N, H * D) if nf is None else nf
        return dense_gat.dense_attr_bwd(adj, z(N, H), z(N, H), nf, z(E, H),
                                        *args[5:9], z(N, H), z(N, H),
                                        z(N, H * D), z(N, H), False)

    fwd(4, 32)  # taken
    fwd(2, 12)  # taken: the forward sums no dot
    bwd(4, 32)  # taken
    for H, D in ((4, 6), (8, 64)):
        with pytest.raises(ValueError, match="unsupported"):
            fwd(H, D)
    for H, D in ((4, 6), (2, 12), (8, 64)):
        with pytest.raises(ValueError, match="unsupported"):
            bwd(H, D)
    odd = torch.zeros(N * 128 + 1, device=cuda)[1:].view(N, 128)
    for call in (fwd, bwd):
        with pytest.raises(ValueError, match="aligned"):
            call(4, 32, nf=odd)


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


# --------------------------------------------------------------------------
# the row-sliced forward TCSR kernel (K1) and the two-role dense backward
# (K5) on the seeded cases of tests/torch_kernel_cases.py; both sum in a
# fixed order, so a second call gives the same bits
# --------------------------------------------------------------------------

def _case_tensors(cuda, case, tn, te):
    meta = build_tile_meta(case.src, case.dst, case.mask, case.n_nodes,
                           tn=tn, te=te)
    assert meta is not None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                                 sw_tile=T(meta.sw_tile),
                                 flat_slot=T(meta.flat_slot))
    return T, meta_t


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("H", [1, 4, 8])
@pytest.mark.parametrize("tn", [32, 128, 256])
def test_tcsr_gat_fwd_matches_plain_on_cases(cuda, tn, H, self_loops):
    case = kernel_case(tn + H, tn)
    T, meta = _case_tensors(cuda, case, tn, 64)
    N, E, D = case.n_nodes, len(case.src), 32
    rng = np.random.default_rng(70 + tn + H)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    args = (draw(N, 2 * H), draw(N, H * D), draw(E, H), T(case.src),
            T(case.dst), T(case.mask), meta, self_loops)
    n0 = tcsr_gat.KERNEL.launches
    got = tcsr_gat.tcsr_gat_fwd(*args)
    again = tcsr_gat.tcsr_gat_fwd(*args)
    torch.cuda.synchronize()
    assert tcsr_gat.KERNEL.launches == n0 + 2
    out_p, m_p, den_p = tcsr_gat.tcsr_gat_fwd_plain(*args)
    _close(got[0], out_p)
    _close(got[2], den_p)
    _close_m(got[1], m_p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if not self_loops:
        out, m, den = got
        assert float(out[case.empty_row].abs().max()) == 0.0
        assert float(den[case.empty_row].abs().max()) == 0.0
        assert bool((m[case.empty_row] == -1e30).all())


@pytest.mark.parametrize("R", [1, 6])
@pytest.mark.parametrize("H", [1, 4, 8])
@pytest.mark.parametrize("tn", [32, 128, 256])
def test_dense_gat_bwd_matches_plain_on_cases(cuda, tn, H, R):
    case = kernel_case(tn + R, tn, tile_local=True)
    N, E, D = case.n_nodes, len(case.src), 32
    rng = np.random.default_rng(80 + tn + H + R)
    planes = dense_gat.build_dense_planes(
        case.src, case.dst, case.mask,
        rng.standard_normal((E, R)).astype(np.float32), N, tn=tn)
    assert planes is not None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    args = (T(planes), draw(N, H), draw(N, H), draw(N, H * D), draw(R + 1, H))
    out, m, den = dense_gat.dense_gat_fwd_plain(*args)
    g = draw(N, H * D)
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    n0 = dense_gat.KERNEL_BWD.launches
    got = dense_gat.dense_gat_bwd(*args, m, den, g, s)
    again = dense_gat.dense_gat_bwd(*args, m, den, g, s)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_BWD.launches == n0 + 2
    want = dense_gat.dense_gat_bwd_plain(*args, m, den, g, s)
    for k, p in zip(got, want):
        _close(k, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_row_sliced_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """K1 and K4 read nf in float4 with a block per 8 rows, K2 and K5 read
    nf and g in float4 and sum a head's D/4 lanes by shuffles: D not a
    multiple of 4, a tile not a multiple of 8 rows, H*D > 256, D/4 not a
    power of two and an nf or g not 16-byte aligned are refused, with no
    fallback."""
    case = kernel_case(1, 32)
    T, meta = _case_tensors(cuda, case, 32, 64)
    N, E = case.n_nodes, len(case.src)
    ints = (T(case.src), T(case.dst), T(case.mask))

    def fwd(H, D, meta_=meta, nf=None):
        nf = torch.zeros((N, H * D), device=cuda) if nf is None else nf
        return tcsr_gat.tcsr_gat_fwd(torch.zeros((N, 2 * H), device=cuda),
                                     nf, torch.zeros((E, H), device=cuda),
                                     *ints, meta_, False)

    fwd(4, 32)  # taken
    with pytest.raises(ValueError, match="multiple of 4"):
        fwd(4, 6)
    with pytest.raises(ValueError, match="H\\*D <= 256"):
        fwd(8, 64)
    with pytest.raises(ValueError, match="aligned"):
        fwd(4, 32, nf=torch.zeros(N * 128 + 1, device=cuda)[1:].view(N, 128))
    meta20 = dataclasses.replace(
        build_tile_meta(np.zeros(40, np.int32), np.zeros(40, np.int32),
                        np.zeros(40, np.float32), 40, tn=20, te=20),
        ew_blk=torch.zeros(2, dtype=torch.int32, device=cuda),
        cw=torch.ones(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="tn=20"):
        tcsr_gat.tcsr_gat_fwd(torch.zeros((40, 8), device=cuda),
                              torch.zeros((40, 128), device=cuda),
                              torch.zeros((40, 4), device=cuda),
                              *(t[:40] for t in ints), meta20, False)

    tn = 32

    def bwd(H, D, nf=None):
        planes = torch.zeros((1, 2 * tn, tn), device=cuda)
        z = lambda *shape: torch.zeros(shape, device=cuda)
        nf = z(tn, H * D) if nf is None else nf
        return dense_gat.dense_gat_bwd(planes, z(tn, H), z(tn, H), nf,
                                       z(2, H), z(tn, H), z(tn, H),
                                       z(tn, H * D), z(tn, H))

    bwd(4, 32)  # taken
    for H, D in ((4, 6), (2, 12), (8, 64)):
        with pytest.raises(ValueError, match="unsupported"):
            bwd(H, D)
    with pytest.raises(ValueError, match="aligned"):
        bwd(4, 32, nf=torch.zeros(tn * 128 + 1, device=cuda)[1:].view(tn, 128))

    def dfwd(H, D, nf=None):
        planes = torch.zeros((1, 2 * tn, tn), device=cuda)
        z = lambda *shape: torch.zeros(shape, device=cuda)
        nf = z(tn, H * D) if nf is None else nf
        return dense_gat.dense_gat_fwd(planes, z(tn, H), z(tn, H), nf,
                                       z(2, H))

    dfwd(4, 32)  # taken
    for H, D in ((4, 6), (8, 64)):  # K4: D a multiple of 4, H*D <= 256
        with pytest.raises(ValueError, match="unsupported"):
            dfwd(H, D)
    with pytest.raises(ValueError, match="aligned"):
        dfwd(4, 32, nf=torch.zeros(tn * 128 + 1, device=cuda)[1:].view(tn, 128))

    def tbwd(H, D, g=None):
        z = lambda *shape: torch.zeros(shape, device=cuda)
        g = z(N, H * D) if g is None else g
        return tcsr_gat.tcsr_gat_bwd(z(N, 2 * H), z(N, H * D), z(E, H),
                                     *ints, meta, z(N, H), z(N, H), g,
                                     z(N, H), False)

    tbwd(4, 32)  # taken
    for H, D in ((4, 6), (2, 12), (8, 64)):  # K2 as K5
        with pytest.raises(ValueError, match="unsupported"):
            tbwd(H, D)
    with pytest.raises(ValueError, match="aligned"):
        tbwd(4, 32, g=torch.zeros(N * 128 + 1, device=cuda)[1:].view(N, 128))


@pytest.mark.parametrize("H,D", [(4, 32), (8, 32), (2, 8)])
def test_dense_gat_bwd_cancels_exactly_with_one_neighbour(cuda, H, D):
    """A row with one neighbour has P = 1 and out = nf[j], so its d_zpre =
    g·nf[j] − s is 0 in exact arithmetic. With s summed in the kernel's
    order (dense_gat.head_dot) it is 0 on the card too: d_wd, d_ws and d_vc
    are exactly 0, not round-off, while d_nf = g[i] at j."""
    rng = np.random.default_rng(90 + H + D)
    tn, n_tiles, R = 128, 2, 1
    N = tn * n_tiles
    src = np.concatenate([t * tn + rng.permutation(tn)
                          for t in range(n_tiles)]).astype(np.int32)
    dst = np.arange(N, dtype=np.int32)
    mask = np.ones(N, np.float32)
    planes = dense_gat.build_dense_planes(
        src, dst, mask, rng.standard_normal((N, R)).astype(np.float32), N,
        tn=tn)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    args = (T(planes), draw(N, H), draw(N, H), draw(N, H * D), draw(R + 1, H))
    out, m, den = dense_gat.dense_gat_fwd(*args)
    g = draw(N, H * D)
    d_wd, d_ws, d_nf, d_vc = dense_gat.dense_gat_bwd(
        *args, m, den, g, dense_gat.head_dot(g, out, H))
    torch.cuda.synchronize()
    for k in (d_wd, d_ws, d_vc):
        assert float(k.abs().max()) == 0.0
    assert torch.equal(out, args[3][T(src).long()])
    _close(d_nf[T(src).long()], g)


# --------------------------------------------------------------------------
# the row-sliced dense forward (K4) and the two-role TCSR backward (K2, and
# its edge-partitioned entry point for K3) on the seeded cases; both sum in
# a fixed order, so a second call gives the same bits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 6])
@pytest.mark.parametrize("H", [1, 4, 8])
@pytest.mark.parametrize("tn", [32, 128, 256])
def test_dense_gat_fwd_matches_plain_on_cases(cuda, tn, H, R):
    case = kernel_case(tn + H + R, tn, tile_local=True)
    N, E, D = case.n_nodes, len(case.src), 32
    rng = np.random.default_rng(100 + tn + H + R)
    planes = dense_gat.build_dense_planes(
        case.src, case.dst, case.mask,
        rng.standard_normal((E, R)).astype(np.float32), N, tn=tn)
    assert planes is not None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    args = (T(planes), draw(N, H), draw(N, H), draw(N, H * D), draw(R + 1, H))
    n0 = dense_gat.KERNEL.launches
    got = dense_gat.dense_gat_fwd(*args)
    again = dense_gat.dense_gat_fwd(*args)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL.launches == n0 + 2
    out_p, m_p, den_p = dense_gat.dense_gat_fwd_plain(*args)
    _close(got[0], out_p)
    _close(got[2], den_p)
    _close_m(got[1], m_p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    out, m, den = got
    assert planes[0, case.hub_row % tn].sum() >= min(64, tn)
    assert float(out[case.empty_row].abs().max()) == 0.0
    assert float(den[case.empty_row].abs().max()) == 0.0
    assert bool((m[case.empty_row] == -1e30).all())


@pytest.mark.parametrize("H,D", [(4, 64), (8, 32)])
def test_dense_gat_fwd_takes_rows_the_first_port_refused(cuda, H, D):
    """tn = 256 with H*D = 256: the first port staged the tile's nf in
    shared memory (tn·H·D·4 B = 256 KiB > 227 KiB) and its wrapper refused
    the call; the row-sliced kernel reads nf rows from global memory."""
    tn, R = 256, 1
    case = kernel_case(tn + H, tn, tile_local=True)
    N, E = case.n_nodes, len(case.src)
    rng = np.random.default_rng(110 + H)
    planes = dense_gat.build_dense_planes(
        case.src, case.dst, case.mask,
        rng.standard_normal((E, R)).astype(np.float32), N, tn=tn)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    args = (T(planes), draw(N, H), draw(N, H), draw(N, H * D), draw(R + 1, H))
    assert 4 * tn * H * D > 232448
    got = dense_gat.dense_gat_fwd(*args)
    want = dense_gat.dense_gat_fwd_plain(*args)
    _close(got[0], want[0])
    _close(got[2], want[2])
    _close_m(got[1], want[1])


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("H", [1, 4, 8])
@pytest.mark.parametrize("tn", [32, 128, 256])
def test_tcsr_gat_bwd_matches_plain_on_cases(cuda, tn, H, self_loops):
    """K2 on graphs whose source windows span several tiles (k_src > 1),
    whose windows start with the previous tile's edges, with repeated
    (dst, src) pairs and a source with edges into every slice; masked and
    padding edges get exactly 0."""
    case = kernel_case(tn + H, tn)
    T, meta = _case_tensors(cuda, case, tn, 64)
    assert meta.k_src > 1
    N, E, D = case.n_nodes, len(case.src), 32
    rng = np.random.default_rng(120 + tn + H)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    args = (draw(N, 2 * H), draw(N, H * D), draw(E, H), T(case.src),
            T(case.dst), T(case.mask), meta)
    out, m, den = tcsr_gat.tcsr_gat_fwd_plain(*args, self_loops)
    g = draw(N, H * D)
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    bargs = args + (m, den, g, s, self_loops)
    n0 = tcsr_gat.KERNEL_BWD.launches
    got = tcsr_gat.tcsr_gat_bwd(*bargs)
    again = tcsr_gat.tcsr_gat_bwd(*bargs)
    torch.cuda.synchronize()
    assert tcsr_gat.KERNEL_BWD.launches == n0 + 2
    want = tcsr_gat.tcsr_gat_bwd_plain(*bargs)
    for k, p in zip(got, want):
        _close(k, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert float(got[2][T(case.mask) == 0].abs().max()) == 0.0


@pytest.mark.parametrize("H", [1, 4, 8])
@pytest.mark.parametrize("tn", [32, 128, 256])
def test_tcsr_gat_ep_bwd_matches_plain_on_cases(cuda, tn, H):
    """K3's backward (K2's edge-partitioned entry point) on each of two
    edge shards of a seeded case: the shard's grid from tile t0, sources
    anywhere in the batch, the whole d_wn and d_nf written (0 outside the
    shard's reach)."""
    from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta

    case = kernel_case(tn + H + 5, tn)
    N, E, D, S = case.n_nodes, len(case.src), 32, 2
    meta = build_ep_tile_meta(case.src, case.dst, case.mask, N, S, tn=tn,
                              te=32)
    assert meta is not None
    meta = dataclasses.replace(meta, **{
        f: torch.from_numpy(getattr(meta, f)).to(cuda)
        for f in ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")})
    rng = np.random.default_rng(130 + tn + H)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    wn, nf = draw(N, 2 * H), draw(N, H * D)
    Es, Ng = E // S, meta.n_tiles_grid * tn
    for r in range(S):
        sl = slice(r * Es, (r + 1) * Es)
        mask = T(case.mask[sl])
        args = (wn, nf, draw(Es, H), T(case.src[sl]), T(case.dst[sl]), mask,
                meta, r)
        m = tcsr_gat.tcsr_gat_ep_fwd_plain(*args)[1]
        m = torch.where(m <= -1e29, torch.zeros_like(m), m)
        bargs = args + (m, draw(Ng, H * D), draw(Ng, H))
        got = tcsr_gat.tcsr_gat_ep_bwd(*bargs)
        again = tcsr_gat.tcsr_gat_ep_bwd(*bargs)
        torch.cuda.synchronize()
        want = tcsr_gat.tcsr_gat_ep_bwd_plain(*bargs)
        for k, p in zip(got, want):
            _close(k, p)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        assert float(got[2][mask == 0].abs().max()) == 0.0


@pytest.mark.parametrize("H,D", [(4, 32), (8, 16), (2, 64)])
def test_tcsr_gat_bwd_cancels_exactly_with_one_neighbour(cuda, H, D):
    """A row with one kept in-edge has p = 1 and out = nf[src], so its
    d_zpre = g·nf[src] − s is 0 in exact arithmetic. K2 sums the dot in the
    order in which torch sums s = (g·out).sum(-1) on the card (D ≤ 64), so
    it is 0 on the card too, through the single-device entry point and
    through K3's with s = −dV as the edge-partitioned pass's autograd
    computes it: d_wn and d_w_ea exactly 0, while d_nf[src] = g[dst]."""
    from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta

    rng = np.random.default_rng(140 + H + D)
    tn, n_tiles, te, S = 128, 2, 64, 2
    N = tn * n_tiles
    src = np.concatenate([t * tn + rng.permutation(tn)
                          for t in range(n_tiles)]).astype(np.int32)
    dst = np.arange(N, dtype=np.int32)
    mask = np.ones(N, np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    meta = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                               sw_tile=T(meta.sw_tile),
                               flat_slot=T(meta.flat_slot))
    wn, nf, w_ea, g = draw(N, 2 * H), draw(N, H * D), draw(N, H), draw(N, H * D)
    ints = (T(src), T(dst), T(mask))
    out, m, den = tcsr_gat.tcsr_gat_fwd(wn, nf, w_ea, *ints, meta, False)
    assert torch.equal(out, nf[ints[0].long()])
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    d_wn, d_nf, d_w_ea = tcsr_gat.tcsr_gat_bwd(wn, nf, w_ea, *ints, meta, m,
                                               den, g, s, False)
    torch.cuda.synchronize()
    for k in (d_wn, d_w_ea):
        assert float(k.abs().max()) == 0.0
    _close(d_nf[ints[0].long()], g)

    emeta = build_ep_tile_meta(src, dst, mask, N, S, tn=tn, te=te)
    emeta = dataclasses.replace(emeta, **{
        f: T(getattr(emeta, f))
        for f in ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")})
    Es, Ng = N // S, emeta.n_tiles_grid * tn
    for r in range(S):
        sl = slice(r * Es, (r + 1) * Es)
        args = (wn, nf, w_ea[sl], *(t[sl] for t in ints), emeta, r)
        out_l, m_l, _den_l = tcsr_gat.tcsr_gat_ep_fwd(*args)
        m_l = torch.where(m_l <= -1e29, torch.zeros_like(m_l), m_l)
        r0 = int(emeta.t0[r, 0]) * tn
        dU = g[r0:r0 + Ng].contiguous()
        dV = -(dU.view(Ng, H, D) * out_l.view(Ng, H, D)).sum(-1)
        d_wn, _d_nf, d_w_ea = tcsr_gat.tcsr_gat_ep_bwd(*args, m_l, dU, dV)
        torch.cuda.synchronize()
        for k in (d_wn, d_w_ea):
            assert float(k.abs().max()) == 0.0


# --------------------------------------------------------------------------
# the row-sliced dense-attr kernels (K7 forward, K8 backward with its row
# and column roles) and the emit (K9) on the seeded tile-local cases; K7
# and K8 sum in a fixed order with no atomics, so a second call gives the
# same bits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("H", [1, 4, 8])
@pytest.mark.parametrize("tn", [32, 64, 128, 256])
def test_dense_attr_kernels_match_plain_on_cases(cuda, tn, H, self_loops):
    """K7, K8 and K9 on a case with an empty row, a hub row of 64+ nonzeros
    (a tile of 32 or 64 holds fewer: K7's rescaled chunks of 32), a column
    with edges into every 8-row slice, a window that starts in the tile
    before, edges shuffled within the tile and masked edges; at tn = 128
    the adjacency is the first tn rows of R = 6 planes (the fconn level's
    strided view). Every output within 1e-4 of its scale, the same bits
    from a second call, and the emit exactly."""
    case = kernel_case(tn + H + 11, tn, tile_local=True, hub_step=7)
    T_, meta = _case_tensors(cuda, case, tn, 64)
    N, E, D = case.n_nodes, len(case.src), 32
    rng = np.random.default_rng(150 + tn + H + self_loops)
    R = 6 if tn == 128 else 0
    planes = dense_gat.build_dense_planes(
        case.src, case.dst, case.mask,
        rng.standard_normal((E, R)).astype(np.float32), N, tn=tn)
    assert planes is not None
    adj = T_(planes)[:, :tn, :]
    draw = lambda *shape: T_(rng.standard_normal(shape).astype(np.float32))
    args = (adj, draw(N, H), draw(N, H), draw(N, H * D), draw(E, H),
            T_(case.src), T_(case.dst), T_(case.mask), meta, self_loops)
    n0 = dense_gat.KERNEL_ATTR.launches
    got = dense_gat.dense_attr_fwd(*args)
    again = dense_gat.dense_attr_fwd(*args)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_ATTR.launches == n0 + 2
    out_p, m_p, den_p = dense_gat.dense_attr_fwd_plain(*args)
    _close(got[0], out_p)
    _close(got[2], den_p)
    _close_m(got[1], m_p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    out, m, den = got
    if not self_loops:
        assert float(out[case.empty_row].abs().max()) == 0.0
        assert bool((m[case.empty_row] == -1e30).all())

    g = draw(N, H * D)
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    bargs = args[:9] + (m, den, g, s, self_loops)
    n0 = dense_gat.KERNEL_ATTR_BWD.launches
    got = dense_gat.dense_attr_bwd(*bargs)
    again = dense_gat.dense_attr_bwd(*bargs)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_ATTR_BWD.launches == n0 + 2
    want = dense_gat.dense_attr_bwd_plain(*bargs)
    for k, p in zip(got, want):
        _close(k, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    eargs = (got[4],) + args[5:9]
    d_wea = dense_gat.dense_attr_emit(*eargs)
    assert torch.equal(d_wea, dense_gat.dense_attr_emit_plain(*eargs))
    assert float(d_wea[args[7] == 0].abs().max()) == 0.0
    a0 = planes[0, :tn]
    assert a0[case.hub_row % tn].sum() >= min(64, tn)
    assert len(set(np.nonzero(a0[:, case.hub_col])[0] // 8)) == tn // 8


@pytest.mark.parametrize("H,D", [(8, 16), (4, 32), (2, 64)])
def test_dense_attr_bwd_cancels_exactly_with_one_neighbour(cuda, H, D):
    """Frag-like rows: one neighbour each, no self-loop. K7 divides, so
    out = nf[j] bit for bit and P = 1; K8 sums its per-head dot in the order
    in which torch sums DenseAttrGatFn's s = (g·out).sum(-1) on the card,
    so d_zpre = g·nf[j] − s is exactly 0, as the math says: the d_zpre
    planes and, through DenseAttrGatFn, the gradients of wd, ws and w_ea
    are exactly 0 (not round-off), while nf's gradient is g[i] at j."""
    rng = np.random.default_rng(160 + H + D)
    tn, n_tiles, te = 128, 2, 64
    N = tn * n_tiles
    src = np.concatenate([t * tn + rng.permutation(tn)
                          for t in range(n_tiles)]).astype(np.int32)
    dst = np.arange(N, dtype=np.int32)
    mask = np.ones(N, np.float32)
    planes = dense_gat.build_dense_planes(
        src, dst, mask, np.zeros((N, 0), np.float32), N, tn=tn)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    meta = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw),
                               sw_tile=T(meta.sw_tile),
                               flat_slot=T(meta.flat_slot))
    draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    ints = (T(src), T(dst), T(mask))
    xs = [t.requires_grad_() for t in (draw(N, H), draw(N, H),
                                       draw(N, H * D), draw(N, H))]
    g = draw(N, H * D)
    out, m, den = dense_gat.DenseAttrGatFn.apply(T(planes), *xs, *ints, meta,
                                                 False, 0.2)
    assert torch.equal(out, xs[2][ints[0].long()])
    d_wd, d_ws, d_nf, d_wea = torch.autograd.grad((out * g).sum(), xs)
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    dz = dense_gat.dense_attr_bwd(T(planes), *(x.detach() for x in xs),
                                  *ints, meta, m, den, g, s, False)[4]
    torch.cuda.synchronize()
    for k in (d_wd, d_ws, d_wea, dz):
        assert float(k.abs().max()) == 0.0
    _close(d_nf[ints[0].long()], g)
