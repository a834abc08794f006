"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run on a machine
with an H100 (no JAX needed there, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs are random tile-local graphs made with numpy from a seed, at the
esol model's head shapes (H = 4, D = 32) and both node tiles the batcher
uses (128, 256), and K1 / K2 at v1 gat's padded bond shape (H = 3, D =
8); the backward kernels also get sources outside the
destination tile (TCSR) and an empty tile. The TCSR kernels (K1 forward,
K2 backward, and K2's edge-partitioned entry point for K3 on both shards)
and the dense kernels (K4 forward, K5 backward) are also held on the
seeded cases of tests/torch_kernel_cases.py at tn 32, 128, 256 and H 1, 4,
8, and must give the same bits twice (they sum in a fixed order, with no
atomics). Tolerance: the GAT kernels sum in another order than the plain
versions, so outputs agree to f32 rounding: |k - p| ≤ 1e-4 · max|p|. The
plane builder adds at most one value per slot
on tile-local graphs without repeated pairs, so it is held to equality
(at every tn and R, with cross-tile and masked edges, a cw = 0 tile,
windows that hold the tile before's edges and E not a multiple of te),
and sums a repeated pair within 1e-6.
The dense-attr kernels (K7, and K8 with the emit K9 folded in) are
checked at every node tile their wrappers take (32, 64, 128, 256), with
and without self-loops, on adjacency planes that are contiguous or the
first tn rows of R = 6 planes (the fconn level's strided view), on random
graphs (kept cross-tile edges, a padded tail) and on the seeded tile-local
cases at H 1, 4, 8 (each twice, to equal bits); K8's d_wea is held to the
plain emit of the plain backward's d_zpre planes, and its per-head dot is
pinned to torch's order by an exact cancellation.
K1, K2, K4 and K5 also have a bf16 entry (nf read in bf16, everything else
f32): each is held against its plain version (which widens nf to f32 at
entry) at the esol head shape, both node tiles and every level kind, with
its own launch count and the f32 entry's untouched, the same bits twice,
the exact one-neighbour cancellations, and the 8-byte alignment and dtype
its wrapper demands.
The GAT logit terms' kernels (csrc/gat_logits.cu) are held to autograd of
the f64 einsums on the CPU, and their gradients to the backward written out
from the formulas, within one ulp of each output's type, at the
passes' head shapes and edge widths, in f32 and bf16, for node rows, edge
rows and both in one launch; they give the same bits twice, the f64 sum's
sign on a knife-edge cancellation, launch counts on their own entries
only, and refuse what their wrapper does not take.
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


def _tcsr_case(cuda, rng, tn, self_loops, H=4, D=32):
    te, n_tiles = 256, 3
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


@pytest.mark.parametrize("self_loops", [False, True])
def test_tcsr_gat_at_the_v1_bond_shape_matches_plain(cuda, self_loops):
    """K1 and K2 at H = 3, D = 8: v1 gat's bond pass, its 5-wide heads
    zero-padded to 8 (model/ablations.py). The padded columns of nf are
    0, as the model gives them, and so are those of out."""
    rng = np.random.default_rng(30 + self_loops)
    args = _tcsr_case(cuda, rng, 128, self_loops, H=3, D=8)
    nf = args[1]
    N = nf.shape[0]
    nf.view(N, 3, 8)[:, :, 5:] = 0.0
    n0 = tcsr_gat.KERNEL.launches
    out, m, den = tcsr_gat.tcsr_gat_fwd(*args)
    torch.cuda.synchronize()
    assert tcsr_gat.KERNEL.launches == n0 + 1
    out_p, m_p, den_p = tcsr_gat.tcsr_gat_fwd_plain(*args)
    _close(out, out_p)
    _close(den, den_p)
    _close_m(m, m_p)
    assert float(out.view(N, 3, 8)[:, :, 5:].abs().max()) == 0.0
    g = torch.from_numpy(rng.standard_normal((N, 24)).astype(np.float32)
                         ).to(cuda)
    s = (g.view(N, 3, 8) * out.view(N, 3, 8)).sum(-1)
    n0 = tcsr_gat.KERNEL_BWD.launches
    got = tcsr_gat.tcsr_gat_bwd(*args[:7], m, den, g, s, self_loops)
    torch.cuda.synchronize()
    assert tcsr_gat.KERNEL_BWD.launches == n0 + 1
    want = tcsr_gat.tcsr_gat_bwd_plain(*args[:7], m, den, g, s, self_loops)
    for k, p in zip(got, want):
        _close(k, p)


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


@pytest.mark.parametrize("tn", [32, 64, 128, 256])
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


def _planes_case(cuda, rng, tn, R, te=64, n_tiles=4):
    """The plane builder's arguments on a graph with an empty tile, every
    third edge's source in the next tile (cross-tile: not in any plane),
    masked real edges, a tile whose window is cut to cw = 0, windows that
    start with the tile before's edges (te = 64 against ~3·tn edges a tile)
    and the padded tail cut to E not a multiple of te."""
    src, dst, mask = _graph(rng, tn, n_tiles, 3, te, empty_tile=1,
                            cross=True)
    kept = np.nonzero(mask)[0]
    mask[kept[::7]] = 0.0
    N = n_tiles * tn
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    assert meta is not None
    meta.cw[2] = 0  # tile 2 has kept edges, but an empty window
    first = [int(np.nonzero(dst // tn == t)[0].min()) for t in (2, 3)]
    assert any(meta.ew_blk[t] * te < e for t, e in zip((2, 3), first))
    E = len(src) - 5  # only padding is cut
    assert E % te and not mask[E:].any()
    ea = rng.standard_normal((E, R)).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw))
    return (T(src[:E]), T(dst[:E]), T(mask[:E]), T(ea) if R else None, N,
            meta_t)


@pytest.mark.parametrize("tn", [32, 64, 128, 256])
@pytest.mark.parametrize("R", [0, 1, 6])
def test_dense_planes_matches_plain_on_cases(cuda, tn, R):
    """K6 (a block per 8-16-row slice of a tile, staged in shared memory)
    equals its plain version exactly on _planes_case: cross-tile and masked
    edges add nothing, a cw = 0 tile is all zeros, each window's edges of
    the tile before are skipped, E is not a multiple of te."""
    rng = np.random.default_rng(330 + tn + R)
    args = _planes_case(cuda, rng, tn, R)
    n0 = dense_gat.KERNEL_PLANES.launches
    got = dense_gat.build_dense_planes_device(*args)
    torch.cuda.synchronize()
    assert dense_gat.KERNEL_PLANES.launches == n0 + 1
    want = dense_gat.build_dense_planes_device_plain(*args)
    assert torch.equal(got, want)
    assert float(got[2].abs().max()) == 0.0  # cw = 0
    assert float(got[0].abs().max()) > 0.0


@pytest.mark.parametrize("R", [0, 1, 6])
def test_dense_planes_sums_a_repeated_pair(cuda, R):
    """A (dst, src) pair that repeats inside a window (which
    packing.dp_level_ok keeps off the packed path) is summed, as the TPU
    kernel's one-hot matmuls sum it: 2 in the adjacency plane and the two
    edges' attrs added, within 1e-6 of the plain version's sum."""
    rng = np.random.default_rng(340 + R)
    tn, te = 128, 64
    src, dst, mask = _graph(rng, tn, 3, 3, te, empty_tile=1)
    e0 = 10
    assert mask[e0] > 0
    # a copy of edge e0 right after it; one padding edge dropped
    src = np.insert(src, e0 + 1, src[e0])[:-1]
    dst = np.insert(dst, e0 + 1, dst[e0])[:-1]
    mask = np.insert(mask, e0 + 1, 1.0)[:-1]
    N = 3 * tn
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    assert meta is not None
    ea = rng.standard_normal((len(src), R)).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    meta_t = dataclasses.replace(meta, ew_blk=T(meta.ew_blk), cw=T(meta.cw))
    args = (T(src), T(dst), T(mask), T(ea) if R else None, N, meta_t)
    got = dense_gat.build_dense_planes_device(*args)
    want = dense_gat.build_dense_planes_device_plain(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6
    t, i, j = dst[e0] // tn, dst[e0] % tn, src[e0] % tn
    pl = got.view(3, R + 1, tn, tn)[t, :, i, j].cpu()
    assert float(pl[0]) == 2.0
    for r in range(R):
        assert abs(float(pl[r + 1]) - float(ea[e0, r] + ea[e0 + 1, r])) \
            <= 1e-6


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


def _attr_case(cuda, rng, tn, self_loops, strided=False, cross=False):
    """Dense-attr kernel inputs on a tile-local graph with an empty tile, a
    masked real edge and masked padding: (adj, wd, ws, nf, w_ea, src, dst,
    emask, meta, self_loops). With ``cross`` every third edge takes its
    source from the next tile: kept, but in no plane and not counted."""
    H, D, te, n_tiles = 4, 32, 256, 3
    src, dst, mask = _graph(rng, tn, n_tiles, 3, te, empty_tile=1,
                            cross=cross)
    mask[4] = 0.0
    N, E = n_tiles * tn, len(src)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    R = 6 if strided else 0
    local = mask * (src // tn == dst // tn)
    planes = dense_gat.build_dense_planes(
        src, dst, local, rng.standard_normal((E, R)).astype(np.float32), N,
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


def _fused_bwd_twice(bargs):
    """K8 twice on ``bargs``, each time into memory the caching allocator
    has just freed full of NaN, so that an edge whose d_wea the kernel does
    not write shows; returns both results."""
    E, H = bargs[4].shape
    res = []
    for _ in range(2):
        poison = torch.full((E, H), float("nan"), device=bargs[4].device)
        del poison
        res.append(dense_gat.dense_attr_bwd(*bargs))
    torch.cuda.synchronize()
    return res


@pytest.mark.parametrize("tn", [32, 64, 128, 256])
@pytest.mark.parametrize("self_loops", [False, True])
def test_dense_attr_bwd_and_emit_match_plain(cuda, tn, self_loops):
    """K8 with the emit folded in: its four gradients against the plain
    backward's and its d_wea against the plain emit of the plain backward's
    d_zpre planes, each within 1e-4 of its scale, the same bits from a
    second call; the masked edge, the padding tail and the kept cross-tile
    edges (every third edge) get exactly 0."""
    rng = np.random.default_rng(50 + tn + self_loops)
    args = _attr_case(cuda, rng, tn, self_loops, strided=tn == 128,
                      cross=True)
    nf, src, dst, mask = args[3], args[5], args[6], args[7]
    N, HD = nf.shape
    H = args[1].shape[1]
    out, m, den = dense_gat.dense_attr_fwd(*args)
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32)
                         ).to(cuda)
    s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
    bargs = args[:9] + (m, den, g, s, self_loops)
    n0 = dense_gat.KERNEL_ATTR_BWD.launches
    got, again = _fused_bwd_twice(bargs)
    assert dense_gat.KERNEL_ATTR_BWD.launches == n0 + 2
    *grads, dz = dense_gat.dense_attr_bwd_plain(*bargs)
    want = (*grads, dense_gat.dense_attr_emit_plain(dz, *args[5:9]))
    for k, p in zip(got, want):
        _close(k, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    d_wea = got[4]
    cross = (src // tn != dst // tn) & (mask > 0)
    assert bool(cross.any())
    for off in (mask == 0, cross):
        assert float(d_wea[off].abs().max()) == 0.0
    assert float(d_wea.abs().max()) > 0.0


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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,D", [(4, 32), (8, 32), (2, 8)])
def test_dense_gat_bwd_cancels_exactly_with_one_neighbour(cuda, H, D, dt):
    """A row with one neighbour has P = 1 and out = nf[j], so its d_zpre =
    g·nf[j] − s is 0 in exact arithmetic. With s summed in the kernel's
    order (dense_gat.head_dot) it is 0 on the card too: d_wd, d_ws and d_vc
    are exactly 0, not round-off, while d_nf = g[i] at j. In bf16 the f32
    out is nf[j] widened, the values the backward reads."""
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
    args = (T(planes), draw(N, H), draw(N, H), draw(N, H * D).to(dt),
            draw(R + 1, H))
    out, m, den = dense_gat.dense_gat_fwd(*args)
    g = draw(N, H * D)
    d_wd, d_ws, d_nf, d_vc = dense_gat.dense_gat_bwd(
        *args, m, den, g, dense_gat.head_dot(g, out, H))
    torch.cuda.synchronize()
    for k in (d_wd, d_ws, d_vc):
        assert float(k.abs().max()) == 0.0
    assert torch.equal(out, args[3][T(src).long()].float())
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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,D", [(4, 32), (8, 16), (2, 64)])
def test_tcsr_gat_bwd_cancels_exactly_with_one_neighbour(cuda, H, D, dt):
    """A row with one kept in-edge has p = 1 and out = nf[src], so its
    d_zpre = g·nf[src] − s is 0 in exact arithmetic. K2 sums the dot in the
    order in which torch sums s = (g·out).sum(-1) on the card (D ≤ 64), so
    it is 0 on the card too, through the single-device entry point and
    through K3's with s = −dV as the edge-partitioned pass's autograd
    computes it: d_wn and d_w_ea exactly 0, while d_nf[src] = g[dst]. In
    bf16 (the single-device entries; K3 is f32 only) the f32 out is
    nf[src] widened, the values K2 reads."""
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
    nf = nf.to(dt)
    ints = (T(src), T(dst), T(mask))
    out, m, den = tcsr_gat.tcsr_gat_fwd(wn, nf, w_ea, *ints, meta, False)
    assert torch.equal(out, nf[ints[0].long()].float())
    s = (g.view(N, H, D) * out.view(N, H, D)).sum(-1)
    d_wn, d_nf, d_w_ea = tcsr_gat.tcsr_gat_bwd(wn, nf, w_ea, *ints, meta, m,
                                               den, g, s, False)
    torch.cuda.synchronize()
    for k in (d_wn, d_w_ea):
        assert float(k.abs().max()) == 0.0
    _close(d_nf[ints[0].long()], g)
    if dt != torch.float32:
        return

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
# and column roles and the emit, K9, folded in) on the seeded tile-local
# cases; K7 and K8 sum in a fixed order with no atomics, so a second call
# gives the same bits
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
    strided view). Every output within 1e-4 of its scale (K8's d_wea
    against the plain emit of the plain backward's d_zpre planes), the
    same bits from a second call, and d_wea exactly 0 on the masked edges
    and the padding tail."""
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
    got, again = _fused_bwd_twice(bargs)
    assert dense_gat.KERNEL_ATTR_BWD.launches == n0 + 2
    *grads, dz = dense_gat.dense_attr_bwd_plain(*bargs)
    want = (*grads, dense_gat.dense_attr_emit_plain(dz, *args[5:9]))
    for k, p in zip(got, want):
        _close(k, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    d_wea = got[4]
    assert not bool(args[7][-1] > 0)  # a padded tail
    assert float(d_wea[args[7] == 0].abs().max()) == 0.0
    a0 = planes[0, :tn]
    assert a0[case.hub_row % tn].sum() >= min(64, tn)
    assert len(set(np.nonzero(a0[:, case.hub_col])[0] // 8)) == tn // 8


@pytest.mark.parametrize("H,D", [(8, 16), (4, 32), (2, 64)])
def test_dense_attr_bwd_cancels_exactly_with_one_neighbour(cuda, H, D):
    """Frag-like rows: one neighbour each, no self-loop. K7 divides, so
    out = nf[j] bit for bit and P = 1; K8 sums its per-head dot in the order
    in which torch sums DenseAttrGatFn's s = (g·out).sum(-1) on the card,
    so d_zpre = g·nf[j] − s is exactly 0, as the math says: K8's d_wea
    and, through DenseAttrGatFn, the gradients of wd, ws and w_ea are
    exactly 0 (not round-off), while nf's gradient is g[i] at j."""
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
    d_wea_k = dense_gat.dense_attr_bwd(T(planes), *(x.detach() for x in xs),
                                       *ints, meta, m, den, g, s, False)[4]
    torch.cuda.synchronize()
    for k in (d_wd, d_ws, d_wea, d_wea_k):
        assert float(k.abs().max()) == 0.0
    _close(d_nf[ints[0].long()], g)


# ---- the interpreter (interp/) on the card ------------------------------------

_INTERP_MODEL = dict(num_layer=2, num_heads=4, emb_dim=128, h1=64, h2=64,
                     h3=64, h4=64, drop_ratio=0.0)


def _interp_pair(cuda, policy):
    """(card interpreter, CPU interpreter) of one seeded model."""
    from fragnet_tpu_torch.interp.attention import FragNetInterpreter
    from fragnet_tpu_torch.model.finetune import FragNetFineTune

    def model():
        return FragNetFineTune(**_INTERP_MODEL, policy=policy,
                               generator=torch.Generator().manual_seed(7))

    return (FragNetInterpreter(model(), device=cuda),
            FragNetInterpreter(model(), device="cpu"))


@pytest.mark.parametrize("policy", ["default", "dense-attr"])
def test_interpreter_card_matches_cpu(cuda, policy):
    """interpret(aspirin) with contributions through the kernels (K1, K4;
    K7 and K4 under dense-attr) against the plain versions on the CPU: the
    prediction, the min-max-scaled weights and the contributions within
    1e-3 of each vector's scale (a contribution's scale is
    max(|prediction|, max|c|))."""
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.ops import dense_gat as dg, tcsr_gat as tg

    pol = KernelPolicy(attr=True, fc="attr") if policy == "dense-attr" \
        else KernelPolicy()
    gpu, cpu = _interp_pair(cuda, pol)
    counters = (tg.KERNEL, dg.KERNEL, dg.KERNEL_ATTR)
    before = [k.launches for k in counters]
    got = gpu.interpret("CC(=O)Oc1ccccc1C(=O)O", with_contributions=True)
    torch.cuda.synchronize()
    ran = [k.launches - b for k, b in zip(counters, before)]
    want = cpu.interpret("CC(=O)Oc1ccccc1C(=O)O", with_contributions=True)
    # 5 forwards x 2 layers: K1 atom + frag, K4 bond + fconn (default);
    # K7 atom + fconn + frag, K4 bond (dense-attr)
    assert ran == ([20, 20, 0] if policy == "default" else [0, 10, 30])
    pred = abs(want.prediction)
    assert abs(got.prediction - want.prediction) <= 1e-3 * pred
    for f in ("atom_weights", "bond_weights", "frag_weights",
              "fconn_weights"):
        assert getattr(got, f).shape == getattr(want, f).shape, f
        assert np.abs(getattr(got, f) - getattr(want, f)).max() <= 1e-3, f
    for f in ("atom_contrib", "bond_contrib", "frag_contrib",
              "fconn_contrib"):
        g, w = getattr(got, f), getattr(want, f)
        scale = max(pred, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= 1e-3 * scale, f


def test_interpreter_raises_without_tcsr_on_the_card(cuda):
    """A batch without TCSR metadata or planes raises on the card instead
    of taking the CPU-only segment path."""
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.model.layers import KernelPolicy

    gpu, _cpu = _interp_pair(cuda, KernelPolicy())
    g = gpu.featurize("CCO")[0]
    bare = pad_batch([g], spec_for([g], batch_size=1))
    assert bare.tm_atom is None and bare.dp_bond is None
    with pytest.raises(RuntimeError, match="segment path runs on the CPU"):
        gpu.predict(bare)


# --------------------------------------------------------------------------
# the bf16 entries of K1, K2, K4 and K5 (nf in bf16, everything else f32)
# --------------------------------------------------------------------------

_BF16_COUNTERS = {"tcsr": (tcsr_gat.KERNEL_BF16, tcsr_gat.KERNEL_BWD_BF16,
                           tcsr_gat.KERNEL, tcsr_gat.KERNEL_BWD),
                  "dense": (dense_gat.KERNEL_BF16, dense_gat.KERNEL_BWD_BF16,
                            dense_gat.KERNEL, dense_gat.KERNEL_BWD)}


def _counts(kind):
    return tuple(k.launches for k in _BF16_COUNTERS[kind])


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("case", ["tcsr", "tcsr-self-loops", "dense-R1",
                                  "dense-R6"])
def test_bf16_entries_match_plain(cuda, tn, case):
    """K1/K2 (TCSR, cross-tile sources, a masked edge, an empty tile) and
    K4/K5 (dense planes, R = 1 and 6) with bf16 nf: each output within
    1e-4 of its scale of the plain version on the same bf16 inputs, the
    bf16 entries launched once each and the f32 entries not at all, and
    the same bits from a second call."""
    rng = np.random.default_rng(200 + tn + len(case))
    bf = torch.bfloat16
    if case.startswith("tcsr"):
        kind, self_loops = "tcsr", case.endswith("self-loops")
        args = list(_tcsr_case(cuda, rng, tn, self_loops))
        args[1] = args[1].to(bf)
        fwd, bwd = tcsr_gat.tcsr_gat_fwd, tcsr_gat.tcsr_gat_bwd
        fwd_p, bwd_p = tcsr_gat.tcsr_gat_fwd_plain, tcsr_gat.tcsr_gat_bwd_plain

        def bwd_args(out, m, den, g):
            N, H = m.shape
            s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
            return (*args[:7], m, den, g, s, self_loops)
    else:
        kind, R = "dense", int(case[-1])
        H, D, n_tiles = 4, 32, 3
        src, dst, mask = _graph(rng, tn, n_tiles, 3, 32, empty_tile=2)
        N = n_tiles * tn
        ea = rng.standard_normal((len(src), R)).astype(np.float32)
        planes = dense_gat.build_dense_planes(src, dst, mask, ea, N, tn=tn)
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
        draw = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
        args = [T(planes), draw(N, H), draw(N, H), draw(N, H * D).to(bf),
                draw(R + 1, H)]
        fwd, bwd = dense_gat.dense_gat_fwd, dense_gat.dense_gat_bwd
        fwd_p, bwd_p = dense_gat.dense_gat_fwd_plain, \
            dense_gat.dense_gat_bwd_plain

        def bwd_args(out, m, den, g):
            return (*args, m, den, g, dense_gat.head_dot(g, out, H))
    n0 = _counts(kind)
    got = fwd(*args)
    torch.cuda.synchronize()
    assert _counts(kind) == (n0[0] + 1, n0[1], n0[2], n0[3])
    for k, p in zip(got, fwd_p(*args)):
        _close_m(k, p)
    assert all(torch.equal(a, b) for a, b in zip(got, fwd(*args)))
    out, m, den = got
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32)).to(cuda)
    bargs = bwd_args(out, m, den, g)
    n1 = _counts(kind)
    grads = bwd(*bargs)
    torch.cuda.synchronize()
    assert _counts(kind) == (n1[0], n1[1] + 1, n1[2], n1[3])
    for k, p in zip(grads, bwd_p(*bargs)):
        _close(k, p)
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd(*bargs)))


@pytest.mark.parametrize("case", ["attr", "attr-self-loops", "ep"])
def test_bf16_attr_and_ep_entries_match_plain(cuda, case):
    """The bf16 entries of K7 and K8 (with K9's d_wea, exactly 0 off the
    counted edges) and of K3 (each of two shards, forward and backward)
    with bf16 nf: each output within 1e-4 of its scale of the plain version
    on the same bf16 inputs, each bf16 entry launched once per call and
    its f32 form not at all, the same bits from a second call."""
    rng = np.random.default_rng(300 + len(case))
    bf = torch.bfloat16
    if case.startswith("attr"):
        self_loops = case.endswith("self-loops")
        args = list(_attr_case(cuda, rng, 128, self_loops, cross=True))
        args[3] = args[3].to(bf)
        counters = (dense_gat.KERNEL_ATTR_BF16, dense_gat.KERNEL_ATTR_BWD_BF16,
                    dense_gat.KERNEL_ATTR, dense_gat.KERNEL_ATTR_BWD)
        n0 = tuple(k.launches for k in counters)
        out, m, den = dense_gat.dense_attr_fwd(*args)
        torch.cuda.synchronize()
        assert tuple(k.launches for k in counters) == (n0[0] + 1, *n0[1:])
        for k, p in zip((out, m, den), dense_gat.dense_attr_fwd_plain(*args)):
            _close_m(k, p)
        g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).to(cuda)
        N, H = m.shape
        s_ = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
        bargs = tuple(args[:9]) + (m, den, g, s_, self_loops)
        got, again = _fused_bwd_twice(bargs)
        assert tuple(k.launches for k in counters) == (
            n0[0] + 1, n0[1] + 2, *n0[2:])
        for k, p in zip(got, dense_gat.dense_attr_bwd_emit_plain(*bargs)):
            _close(k, p)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        src, dst, mask = args[5], args[6], args[7]
        cross = (src // 128 != dst // 128) & (mask > 0)
        for off in (mask == 0, cross):
            assert float(got[4][off].abs().max()) == 0.0
        return
    wn, nf, meta, shards = _ep_case(cuda, rng, 128)
    nf = nf.to(bf)
    counters = (tcsr_gat.KERNEL_EP_BF16, tcsr_gat.KERNEL_EP_BWD_BF16,
                tcsr_gat.KERNEL_EP, tcsr_gat.KERNEL_EP_BWD)
    Ng = meta.n_tiles_grid * 128
    for r, s, d, m, w_ea in shards:
        args = (wn, nf, w_ea, s, d, m, meta, r)
        n0 = tuple(k.launches for k in counters)
        k = tcsr_gat.tcsr_gat_ep_fwd(*args)
        torch.cuda.synchronize()
        assert tuple(c.launches for c in counters) == (n0[0] + 1, *n0[1:])
        p = tcsr_gat.tcsr_gat_ep_fwd_plain(*args)
        _close(k[0], p[0])
        _close_m(k[1], p[1])
        _close(k[2], p[2])
        assert all(torch.equal(a, b)
                   for a, b in zip(k, tcsr_gat.tcsr_gat_ep_fwd(*args)))
        mg = torch.where(p[1] <= -1e29, torch.zeros_like(p[1]), p[1])
        dU = torch.from_numpy(rng.standard_normal((Ng, nf.shape[1])).astype(
            np.float32)).to(cuda)
        dV = torch.from_numpy(rng.standard_normal(tuple(mg.shape)).astype(
            np.float32)).to(cuda)
        kb = tcsr_gat.tcsr_gat_ep_bwd(*args, mg, dU, dV)
        torch.cuda.synchronize()
        for a, b in zip(kb, tcsr_gat.tcsr_gat_ep_bwd_plain(*args, mg, dU,
                                                            dV)):
            _close(a, b)
        assert all(torch.equal(a, b) for a, b in zip(
            kb, tcsr_gat.tcsr_gat_ep_bwd(*args, mg, dU, dV)))
        assert torch.equal(kb[2][m == 0], torch.zeros_like(kb[2][m == 0]))
        assert tuple(c.launches for c in counters)[2:] == n0[2:]


def test_bf16_passes_match_cpu(cuda):
    """The TCSR pass with bf16 node features and edge attributes, forward
    and backward through TcsrGatFn on the card (the bf16 entries) and on
    the CPU (the plain versions): out and the bf16 gradients d_nf, d_ea
    within one bf16 ulp of each element (both round the same f32 sums,
    taken in another order, once; a gradient 0 in exact arithmetic within
    1e-5 of the scale), the attention vector's f32 gradient within 1e-4 of
    its scale."""
    rng = np.random.default_rng(230)
    bf = torch.bfloat16
    H, D, Da, tn, te = 4, 32, 8, 128, 256
    src, dst, mask = _graph(rng, tn, 2, 3, te)
    N, E = 2 * tn, len(src)
    meta = build_tile_meta(src, dst, mask, N, tn=tn, te=te)
    cpu_meta = dataclasses.replace(meta, **{
        f: torch.from_numpy(getattr(meta, f))
        for f in ("ew_blk", "cw", "sw_tile", "flat_slot")})
    card_meta = dataclasses.replace(cpu_meta, **{
        f: getattr(cpu_meta, f).to(cuda)
        for f in ("ew_blk", "cw", "sw_tile", "flat_slot")})
    nf = torch.from_numpy(rng.standard_normal((N, H, D)).astype(
        np.float32)).to(bf)
    ea = torch.from_numpy(rng.standard_normal((E, Da)).astype(
        np.float32)).to(bf)
    a = torch.from_numpy(rng.standard_normal((H, 2 * D + Da)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((N, H, D)).astype(np.float32))
    ints = [torch.from_numpy(x) for x in (src, dst, mask)]

    def run(dev, meta_):
        xs = [x.to(dev).requires_grad_() for x in (nf, ea, a)]
        n0 = tcsr_gat.KERNEL_BF16.launches, tcsr_gat.KERNEL_BWD_BF16.launches
        out, _ = tcsr_gat.tcsr_gat_pass(xs[0], xs[1], *(t.to(dev)
                                                        for t in ints),
                                        xs[2], meta_, self_loops=True)
        grads = torch.autograd.grad((out.float() * g.to(dev)).sum(), xs)
        n1 = tcsr_gat.KERNEL_BF16.launches, tcsr_gat.KERNEL_BWD_BF16.launches
        return out.cpu(), [x.cpu() for x in grads], (n1[0] - n0[0],
                                                     n1[1] - n0[1])

    out_c, grads_c, n_c = run(torch.device("cpu"), cpu_meta)
    out_k, grads_k, n_k = run(cuda, card_meta)
    assert n_c == (0, 0) and n_k == (1, 1)
    assert out_k.dtype == bf and grads_k[0].dtype == bf

    def within_ulp(k, p):
        k, p = k.detach().float(), p.detach().float()
        big = torch.maximum(k.abs(), p.abs())
        ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -126)))
                         - 7)
        err = (k - p).abs()
        assert bool(((err <= ulp) | (err <= 1e-5 * float(p.abs().max())))
                    .all())

    within_ulp(out_k, out_c)
    within_ulp(grads_k[0], grads_c[0])
    within_ulp(grads_k[1], grads_c[1])
    _close(grads_k[2], grads_c[2])


def test_bf16_entries_refuse_what_they_do_not_take(cuda):
    """The bf16 entries read a lane's four columns as one 8-byte load: an
    nf not 8-byte aligned is refused, as is an nf of another type (f16);
    the K7 and K3 wrappers refuse a misaligned bf16 nf too."""
    N, H, D, tn = 128, 4, 32, 128
    z = lambda *shape: torch.zeros(shape, device=cuda)
    bf = torch.bfloat16
    planes = z(1, 2 * tn, tn)
    odd = torch.zeros(N * H * D + 2, device=cuda, dtype=bf)[2:].view(N,
                                                                     H * D)
    ok = torch.zeros(N * H * D + 4, device=cuda, dtype=bf)[4:].view(N, H * D)
    dense_gat.dense_gat_fwd(planes, z(N, H), z(N, H), ok, z(2, H))  # taken
    with pytest.raises(ValueError, match="8-byte aligned"):
        dense_gat.dense_gat_fwd(planes, z(N, H), z(N, H), odd, z(2, H))
    with pytest.raises(ValueError, match="dtype"):
        dense_gat.dense_gat_fwd(planes, z(N, H), z(N, H),
                                ok.to(torch.float16), z(2, H))
    case = kernel_case(1, 32)
    T, meta = _case_tensors(cuda, case, 32, 64)
    Nc, E = case.n_nodes, len(case.src)
    ints = (T(case.src), T(case.dst), T(case.mask))
    nf = torch.zeros(Nc * 128 + 2, device=cuda, dtype=bf)[2:].view(Nc, 128)
    with pytest.raises(ValueError, match="8-byte aligned"):
        tcsr_gat.tcsr_gat_fwd(z(Nc, 8), nf, z(E, 4), *ints, meta, False)
    with pytest.raises(ValueError, match="dtype"):
        tcsr_gat.tcsr_gat_fwd(z(Nc, 8), z(Nc, 128).half(), z(E, 4), *ints,
                              meta, False)
    rng = np.random.default_rng(9)
    args = list(_attr_case(cuda, rng, tn, False))
    Na, HDa = args[3].shape
    for bad, match in (
            (torch.zeros(Na * HDa + 2, device=cuda, dtype=bf)[2:].view(
                Na, HDa), "8-byte aligned"),
            (args[3].half(), "dtype")):
        with pytest.raises(ValueError, match=match):
            dense_gat.dense_attr_fwd(*args[:3], bad, *args[4:])
    wn, nf32, ep_meta, shards = _ep_case(cuda, rng, tn)
    r, s_, d_, m_, w_ea = shards[0]
    Ne, HDe = nf32.shape
    bad = torch.zeros(Ne * HDe + 2, device=cuda, dtype=bf)[2:].view(Ne, HDe)
    with pytest.raises(ValueError, match="8-byte aligned"):
        tcsr_gat.tcsr_gat_ep_fwd(wn, bad, w_ea, s_, d_, m_, ep_meta, r)


# --------------------------------------------------------------------------
# the GAT logit terms (csrc/gat_logits.cu) against the f64 einsums
# --------------------------------------------------------------------------

LOGIT_HEADS = [(4, 32), (3, 8), (1, 32), (8, 16)]
# (node rows, edge rows): empty, one, and counts off every tile size
LOGIT_ROWS = [(0, 5), (1, 1), (255, 1001), (1537, 4099)]
LOGIT_KERNELS = ("KERNEL", "KERNEL_BF16", "KERNEL_BWD", "KERNEL_BWD_BF16",
                 "KERNEL_DVEC")


def _logit_launches():
    from fragnet_tpu_torch.ops import gat_logits
    return [getattr(gat_logits, k).launches for k in LOGIT_KERNELS]


def _within_ulp(got, want):
    """|got - want| within one ulp of want in its type (f32: 24 bits,
    bf16: 8); both on the CPU."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = 24 if want.dtype == torch.float32 else 8
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - bits)
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    assert bool((err <= ulp).all()), float((err - ulp).max())


def _logit_inputs(rng, H, D, Da, dtype, N, E, form):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    a = f(H, 2 * D + Da)
    nf = f(N, H, D).to(dtype) if form != "edge" else None
    ea = f(E, Da).to(dtype) if form != "node" else None
    return a, nf, ea, f(N, 2 * H), f(E, H)


def _logit_grads(dev, a, nf, ea, Da, d_wn, d_wea):
    """(outputs, gradients) of logit_terms on ``dev`` by autograd: the
    kernels' Function on CUDA, the f64 einsums on the CPU."""
    from fragnet_tpu_torch.ops import gat_logits
    leaves = [None if t is None
              else t.detach().to(dev, copy=True).requires_grad_(True)
              for t in (a, nf, ea)]
    wn, w_ea = gat_logits.logit_terms(leaves[1], leaves[2], leaves[0], Da)
    outs = [t for t in (wn, w_ea) if t is not None]
    cots = [g.to(dev) for t, g in ((wn, d_wn), (w_ea, d_wea))
            if t is not None]
    torch.autograd.backward(outs, cots)
    return outs, [t.grad for t in leaves if t is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Da", [1, 6, 32, 128])
@pytest.mark.parametrize("H,D", LOGIT_HEADS)
def test_gat_logits_match_the_f64_einsum(cuda, H, D, Da, dtype):
    """wn, w_ea, d_nf, d_ea and d_a of the kernel pair against autograd of
    the f64 einsums on the CPU, and the gradients also against the backward
    written out from the formulas (gat_logits_bwd_plain), within one ulp
    (one bf16 ulp for a bf16 gradient), for node rows alone (node_logits),
    edge rows alone and both in one launch (prologue), at row counts 0, 1
    and off every tile."""
    from fragnet_tpu_torch.ops import gat_logits
    rng = np.random.default_rng(H * 1000 + D * 10 + Da)
    for form in ("node", "edge", "both"):
        for N, E in LOGIT_ROWS:
            a, nf, ea, d_wn, d_wea = _logit_inputs(rng, H, D, Da, dtype, N,
                                                   E, form)
            outs_k, grads_k = _logit_grads(cuda, a, nf, ea, Da, d_wn, d_wea)
            outs_c, grads_c = _logit_grads("cpu", a, nf, ea, Da, d_wn, d_wea)
            grads_p = [t for t in gat_logits.gat_logits_bwd_plain(
                nf, ea, a, Da, d_wn, d_wea) if t is not None]
            torch.cuda.synchronize()
            for k, c in zip(outs_k + grads_k, outs_c + grads_c):
                _within_ulp(k, c)
            assert len(grads_p) == len(grads_k)
            for k, p in zip(grads_k, grads_p):
                _within_ulp(k, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gat_logits_same_bits_twice(cuda, dtype):
    """The pretraining step's atom-level shapes (H 4, D 32, Da 128) at rows
    that take every SM: two runs give the same bits, forward and backward
    (no atomics; d_a's partials are summed in a fixed order)."""
    rng = np.random.default_rng(11)
    a, nf, ea, d_wn, d_wea = _logit_inputs(rng, 4, 32, 128, dtype, 60001,
                                           120007, "both")
    runs = [_logit_grads(cuda, a, nf, ea, 128, d_wn, d_wea)
            for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gat_logits_knife_edge_cancellation(cuda, sign):
    """An ea·a_ea dot of terms 1, 2^-30, -1, -2^-31 (times ``sign``), spread
    over a row's slots: summed in f32 in that order it lands at -2^-31
    (the wrong side of 0), in f64 at +2^-31 exactly. The kernel gives the
    f64 sum, through prologue as the passes call it."""
    H, D, Da = 4, 32, 32
    terms = [(0, 1.0), (9, 2.0 ** -30), (17, -1.0), (31, -2.0 ** -31)]
    s32 = np.float32(0.0)
    for _, v in terms:
        s32 = np.float32(s32 + np.float32(sign * v))
    assert sign * float(s32) < 0.0
    ea = torch.zeros(3, Da)
    for c, v in terms:
        ea[1, c] = sign * v
    a = torch.zeros(H, 2 * D + Da)
    a[:, D:D + Da] = 1.0
    nf = torch.ones(7, H, D)
    wn, w_ea = tcsr_gat.prologue(nf.to(cuda), ea.to(cuda), a.to(cuda))
    torch.cuda.synchronize()
    assert float(w_ea[1, 0]) == sign * 2.0 ** -31
    assert torch.equal(w_ea.cpu()[1], torch.full((H,), sign * 2.0 ** -31))
    assert torch.equal(w_ea.cpu()[[0, 2]], torch.zeros(2, H))


def test_gat_logits_launch_counts(cuda):
    """Each call moves the count of the entry that ran and no other: the
    f32 forward, the bf16 forward (a bf16 row set: the bf16 prologue's f32
    node rows and bf16 edge rows), each with its backward entry and one
    gat_logits_dvec; no other kernel of the port launches."""
    from fragnet_tpu_torch.ops import _cuda
    rng = np.random.default_rng(5)
    a, nf, ea, d_wn, d_wea = _logit_inputs(rng, 4, 32, 128, torch.float32,
                                           300, 500, "both")
    cases = [
        (lambda: tcsr_gat.node_logits(nf.to(cuda), a.to(cuda), 128),
         [1, 0, 0, 0, 0]),
        (lambda: tcsr_gat.prologue(nf.to(cuda), ea.to(cuda), a.to(cuda)),
         [1, 0, 0, 0, 0]),
        (lambda: _logit_grads(cuda, a, nf, ea, 128, d_wn, d_wea),
         [1, 0, 1, 0, 1]),
        (lambda: _logit_grads(cuda, a, nf, ea.bfloat16(), 128, d_wn, d_wea),
         [0, 1, 0, 1, 1]),
        (lambda: _logit_grads(cuda, a, nf.bfloat16(), None, 128, d_wn,
                              d_wea), [0, 1, 0, 1, 1]),
    ]
    for fn, moved in cases:
        before, others = _logit_launches(), _cuda.launch_counts()
        fn()
        torch.cuda.synchronize()
        after = _logit_launches()
        assert [y - x for x, y in zip(before, after)] == moved
        now = _cuda.launch_counts()
        assert {k: n for k, n in now.items() if not k.startswith(
            "gat_logits")} == {k: n for k, n in others.items()
                               if not k.startswith("gat_logits")}


def test_gat_logits_refuse_what_they_do_not_take(cuda):
    """The wrapper raises on a row type other than f32 / bf16, an attention
    vector other than f32 or of the wrong shape, rows not contiguous within
    themselves, tensors on two devices, more than 16 vectors a segment and
    rows wider than a block's slots. Rows off a 16-byte boundary are taken,
    at a narrower load, and give the contiguous rows' values."""
    from fragnet_tpu_torch.ops import gat_logits
    H, D, Da = 4, 32, 128
    z = lambda *s, **kw: torch.zeros(s, device=cuda, **kw)
    a, nf, ea = z(H, 2 * D + Da), z(9, H, D), z(11, Da)
    fwd = gat_logits.gat_logits_fwd
    for bad, match in ((nf.half(), "dtype"), (nf.double(), "dtype")):
        with pytest.raises(ValueError, match=match):
            fwd(bad, ea, a, Da)
    with pytest.raises(ValueError, match="dtype"):
        fwd(nf, ea, a.double(), Da)
    with pytest.raises(ValueError, match="shape"):
        fwd(nf, ea, z(H, 2 * D + Da + 1), Da)
    with pytest.raises(ValueError, match="strides|contiguous"):
        fwd(z(9, D, H).transpose(1, 2), ea, a, Da)
    with pytest.raises(ValueError, match="is on"):
        fwd(nf, ea.cpu(), a, Da)
    with pytest.raises(ValueError, match="vectors a segment"):
        fwd(None, z(5, 8), z(17, 2 * D + 8), 8)
    with pytest.raises(ValueError, match="slots"):
        fwd(None, z(5, 4096), z(H, 2 * D + 4096), 4096)
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.standard_normal((11, Da + 2))
                            .astype(np.float32)).to(cuda)
    off = base[:, 1:Da + 1]                   # 4 bytes past a boundary
    aa = torch.from_numpy(rng.standard_normal((H, 2 * D + Da))
                          .astype(np.float32)).to(cuda)
    assert gat_logits.plan(11, 1, Da, H, off.stride(0), 4,
                           off.data_ptr()).V == 1
    _, w_off = fwd(None, off, aa, Da)
    _, w_ref = fwd(None, off.contiguous(), aa, Da)
    torch.cuda.synchronize()
    _within_ulp(w_off, w_ref)
