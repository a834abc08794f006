"""The port's packed transport against fragnet_tpu's, on the CPU: the plane
builder's plain version against the JAX package's build_dense_planes_device
(Pallas, interpreted) and against the host builder; ``pack_batch`` →
``unpack_batch`` against the JAX package's own pack and unpack, field by
field; the packed loaders (threaded and spawned streams, the host and
device packed caches, DeviceCacheLoader, ``maybe_cache``) and the packed
buffer's move to a device. Small batches of the ``ft_graphs`` molecules and
of a few pretrain graphs, tile-aligned at tn = te = 16 as in
tests/test_packing.py. Tolerance: exact — every decoded value is a copy or
an integer-valued sum."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.data.batcher import BatchLoader as JaxLoader
from fragnet_tpu.data.datasets import PretrainData as JaxPretrainData
from fragnet_tpu.data.packing import unpack_batch as jax_unpack_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.ops import dense_gat as jax_dense_gat

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.data import packing
from fragnet_tpu_torch.data.batcher import (BatchLoader, DeviceCacheLoader,
                                            DevicePackedCacheLoader,
                                            PackedCacheLoader)
from fragnet_tpu_torch.data.datasets import PretrainData
from fragnet_tpu_torch.graphs.batch import PackedUploader, to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import spec_for
from fragnet_tpu_torch.ops.dense_gat import (build_dense_planes,
                                             build_dense_planes_device,
                                             build_dense_planes_device_plain)
from fragnet_tpu_torch.train import fastpath

PT_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "CC(=O)Oc1ccccc1C(=O)O",
             "OCC(O)C(O)CO"]
_TM_ARRAYS = ("ew_blk", "sw_tile", "flat_slot", "cw")


def _aligned(graphs, spec_fn=spec_for):
    return spec_fn(graphs, batch_size=4, multiple=16, tcsr=True, tn=16,
                   te=16, align=True)


def _plain(graphs, tcsr=False):
    return spec_for(graphs, batch_size=4, multiple=16, tcsr=tcsr, tn=16,
                    te=16)


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = PortBuilder("exp1s")
    return [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                          smiles=g.smiles) for g in ft_graphs]


@pytest.fixture(scope="module")
def pt_graphs():
    """(JAX, port) pretrain graphs of the same SMILES: geometric targets
    and energies."""
    return (JaxPretrainData().get_pt_dataset(PT_SMILES, seed=0),
            PretrainData().get_pt_dataset(PT_SMILES, seed=0))


# --------------------------------------------------------------------------
# the plane builder (K6's plain version)
# --------------------------------------------------------------------------

_LEVELS = {0: ("edge_src", "edge_dst", "edge_mask", None, "tm_atom"),
           1: ("bg_src", "bg_dst", "bg_mask", "ea_bonds", "tm_bond"),
           6: ("fc_src", "fc_dst", "fc_mask", "ea_fbonds", "tm_fc")}


@pytest.mark.parametrize("R", [0, 1, 6])
def test_plane_builder_matches_pallas_and_host(port_graphs, R):
    """K6's plain version on an aligned TCSR batch equals the JAX package's
    interpreted Pallas builder and the host builder, exactly."""
    b = next(iter(BatchLoader(port_graphs, 4, spec=_aligned(port_graphs))))
    src_f, dst_f, mask_f, ea_f, tm_f = _LEVELS[R]
    src, dst, mask = (getattr(b, f) for f in (src_f, dst_f, mask_f))
    ea = getattr(b, ea_f) if ea_f else np.zeros((len(src), 0), np.float32)
    tm = getattr(b, tm_f)
    n = b.x_atoms.shape[0] if R == 0 else (
        b.edge_src.shape[0] if R == 1 else b.nf_fbonds.shape[0])
    host = build_dense_planes(src, dst, mask, ea, n, tn=tm.tn)
    assert host is not None and host.shape[1] == (R + 1) * tm.tn
    ref = jax_dense_gat.build_dense_planes_device(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        jnp.asarray(ea) if R else None, n, tm, interpret=True)
    tmt = getattr(to_device(b, "cpu"), tm_f)
    got = build_dense_planes_device(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        torch.from_numpy(ea) if R else None, n, tmt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), host)
    assert float(got[:, :tm.tn].sum()) == float((mask > 0).sum())


def test_plane_builder_drops_foreign_and_masked_edges():
    """Edges outside their tile's window, crossing tiles or masked add
    nothing — as the TPU kernel."""
    from fragnet_tpu_torch.ops.tcsr import TileMeta

    src = torch.tensor([0, 1, 17, 20, 3, 5], dtype=torch.int32)
    dst = torch.tensor([1, 0, 2, 21, 3, 6], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32)
    # tile 0's window is edges 0..3 (one te=4 block), tile 1's edges 0..3;
    # edge 5 (tile 0) lies outside every window, edge 2 crosses tiles
    tm = TileMeta(ew_blk=torch.tensor([0, 0], dtype=torch.int32),
                  sw_tile=torch.tensor([0, 1], dtype=torch.int32),
                  flat_slot=torch.zeros(6, dtype=torch.int32),
                  cw=torch.tensor([1, 1], dtype=torch.int32),
                  tn=16, te=4, n_chunks=1, k_src=1)
    got = build_dense_planes_device_plain(src, dst, mask, None, 32, tm)
    want = torch.zeros((2, 16, 16))
    want[0, 1, 0] = want[0, 0, 1] = want[1, 5, 4] = 1.0
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# pack / unpack against the JAX package
# --------------------------------------------------------------------------

def _assert_decoded_equal(uj, up, names):
    for name in names:
        a, b = getattr(uj, name), getattr(up, name)
        if a is None:
            assert b is None, name
            continue
        if name.startswith("tm_"):
            for part in _TM_ARRAYS:
                np.testing.assert_array_equal(
                    getattr(b, part).numpy(), np.asarray(getattr(a, part)),
                    err_msg=f"{name}.{part}")
            assert (a.tn, a.te, a.n_chunks, a.k_src) == \
                (b.tn, b.te, b.n_chunks, b.k_src)
            continue
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("case", ["aligned", "unaligned-tcsr", "plain"])
def test_unpack_matches_jax_field_by_field(pt_graphs, case):
    """The port's pack + unpack of a pretrain batch (with_targets) gives the
    JAX package's unpack of its own buffer, field by field: every array,
    the TileMeta parts and the device-built dp_bond / dp_fc planes."""
    jg, pg = pt_graphs
    kw = dict(batch_size=4, multiple=16, tcsr=case != "plain", tn=16, te=16,
              align=case == "aligned")
    sj, sp = jax_spec_for(jg, **kw), spec_for(pg, **kw)
    lj = JaxLoader(jg, 4, spec=sj, to_device=False,
                   with_targets=True, pack=True)
    lp = BatchLoader(pg, 4, spec=sp, with_targets=True,
                     pack=True)
    for bj, bp in zip(lj, lp):
        uj = jax_unpack_batch(jnp.asarray(bj), lj.layout)
        up = packing.unpack_batch(torch.from_numpy(bp), lp.layout)
        names = [f.name for f in dataclasses.fields(up)
                 if not f.name.startswith("dp_")]
        _assert_decoded_equal(uj, up, names + ["dp_bond", "dp_fc"])
        # the dense-attr mode's adjacency planes are not rebuilt
        assert up.dp_atom is None and up.dp_frag is None
        assert (up.dp_bond is not None) == (case == "aligned")
    assert lp.layout.total_bytes % packing.ALIGN == 0
    assert all(e.offset % packing.ALIGN == 0 for e in lp.layout.entries)


def test_unpack_planes_follow_the_policy(pt_graphs):
    """Only the levels the kernel policy reads get planes."""
    from fragnet_tpu_torch.model.layers import KernelPolicy

    _jg, pg = pt_graphs
    lp = BatchLoader(pg, 4, spec=_aligned(pg), with_targets=True, pack=True)
    buf = torch.from_numpy(next(iter(lp)))
    levels = packing.plane_levels(KernelPolicy(bond="tcsr"))
    assert levels == ("dp_fc",)
    up = packing.unpack_batch(buf, lp.layout, levels)
    assert up.dp_bond is None and up.dp_fc is not None
    assert packing.plane_levels(KernelPolicy()) == ("dp_bond", "dp_fc")


def test_unpack_attr_policy_rebuilds_adjacency_planes(pt_graphs):
    """Under the dense-attr policy the packed path reads four plane levels;
    ``unpack_batch`` (on the CPU: K6's plain version) rebuilds dp_atom and
    dp_frag at R = 0 equal to the host builder's planes of the same batch,
    and dp_bond / dp_fc as before."""
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.model.layers import KernelPolicy

    _jg, pg = pt_graphs
    spec = _aligned(pg)
    lp = BatchLoader(pg, 4, spec=spec, with_targets=True, pack=True)
    policy = KernelPolicy(attr=True, fc="attr")
    levels = packing.plane_levels(policy)
    assert levels == ("dp_bond", "dp_fc", "dp_atom", "dp_frag")
    assert packing.plane_levels(KernelPolicy(bond="tcsr", fc="tcsr",
                                             attr=True)) == ("dp_atom",
                                                             "dp_frag")
    for buf, window in zip(lp, lp._windows()):
        assert [d[0] for d in lp.layout.dp_specs] == list(levels)
        up = packing.unpack_batch(torch.from_numpy(buf), lp.layout, levels)
        host = pad_batch(window, spec, with_targets=True)
        for lvl in levels:
            want = getattr(host, lvl)
            assert want is not None, lvl
            np.testing.assert_array_equal(getattr(up, lvl).numpy(), want,
                                          err_msg=lvl)


def test_pack_refusals(port_graphs):
    b = next(iter(BatchLoader(port_graphs, 4, spec=_plain(port_graphs))))
    with pytest.raises(NotImplementedError, match="compact"):
        packing.build_layout(b, compact=True)
    lay = packing.build_layout(b)
    assert lay.entry("atom_mask").enc == packing.MASKC
    bad = np.asarray(b.atom_mask).copy()
    bad[int(bad.sum()) // 2] = 0.0  # mid-array hole
    with pytest.raises(ValueError, match="contiguous prefix"):
        packing.pack_batch(dataclasses.replace(b, atom_mask=bad), lay)
    with pytest.raises(ValueError, match="uint8"):
        packing.unpack_batch(torch.zeros(8, dtype=torch.uint8), lay)


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------

def _packed(graphs, bs=4, **kw):
    return BatchLoader(graphs, bs, spec=_plain(graphs), pack=True, **kw)


def test_process_stream_matches_thread_stream(port_graphs):
    """Two spawned pack workers reproduce the thread stream's buffer
    sequence exactly over two shuffled epochs."""
    base = _packed(port_graphs, shuffle=True, seed=0)
    next(iter(base))
    ref_l = _packed(port_graphs, shuffle=True, seed=0)
    ref_l.layout = base.layout
    ref = list(ref_l.stream(2, process=False))
    got_l = _packed(port_graphs, shuffle=True, seed=0)
    got_l.layout = base.layout
    got = list(got_l.stream(2, process=True, workers=2))
    assert len(got) == len(ref) == 2 * len(list(ref_l._windows()))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_prefetch_same_batches_and_errors(port_graphs):
    loader = BatchLoader(port_graphs, 4, spec=_plain(port_graphs))
    direct = [b.y for b in loader]
    pre = [b.y for b in loader.prefetch(depth=2)]
    assert len(direct) == len(pre) > 0
    for d, p in zip(direct, pre):
        np.testing.assert_array_equal(d, p)
    loader.graphs[0] = None  # poison → AttributeError in the thread
    with pytest.raises(AttributeError):
        list(loader.prefetch())


def test_packed_cache_matches_plain_and_reshuffles(port_graphs):
    cache = PackedCacheLoader(_packed(port_graphs, 2, shuffle=True, seed=3))
    expected = list(_packed(port_graphs, 2, shuffle=True, seed=3))
    assert len(cache) == len(expected) > 1
    for a, b in zip(cache.bufs, expected):
        np.testing.assert_array_equal(a, b)
    keys = sorted(b.tobytes() for b in cache.bufs)
    e1 = [b.tobytes() for b in cache]
    e2 = [b.tobytes() for b in cache]
    assert sorted(e1) == keys == sorted(e2) and e1 != e2
    assert sum(1 for _ in cache.stream(3)) == 3 * len(cache)


def test_device_packed_cache_covers_and_reshuffles(port_graphs):
    cache = DevicePackedCacheLoader(_packed(port_graphs, 2, shuffle=True,
                                            seed=3), seed=0, device="cpu")
    host = PackedCacheLoader(_packed(port_graphs, 2, shuffle=True, seed=3))
    assert isinstance(cache.bufs, torch.Tensor) and len(cache) == len(host)
    keys = sorted(b.tobytes() for b in host.bufs)
    e1 = [b.numpy().tobytes() for b in cache]
    e2 = [b.numpy().tobytes() for b in cache]
    assert sorted(e1) == keys == sorted(e2) and e1 != e2
    assert sum(1 for _ in cache.stream(2)) == 2 * len(cache)


@pytest.mark.parametrize("cls", [PackedCacheLoader, DevicePackedCacheLoader])
def test_packed_cache_budget_guards(port_graphs, cls):
    kw = {"device": "cpu"} if cls is DevicePackedCacheLoader else {}
    with pytest.raises(MemoryError, match="budget"):
        cls(_packed(port_graphs, 2), max_bytes=8, **kw)


def test_device_cache_loader_covers_and_reshuffles(port_graphs):
    loader = BatchLoader(port_graphs, 2, spec=spec_for(port_graphs, 2),
                         shuffle=True, seed=0)
    cache = DeviceCacheLoader(loader, seed=3, device="cpu")
    assert isinstance(cache.batches[0].y, torch.Tensor)
    e1 = [float(b.y.sum()) for b in cache]
    e2 = [float(b.y.sum()) for b in cache]
    assert len(e1) == len(cache) == 4 and sorted(e1) == sorted(e2)
    assert e1 != e2
    # a cached batch is already on the device: moving it costs nothing
    b = cache.batches[0]
    assert to_device(b, "cpu") is b


def test_device_cache_draws_the_jax_batches(ft_graphs, port_graphs):
    """With the same seed, the port's cached train loader yields the JAX
    package's batches in the JAX package's order, epoch after epoch — after
    the init-batch draw both entry points make."""
    from fragnet_tpu.data.batcher import DeviceCacheLoader as JaxCache

    sj, sp = spec_for(port_graphs, 2), jax_spec_for(ft_graphs, 2)
    jc = JaxCache(JaxLoader(ft_graphs, 2, spec=sp, shuffle=True, seed=4),
                  seed=4)
    pc = DeviceCacheLoader(BatchLoader(port_graphs, 2, spec=sj, shuffle=True,
                                       seed=4), seed=4, device="cpu")
    next(iter(jc)), next(iter(pc))
    for _ in range(3):
        ej = [np.asarray(b.y).ravel().tolist() for b in jc]
        ep = [b.y.numpy().ravel().tolist() for b in pc]
        assert ej == ep


def test_maybe_cache_follows_policy_and_budget(port_graphs):
    spec = spec_for(port_graphs, 2)
    mk = lambda: BatchLoader(port_graphs, 2, spec=spec)  # noqa: E731
    assert isinstance(fastpath.maybe_cache(mk(), "cpu", spec=spec),
                      DeviceCacheLoader)
    plain = mk()
    assert fastpath.maybe_cache(plain, "cpu", policy="off") is plain
    assert fastpath.maybe_cache(plain, "cpu", spec=spec, budget=1) is plain
    assert isinstance(fastpath.maybe_cache(mk(), "cpu", policy="on",
                                           budget=1), DeviceCacheLoader)
    assert fastpath.padded_batch_bytes(spec) * len(plain) > 1


def test_packed_uploader_cpu(port_graphs):
    buf = next(iter(_packed(port_graphs)))
    up = PackedUploader("cpu")
    t = up(buf)
    assert t.dtype == torch.uint8 and np.array_equal(t.numpy(), buf)
    assert up(t) is t
