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

def _assert_decoded_equal(uj, up, names, jax_f32=False):
    """Every field of ``names`` in ``up`` (the port's decode) equals its
    value in ``uj`` (numpy or JAX arrays, or tensors), dtype too; with
    ``jax_f32`` a bf16 field of ``uj`` is compared widened to f32."""
    for name in names:
        a, b = getattr(uj, name), getattr(up, name)
        if a is None:
            assert b is None, name
            continue
        if name.startswith("tm_"):
            for part in _TM_ARRAYS:
                np.testing.assert_array_equal(
                    getattr(b, part).numpy(), _np(getattr(a, part)),
                    err_msg=f"{name}.{part}")
            assert (a.tn, a.te, a.n_chunks, a.k_src) == \
                (b.tn, b.te, b.n_chunks, b.k_src)
            continue
        a = _np(a)
        if jax_f32 and str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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
    # the compact layout is built (its checks are the compact tests below)
    compact = packing.build_layout(b, compact=True)
    assert compact.entry("x_atoms").enc == packing.SPARSE8
    assert compact.total_bytes < packing.build_layout(b).total_bytes
    lay = packing.build_layout(b)
    assert lay.entry("atom_mask").enc == packing.MASKC
    bad = np.asarray(b.atom_mask).copy()
    bad[int(bad.sum()) // 2] = 0.0  # mid-array hole
    with pytest.raises(ValueError, match="contiguous prefix"):
        packing.pack_batch(dataclasses.replace(b, atom_mask=bad), lay)
    with pytest.raises(ValueError, match="uint8"):
        packing.unpack_batch(torch.zeros(8, dtype=torch.uint8), lay)


# --------------------------------------------------------------------------
# the compact encodings against the JAX package's
# --------------------------------------------------------------------------

_CASES = {"plain": dict(tcsr=False, align=False),
          "tcsr": dict(tcsr=True, align=False),
          "aligned": dict(tcsr=True, align=True)}


def _entry_key(e):
    return (e.name, e.enc, e.shape, e.out_dtype, e.k)


def _entry_bytes(layout, buf):
    """{name: the entry's bytes} of a buffer (the JAX package's entries
    end where the next one starts; the port's by their encoded length)."""
    ends = [e.offset for e in layout.entries[1:]] + [layout.total_bytes]
    return {e.name: bytes(buf[e.offset:end])
            for e, end in zip(layout.entries, ends)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_CASES))
def test_compact_layout_and_bytes_match_jax(pt_graphs, case, dtype):
    """``build_layout(compact=True)`` lists the JAX package's entries (name,
    encoding, shape, decoded dtype, k) in its order, and every entry holds
    the JAX package's bytes, with and without targets; the port decodes
    each buffer to the unpacked batch exactly in f32 (every field, the
    TileMeta parts with the derived flat_slot, the rebuilt planes), and to
    the JAX package's decode in bf16."""
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch

    jg, pg = pt_graphs
    kw = dict(batch_size=4, multiple=16, tn=16, te=16, **_CASES[case])
    sj, sp = jax_spec_for(jg, **kw), spec_for(pg, **kw)
    bf16 = dtype == "bfloat16"
    for targets in (True, False):
        lj = JaxLoader(jg, 4, spec=sj, to_device=False, with_targets=targets,
                       pack=True, pack_compact=True,
                       compute_dtype=jnp.bfloat16 if bf16 else None)
        lp = BatchLoader(pg, 4, spec=sp, with_targets=targets, pack=True,
                         pack_compact=True, compute_dtype=dtype)
        n = 0
        for bj, bp, window in zip(lj, lp, lp._windows()):
            n += 1
            assert [_entry_key(e) for e in lp.layout.entries] == \
                [_entry_key(e) for e in lj.layout.entries]
            want = _entry_bytes(lj.layout, bj)
            for e in lp.layout.entries:
                got = bytes(bp[e.offset:e.offset + len(want[e.name])])
                assert got == want[e.name], e.name
            assert all(e.offset % packing.ALIGN == 0
                       for e in lp.layout.entries)
            up = packing.unpack_batch(torch.from_numpy(bp), lp.layout)
            names = [f.name for f in dataclasses.fields(up)
                     if not f.name.startswith("dp_")]
            if bf16:
                uj = jax_unpack_batch(jnp.asarray(bj), lj.layout)
                _assert_decoded_equal(uj, _as_f32(up), names
                                      + ["dp_bond", "dp_fc"], jax_f32=True)
                continue
            host = pad_batch(window, sp, with_targets=targets,
                             build_dense=True, strict_tcsr=sp.tcsr)
            _assert_decoded_equal(host, up, names + ["dp_bond", "dp_fc"])
        assert n == len(lp) > 1
        encs = {e.enc for e in lp.layout.entries}
        assert {packing.SPARSE8, packing.BITS, packing.RUNS8,
                packing.LOC8} <= encs
        assert not any(e.name.endswith("flat_slot")
                       for e in lp.layout.entries)
        if case != "plain":
            default = packing.build_layout(
                pad_batch(next(lp._windows()), sp, with_targets=targets,
                          build_dense=False, strict_tcsr=True), dtype,
                aligned=sp.align)
            assert lp.layout.total_bytes < default.total_bytes


def _as_f32(b):
    """``b`` with its bf16 fields widened to f32 (exact)."""
    return dataclasses.replace(b, **{
        f.name: getattr(b, f.name).float() for f in dataclasses.fields(b)
        if isinstance(getattr(b, f.name), torch.Tensor)
        and getattr(b, f.name).dtype == torch.bfloat16})


def _compact_pair(ft_graphs, port_graphs):
    """(JAX batch, port batch, JAX compact layout, port compact layout) of
    the first four molecules, padded without TCSR."""
    from fragnet_tpu.data.packing import build_layout as jax_build_layout
    from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad

    from fragnet_tpu_torch.graphs.hiergraph import pad_batch

    sj = jax_spec_for(ft_graphs, batch_size=4)
    sp = spec_for(port_graphs, batch_size=4)
    bj = jax_pad(ft_graphs[:4], sj)
    bp = pad_batch(port_graphs[:4], sp)
    return (bj, bp, jax_build_layout(bj, compact=True),
            packing.build_layout(bp, compact=True))


def _mutations(b):
    """{error: (field, mutated array)} for each value assumption of the
    compact encodings, on a copy of ``b``'s arrays."""
    x = np.asarray(b.x_atoms).copy()
    x[0, :] = 1.0                     # more nonzeros than k
    x_frac = np.asarray(b.x_atoms).copy()
    x_frac[0, np.flatnonzero(x_frac[0])[0]] = 0.5  # not int8-exact
    c = int(np.asarray(b.bg_mask).sum())
    dst = np.asarray(b.bg_dst).copy()
    i = int(np.flatnonzero(np.diff(dst[:c]))[0])
    dst[i], dst[i + 1] = dst[i + 1], dst[i]  # unsorted: no run lengths
    src = np.asarray(b.bg_src).copy()
    src[0] += 300                     # past a molecule's u8 offsets
    return {"nonzeros > k": ("x_atoms", x),
            "not int8-exact": ("x_atoms", x_frac),
            "not run-length-encodable": ("bg_dst", dst),
            "molecule-local-u8": ("bg_src", src)}


def test_compact_pack_raises_where_jax_does(ft_graphs, port_graphs):
    """``pack_batch`` on a compact layout raises, with the JAX package's
    message, where the JAX package's raises: k exceeded, values not
    int8-exact, bg_dst not run-length-encodable (a validating pack), bg_src
    not molecule-local u8."""
    from fragnet_tpu.data.packing import pack_batch as jax_pack

    bj, bp, lj, lp = _compact_pair(ft_graphs, port_graphs)
    assert lp.entry("bg_dst").enc == packing.RUNS8
    assert lp.entry("bg_src").enc == packing.LOC8
    np.testing.assert_array_equal(packing.pack_batch(bp, lp, validate=True),
                                  packing.pack_batch(bp, lp))
    for msg, (field, arr) in _mutations(bp).items():
        for pack, b, lay in ((packing.pack_batch, bp, lp),
                             (jax_pack, bj, lj)):
            bad = dataclasses.replace(b, **{field: arr})
            with pytest.raises(ValueError, match=msg):
                pack(bad, lay, validate=True)


def test_compact_train_step_matches_default(pt_graphs):
    """One packed pretraining step on compact buffers equals the step on
    the default profile's buffers of the same batches: loss and every
    gradient (1e-6), the decoded batches equal field for field; and
    make_pretrain_step's losses over the loader's batches (1e-6)."""
    from fragnet_tpu_torch.model.pretrain import FragNetPreTrain
    from fragnet_tpu_torch.train.optim import make_optimizer
    from fragnet_tpu_torch.train.pretrain import (make_pretrain_step,
                                                  pretrain_loss)

    _jg, pg = pt_graphs
    spec = _aligned(pg)
    out, steps = [], []
    for compact in (False, True):
        loader = BatchLoader(pg, 4, spec=spec, with_targets=True, pack=True,
                             pack_compact=compact)
        m = FragNetPreTrain(num_layer=1, num_heads=2, emb_dim=16,
                            drop_ratio=0.0,
                            generator=torch.Generator().manual_seed(0))
        levels = packing.plane_levels(m.policy)
        b = packing.unpack_batch(torch.from_numpy(next(iter(loader))),
                                 loader.layout, levels)
        m.train()
        loss = pretrain_loss(m(b), b)
        loss.backward()
        out.append((b, float(loss.detach()),
                    {n: p.grad for n, p in m.named_parameters()
                     if p.grad is not None}))
        # and through the packed step itself (train/pretrain.py)
        m2 = FragNetPreTrain(num_layer=1, num_heads=2, emb_dim=16,
                             drop_ratio=0.0,
                             generator=torch.Generator().manual_seed(0))
        opt, _ = make_optimizer(m2.parameters(), "adam", lr=1e-3)
        step = make_pretrain_step(m2, opt, layout=loader.layout,
                                  device="cpu")
        steps.append([float(step(buf)) for buf in loader])
    (b0, l0, g0), (b1, l1, g1) = out
    np.testing.assert_allclose(steps[1], steps[0], rtol=1e-6)
    _assert_decoded_equal(b0, b1, [f.name for f in dataclasses.fields(b0)])
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert set(g0) == set(g1)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(g0[n].abs().max()),
                                   err_msg=n)


def test_compact_loaders_in_every_packed_tier(port_graphs):
    """``BatchLoader(pack_compact=True)``: a spawned pack worker, the host
    and device packed caches all carry the compact layout and reproduce
    the thread stream's buffers."""
    def mk(**kw):
        return BatchLoader(port_graphs, 2, spec=_aligned(port_graphs),
                           pack=True, pack_compact=True, **kw)

    base = mk()
    ref = list(base)
    assert base.layout.entry("x_atoms").enc == packing.SPARSE8
    keys = sorted(b.tobytes() for b in ref)
    proc = mk()
    proc.layout = base.layout
    got = list(proc.stream(1, process=True, workers=1))
    assert [b.tobytes() for b in got] == [b.tobytes() for b in ref]
    host = PackedCacheLoader(mk())
    dev = DevicePackedCacheLoader(mk(), device="cpu")
    for cache in (host, dev):
        assert cache.layout.entry("bg_dst").enc == packing.RUNS8
        bufs = [np.asarray(b) for b in cache]
        assert sorted(b.tobytes() for b in bufs) == keys
    up = packing.unpack_batch(dev.bufs[0], dev.layout)
    assert up.tm_atom.flat_slot.dtype == torch.int32


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
