"""The port's ELL neighbour-table path (ops/ell.py, ``spec_for(...,
ell=True)``, the ELL branch of model/layers.py:_gat_dispatch) on the CPU
against fragnet_tpu's: the pass forward, attention by source and gradients
on seeded inputs with empty and full rows (f32 and bf16) and against the
port's own segment pass, ``build_ell_table`` with its overflow error, the
two-layer model on ELL batches with carried weights, the dispatch ladder
(TCSR before ELL; the variants keep their segment passes, as the JAX
package's do) and the paths that refuse ELL batches (packed transport,
edge-partitioned mode) with the JAX package's messages.

Tolerances: one pass 1e-5 (atol = rtol; the JAX package sums the logit
terms in f32, the port in f64), bf16 2e-2 of scale; the model 1e-4
relative (ROADMAP.md's parity table).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.data.packing import build_layout as jax_build_layout
from fragnet_tpu.dist.edge_partition import ep_batch_specs as jax_ep_specs
from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.ops.ell import build_ell_table as jax_build_ell_table
from fragnet_tpu.ops.ell import ell_gat_pass as jax_ell_gat_pass
from fragnet_tpu.train.loop import mse_loss as jax_mse

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.data.packing import build_layout, pack_batch
from fragnet_tpu_torch.dist.edge_partition import ep_local_batch
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model import layers
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.model.variants import FragNetFineTuneEdge
from fragnet_tpu_torch.ops.ell import build_ell_table, ell_gat_pass
from fragnet_tpu_torch.ops.segment import gat_attention_pass
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.loop import mse_loss

SMALL = dict(num_layer=2, num_heads=4, emb_dim=32, h1=16, h2=16, h3=16,
             h4=16)
TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


# --------------------------------------------------------------------------
# the pass
# --------------------------------------------------------------------------

def _case(seed, N=14, K=4, H=2, D=8, Da=3, n_pad=5):
    """Seeded inputs of one pass: every in-degree 0..K appears (row 0 is
    empty, row 1 full), edges in shuffled order, then ``n_pad`` padding
    edges (mask 0, ids 0); the table from the JAX package's
    build_ell_table."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, K + 1, N)
    deg[0], deg[1], deg[2:2 + K + 1] = 0, K, np.arange(K + 1)
    dst = np.repeat(np.arange(N), deg)
    src = rng.integers(0, N, dst.size)
    order = rng.permutation(dst.size)
    E = dst.size + n_pad
    pad = np.zeros(n_pad, np.int64)
    src = np.concatenate([src[order], pad]).astype(np.int32)
    dst = np.concatenate([dst[order], pad]).astype(np.int32)
    mask = np.r_[np.ones(E - n_pad), np.zeros(n_pad)].astype(np.float32)
    nbr, nmask = jax_build_ell_table(dst, N, K, edge_mask=mask)
    return dict(
        nf=rng.standard_normal((N, H, D)).astype(np.float32),
        ea=rng.standard_normal((E, Da)).astype(np.float32),
        src=src, dst=dst, mask=mask, nbr=np.asarray(nbr),
        nmask=np.asarray(nmask),
        avec=(0.5 * rng.standard_normal((H, 2 * D + Da))).astype(np.float32),
        g_out=rng.standard_normal((N, H, D)).astype(np.float32),
        g_attn=rng.standard_normal((N, H)).astype(np.float32))


def _jax_pass(c, dt=jnp.float32):
    """JAX's pass: (out, attn, d_nf, d_ea, d_avec) of Σ out·g_out +
    Σ attn·g_attn, as f32 numpy."""
    def f(nf, ea, avec):
        out, attn = jax_ell_gat_pass(nf, ea, jnp.asarray(c["src"]),
                                     jnp.asarray(c["nbr"]),
                                     jnp.asarray(c["nmask"]), avec,
                                     num_src_nodes=c["nf"].shape[0])
        return out, attn

    prim = (jnp.asarray(c["nf"], dt), jnp.asarray(c["ea"], dt),
            jnp.asarray(c["avec"]))
    (out, attn), vjp = jax.vjp(f, *prim)
    grads = vjp((jnp.asarray(c["g_out"], out.dtype),
                 jnp.asarray(c["g_attn"], attn.dtype)))
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in (out, attn, *grads)]


def _port(c, fn, dt=torch.float32):
    """The port's pass ``fn(nf, ea, avec) -> (out, attn)``: the same five
    arrays."""
    nf = torch.from_numpy(c["nf"]).to(dt).requires_grad_()
    ea = torch.from_numpy(c["ea"]).to(dt).requires_grad_()
    avec = torch.from_numpy(c["avec"]).requires_grad_()
    out, attn = fn(nf, ea, avec)
    (torch.sum(out.float() * torch.from_numpy(c["g_out"]))
     + torch.sum(attn * torch.from_numpy(c["g_attn"]))).backward()
    return [x.detach().float().numpy()
            for x in (out, attn, nf.grad, ea.grad, avec.grad)]


def _port_ell(c):
    def fn(nf, ea, avec):
        return ell_gat_pass(nf, ea, torch.from_numpy(c["src"]),
                            torch.from_numpy(c["nbr"]),
                            torch.from_numpy(c["nmask"]), avec,
                            num_src_nodes=nf.shape[0])
    return fn


_NAMES = ("out", "attn_by_src", "d_nf", "d_ea", "d_avec")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ell_pass_matches_jax(seed):
    """Forward, attention by source and gradients (1e-5); the empty row's
    output and attention are exactly 0 and nothing is NaN."""
    c = _case(seed)
    want = _jax_pass(c)
    got = _port(c, _port_ell(c))
    for name, g, w in zip(_NAMES, got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    assert not got[0][0].any()  # row 0 has no neighbour
    assert np.count_nonzero(c["nmask"].sum(1) == c["nbr"].shape[1]) >= 1


def test_ell_pass_matches_the_segment_pass():
    """The port's ELL and segment passes on the same edges (1e-5)."""
    c = _case(3)

    def seg(nf, ea, avec):
        attr_h = ea[:, None, :].expand(ea.shape[0], nf.shape[1], ea.shape[1])
        return gat_attention_pass(
            nf, attr_h, torch.from_numpy(c["src"]).long(),
            torch.from_numpy(c["dst"]).long(), avec, nf.shape[0],
            edge_mask=torch.from_numpy(c["mask"]))

    for name, g, w in zip(_NAMES, _port(c, _port_ell(c)), _port(c, seg)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


def test_ell_pass_bf16_matches_jax():
    """bf16 node features and attributes: the output is bf16, as JAX's;
    every array within 2e-2 of its scale."""
    c = _case(4)
    want = _jax_pass(c, jnp.bfloat16)
    nf = torch.from_numpy(c["nf"]).bfloat16()
    out, _ = _port_ell(c)(nf, torch.from_numpy(c["ea"]).bfloat16(),
                          torch.from_numpy(c["avec"]))
    assert out.dtype == torch.bfloat16
    got = _port(c, _port_ell(c), torch.bfloat16)
    for name, g, w in zip(_NAMES, got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=BF16_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_build_ell_table_matches_jax():
    """Tables equal to the JAX package's (with and without a mask), and the
    same overflow error."""
    c = _case(5)
    K = c["nbr"].shape[1]
    for kw in (dict(edge_mask=c["mask"]), {}):
        for k in (K + 1, K + 3) if not kw else (K, K + 2):
            got = build_ell_table(c["dst"], 14, k, **kw)
            want = jax_build_ell_table(c["dst"], 14, k, **kw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    empty = build_ell_table(c["dst"], 14, K, edge_mask=np.zeros_like(
        c["mask"]))
    assert not empty[0].any() and not empty[1].any()
    with pytest.raises(ValueError) as jerr:
        jax_build_ell_table(c["dst"], 14, K - 1, edge_mask=c["mask"])
    with pytest.raises(ValueError) as perr:
        build_ell_table(c["dst"], 14, K - 1, edge_mask=c["mask"])
    assert str(perr.value) == str(jerr.value)
    assert "exceeds ELL width" in str(perr.value)


# --------------------------------------------------------------------------
# the model on ELL batches
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = PortBuilder("exp1s")
    return [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                          smiles=g.smiles) for g in ft_graphs]


@pytest.fixture(scope="module")
def ell_batches(ft_graphs, port_graphs):
    """(JAX batch, port batch) of all eight molecules with ELL tables and
    no kernel metadata."""
    sj = jax_spec_for(ft_graphs, batch_size=len(ft_graphs), ell=True)
    sp = spec_for(port_graphs, batch_size=len(port_graphs), ell=True)
    assert dataclasses.asdict(sp) == dataclasses.asdict(sj)
    assert sp.k_atom is not None
    bp = pad_batch(port_graphs, sp)
    assert bp.atom_nbr_edge is not None and bp.tm_atom is None
    return _jnp(jax_pad_batch(ft_graphs, sj)), bp


@pytest.fixture(scope="module")
def carried(ell_batches):
    model = JaxModel(**SMALL)
    params = model.init(jax.random.PRNGKey(0), ell_batches[0],
                        deterministic=True)
    port = FragNetFineTune(**SMALL)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, params, port.eval()


def _close(port, ref, rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _count_ell(monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return ell_gat_pass(*a, **kw)

    monkeypatch.setattr(layers, "ell_gat_pass", spy)
    return calls


def test_model_forward_and_attentions_match_jax(ell_batches, carried,
                                                monkeypatch):
    """Every pass of both layers takes the ELL branch (4 per layer); the
    prediction and the four attention vectors 1e-4 relative."""
    model, params, port = carried
    bj, bp = ell_batches
    calls = _count_ell(monkeypatch)
    pred_j, attn_j = model.apply(params, bj, deterministic=True,
                                 return_attentions=True)
    with torch.no_grad():
        pred_p, attn_p = port(to_device(bp, "cpu"), return_attentions=True)
    assert len(calls) == 4 * SMALL["num_layer"]
    _close(pred_p, pred_j)
    for level in ("atoms", "frags", "bonds", "fbonds"):
        _close(getattr(attn_p, level), getattr(attn_j, level))


def test_model_gradients_match_jax(ell_batches, carried):
    """The MSE and every parameter's gradient against jax.grad (1e-4
    relative; a gradient 0 in exact arithmetic, 1e-6 of the largest)."""
    model, params, port = carried
    bj, bp = ell_batches

    def loss(p):
        return jax_mse(model.apply(p, bj, deterministic=True), bj.y,
                       bj.graph_mask)

    loss_j, grads_j = jax.value_and_grad(loss)(params)
    want = state_dict_from_jax(jax.device_get(grads_j))
    b = to_device(bp, "cpu")
    port.zero_grad(set_to_none=True)
    loss_p = mse_loss(port(b), b.y, b.graph_mask)
    loss_p.backward()
    try:
        _close(loss_p, loss_j)
        names = dict(port.named_parameters())
        assert set(names) == set(want)
        scale = max(float(w.abs().max()) for w in want.values())
        for name, p in names.items():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            if float(want[name].abs().max()) <= 1e-6 * scale:
                assert float(got.abs().max()) <= 1e-6 * scale, name
            else:
                _close(got, want[name])
    finally:
        port.zero_grad(set_to_none=True)


def test_ladder_takes_tcsr_over_ell(ft_graphs, port_graphs, carried,
                                    monkeypatch):
    """A batch with TileMeta and ELL tables runs the TCSR pass, as JAX's
    ladder does (both packages' predictions 1e-4); the variants, whose JAX
    layers call the segment pass, leave an ELL batch's tables alone."""
    model, params, port = carried
    kw = dict(batch_size=len(ft_graphs), ell=True, tcsr=True, align=False)
    bj = _jnp(jax_pad_batch(ft_graphs, jax_spec_for(ft_graphs, **kw)))
    bp = pad_batch(port_graphs, spec_for(port_graphs, **kw))
    assert bp.atom_nbr_edge is not None and bp.tm_atom is not None
    calls = _count_ell(monkeypatch)
    n_tcsr = []
    tcsr = layers.tcsr_gat_pass

    def tcsr_spy(*a, **k):
        n_tcsr.append(1)
        return tcsr(*a, **k)

    monkeypatch.setattr(layers, "tcsr_gat_pass", tcsr_spy)
    with torch.no_grad():
        pred = port(to_device(bp, "cpu"))
    assert calls == [] and len(n_tcsr) == 4 * SMALL["num_layer"]
    _close(pred, model.apply(params, bj, deterministic=True))

    ell_only = dataclasses.replace(bp, tm_atom=None, tm_bond=None,
                                   tm_frag=None, tm_fc=None)
    edge = FragNetFineTuneEdge(**SMALL).eval()
    with torch.no_grad():
        edge(to_device(ell_only, "cpu"))
    assert calls == []


def test_loaders_carry_ell_tables(ft_graphs, port_graphs):
    """The bucketed loader with ``spec_kwargs={"ell": True}`` builds the
    JAX package's bucket specs and batches (tables equal); BatchLoader and
    DeviceCacheLoader carry the tables, the latter as tensors."""
    import fragnet_tpu.data.batcher as jax_batcher
    from fragnet_tpu_torch.data import batcher

    kw = dict(n_buckets=2, n_tasks=1, spec_kwargs={"ell": True})
    jl = jax_batcher.BucketedBatchLoader(ft_graphs, 2, to_device=False, **kw)
    pl = batcher.BucketedBatchLoader(port_graphs, 2, **kw)
    assert [dataclasses.asdict(s) for s in pl.specs] == \
        [dataclasses.asdict(s) for s in jl.specs]
    first = next(iter(pl))
    names = [f.name for f in dataclasses.fields(first) if "_nbr_" in f.name]
    assert len(names) == 8 and first.atom_nbr_edge is not None
    for bj, bp in zip(jl, pl):
        for n in names:
            np.testing.assert_array_equal(np.asarray(getattr(bj, n)),
                                          getattr(bp, n), err_msg=n)
    loader = batcher.BatchLoader(port_graphs, 4, spec=spec_for(
        port_graphs, 4, ell=True))
    cached = list(batcher.DeviceCacheLoader(loader, device="cpu"))
    assert len(cached) == len(loader)
    for b in cached:
        for n in names:
            assert isinstance(getattr(b, n), torch.Tensor), n


def test_packing_and_ep_refuse_ell_batches(ell_batches):
    """The packed transport and the edge-partitioned mode refuse a batch
    with ELL tables, with the JAX package's messages."""
    bj, bp = ell_batches
    msg = "packed transport does not support the ELL path"
    with pytest.raises(ValueError, match=msg):
        jax_build_layout(jax.device_get(bj))
    with pytest.raises(ValueError, match=msg):
        build_layout(bp)
    plain = dataclasses.replace(bp, **{f.name: None for f in
                                       dataclasses.fields(bp)
                                       if "_nbr_" in f.name})
    layout = build_layout(plain)
    pack_batch(plain, layout)
    with pytest.raises(ValueError, match=msg):
        pack_batch(bp, layout)
    msg = "edge-partitioned mode does not support ELL tables"
    with pytest.raises(ValueError, match=msg):
        jax_ep_specs(bj)
    with pytest.raises(ValueError, match=msg):
        ep_local_batch(bp, 0, 2)
    ep_local_batch(plain, 0, 2)


def test_cuda_dispatch_takes_ell_where_it_would_raise():
    """Off the CPU a pass with no kernel metadata raises unless it has
    ELL tables (a meta-device tensor stands in for a CUDA one): the
    message names both remedies."""
    nf = torch.empty((8, 4, 8), device="meta")
    idx = torch.empty((8,), dtype=torch.int32, device="meta")
    ea = torch.empty((8, 4), device="meta")
    mask = torch.empty((8,), device="meta")
    avec = torch.empty((4, 20), device="meta")
    with pytest.raises(RuntimeError, match=r"ell=True"):
        layers._gat_dispatch(nf, ea, idx, idx, mask, avec, num_nodes=8,
                             tm=None, dp=None, mode="tcsr")
    nbr = (torch.empty((8, 3), dtype=torch.int32, device="meta"),
           torch.empty((8, 3), device="meta"))
    out, attn = layers._gat_dispatch(nf, ea, idx, idx, mask, avec,
                                     num_nodes=8, tm=None, dp=None,
                                     mode="tcsr", nbr=nbr, need_attn=True)
    assert tuple(out.shape) == (8, 4, 8) and tuple(attn.shape) == (8, 4)
