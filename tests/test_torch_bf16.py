"""bf16 compute in the port against fragnet_tpu's, on the CPU: the GAT passes
(the plain versions of K1/K2 and K4/K5, and the segment pass), the whole
gat2 model and the three models on its encoder, the fast-path policy,
``run_finetune`` with ``finetune.dtype=bf16`` (the default policy, the
dense-attr policy, ``dist.mode=dp|ep``), and what still refuses bf16:
``run_task``, whose reference trainers run f32 only, and every type but f32
and bf16 (tests/test_torch_bf16_paths.py holds the other bf16 paths).

Inputs are made with numpy from a seed and rounded to bf16 once, so both
packages see the same bf16 values; weights are carried across with
``state_dict_from_jax`` (parameters stay f32 in both). The JAX side runs
its Pallas kernels in interpret mode, as its own tests do. Tolerances:

* a pass's f32 outputs and gradients (the attention vector, the logit
  gradients d_a, d_v, d_c): atol = rtol = 1e-5, as the f32 pass tests
  (test_torch_ops.py) — the same f32 sums in another order;
* a pass's bf16 outputs and bf16 gradients (out, d_nf, d_ea): within one
  bf16 ulp of the larger value — both round the same f32 sum, taken in
  another order, once;
* the whole model: predictions within 2e-2 of their scale of JAX bf16's,
  and the port's distance from JAX f32 at most twice JAX bf16's own
  distance from JAX f32 plus 1e-3 of the scale (bf16 rounds at other
  places in the two frameworks; the gap of bf16 itself is the yardstick);
  every parameter gradient within 5e-2 of its own scale, or of 1e-4 of the
  largest gradient where its own is below that: the embed biases' gradients
  are 0 in exact arithmetic (a bias shifts every logit of a softmax
  alike), so both packages give bf16 round-off there, as the f32 tests
  hold such gradients to 1e-6 of the largest. The measured values are
  printed (``-s``).

Small model: 2 layers, emb 32, 4 heads; torch and BLAS pinned to one
thread. The JAX compiles are shared through module fixtures.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model import transformer as jt
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.ops import segment as jseg
from fragnet_tpu.ops.dense_gat import dense_gat_pass as jax_dense_pass
from fragnet_tpu.ops.pallas_gat import pallas_gat_pass
from fragnet_tpu.ops.tcsr import build_tile_meta as jax_tile_meta
from fragnet_tpu.train import fastpath as jfastpath
from fragnet_tpu.train.loop import mse_loss as jax_mse

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.model import transformer as pt
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.ops import dense_gat, segment, tcsr_gat
from fragnet_tpu_torch.ops.dense_gat import build_dense_planes
from fragnet_tpu_torch.ops.tcsr import build_tile_meta
from fragnet_tpu_torch.train import fastpath
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import (MODEL_VERSIONS, build_model,
                                              run_finetune)
from fragnet_tpu_torch.train.loop import mse_loss

BF = torch.bfloat16
TOL32 = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(num_layer=2, num_heads=4, emb_dim=32)
HEAD = dict(h1=16, h2=16, h3=16, h4=16)
FAMILIES = {
    "gat2_transformer": (jt.FragNetFineTuneTransformer,
                         pt.FragNetFineTuneTransformer,
                         dict(h1=16, transformer_heads=2)),
    "gat2_transformer2": (jt.FragNetFineTuneTransformer2,
                          pt.FragNetFineTuneTransformer2,
                          dict(h1=16, num_attn_layer2=1, max_seq_len=32)),
    "gat2_multitask": (jt.FragNetFineTuneMultiTask,
                       pt.FragNetFineTuneMultiTask,
                       dict(n_multi_task_heads=2)),
}
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None)
PRED_LIMIT, GRAD_LIMIT, GRAD_FLOOR = 2e-2, 5e-2, 1e-4


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
    two (8 significant bits: ulp(x) = 2^(⌊log2 |x|⌋ − 7)), or within
    ``atol`` · max|ref|."""
    assert port.dtype == BF and ref.dtype == jnp.bfloat16, name
    p, r = _np(port), _np(ref)
    big = np.maximum(np.abs(p), np.abs(r))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    err = np.abs(p - r)
    n_ulp = np.where(err <= atol * float(np.abs(r).max()), 0.0, err / ulp)
    print(f"{name}: max {float(n_ulp.max()):.2f} bf16 ulp, "
          f"{int((p != r).sum())} of {p.size} differ")
    assert float(n_ulp.max()) <= 1.0, name


# --------------------------------------------------------------------------
# the passes: plain versions of K1/K2 and K4/K5, and the segment pass
# --------------------------------------------------------------------------

def _tile_graph(rng, tn, n_tiles, E, cross=False):
    """Edges sorted by dst, the last tile empty, padded to E; with
    ``cross`` sources reach into the next tile (k_src = 2) and one real
    edge is masked."""
    src, dst = [], []
    for t in range(n_tiles - 1):
        for _ in range(int(rng.integers(12, 40))):
            dst.append(t * tn + int(rng.integers(0, tn)))
            src.append(t * tn + int(rng.integers(0, (2 if cross else 1)
                                                 * tn)))
    if not cross:  # tile-local without repeated (dst, src) pairs
        pairs = sorted(set(zip(dst, src)))
        dst, src = [d for d, _ in pairs], [s for _, s in pairs]
    order = np.argsort(dst, kind="stable")
    s = np.zeros(E, np.int32)
    d = np.zeros(E, np.int32)
    m = np.zeros(E, np.float32)
    s[:len(order)] = np.array(src)[order]
    d[:len(order)] = np.array(dst)[order]
    m[:len(order)] = 1.0
    if cross:
        m[2] = 0.0
    return s, d, m


def _torch_meta(meta):
    return dataclasses.replace(
        meta, **{f: torch.from_numpy(getattr(meta, f))
                 for f in ("ew_blk", "sw_tile", "flat_slot", "cw")})


@pytest.mark.parametrize("case", ["local", "local-self-loops",
                                  "cross-tile-self-loops"])
def test_tcsr_pass_bf16_matches_pallas(case):
    """K1's and K2's plain versions in bf16 (through TcsrGatFn) against
    pallas_gat_pass(..., interpret=True) in bf16: out, the attention vector
    and jax.vjp's d_nf, d_ea, d_a."""
    rng = np.random.default_rng(31)
    self_loops = case.endswith("self-loops")
    tn, te, n_tiles, H, D, Da, E = 16, 16, 3, 4, 8, 12, 160
    N = tn * n_tiles
    src, dst, mask = _tile_graph(rng, tn, n_tiles, E,
                                 cross=case.startswith("cross"))
    nf_t, nf_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    ea_t, ea_j = _bf16(rng.standard_normal((E, Da)).astype(np.float32))
    g_t, g_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)
    meta_j = jax_tile_meta(src, dst, mask, N, tn=tn, te=te)
    meta = _torch_meta(build_tile_meta(src, dst, mask, N, tn=tn, te=te))

    def f(nf_, ea_, a_):
        return pallas_gat_pass(nf_, ea_, jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(mask), a_, meta_j,
                               self_loops=self_loops, interpret=True)

    (out_j, attn_j), vjp = jax.vjp(f, nf_j, ea_j, jnp.asarray(a))
    d_nf_j, d_ea_j, d_a_j = vjp((g_j, jnp.zeros_like(attn_j)))
    t = torch.from_numpy
    xs = [nf_t.clone().requires_grad_(), ea_t.clone().requires_grad_(),
          t(a).requires_grad_()]
    n0 = tcsr_gat.KERNEL_BF16.launches, tcsr_gat.KERNEL_BWD_BF16.launches
    out_p, attn_p = tcsr_gat.tcsr_gat_pass(
        xs[0], xs[1], t(src), t(dst), t(mask), xs[2], meta,
        self_loops=self_loops, return_attention=True)
    d_nf, d_ea, d_a = torch.autograd.grad((out_p.float() * g_t.float()).sum(),
                                          xs)
    # CPU tensors: the plain versions, no launch
    assert (tcsr_gat.KERNEL_BF16.launches,
            tcsr_gat.KERNEL_BWD_BF16.launches) == n0
    assert out_p.dtype == BF and d_nf.dtype == BF and d_a.dtype == torch.float32
    _within_ulp(out_p, out_j, f"tcsr {case} out")
    _close32(attn_p, attn_j)
    _within_ulp(d_nf, d_nf_j, f"tcsr {case} d_nf", atol=1e-5)
    # d_ea of a one-neighbour destination is 0 in exact arithmetic: the port
    # gets 0 (its s, from the f32 out, equals the kernel's dot exactly),
    # JAX round-off of its own sums (~1e-8), held as an f32 gradient is
    _within_ulp(d_ea, d_ea_j, f"tcsr {case} d_ea", atol=1e-5)
    _close32(d_a, d_a_j)


@pytest.mark.parametrize("R", [1, 6])
def test_dense_pass_bf16_matches_pallas(R):
    """K4's and K5's plain versions in bf16 (through DenseGatFn) against
    dense_gat_pass(..., interpret=True) in bf16: out, the attention vector
    and jax.vjp's d_nf, d_v, d_c, d_a."""
    rng = np.random.default_rng(41 + R)
    tn, n_tiles, H, D, Da, E = 16, 3, 4, 8, 8, 160
    N = tn * n_tiles
    src, dst, mask = _tile_graph(rng, tn, n_tiles, E)
    planes = build_dense_planes(src, dst, mask,
                                rng.standard_normal((E, R)).astype(np.float32),
                                N, tn=tn)
    assert planes is not None
    nf_t, nf_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    ea_t, ea_j = _bf16(rng.standard_normal((E, Da)).astype(np.float32))
    g_t, g_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    a, v, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((H, 2 * D + Da), (R, H), (H,)))

    def f(nf_, v_, c_, a_):
        return jax_dense_pass(nf_, jnp.asarray(planes), v_, c_, ea_j,
                              jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(mask), a_, interpret=True)

    (out_j, attn_j), vjp = jax.vjp(f, nf_j, *(jnp.asarray(x)
                                              for x in (v, c, a)))
    grads_j = vjp((g_j, jnp.zeros_like(attn_j)))
    t = torch.from_numpy
    xs = [nf_t.clone().requires_grad_()] + [t(x).requires_grad_()
                                            for x in (v, c, a)]
    n0 = dense_gat.KERNEL_BF16.launches, dense_gat.KERNEL_BWD_BF16.launches
    out_p, attn_p = dense_gat.dense_gat_pass(
        xs[0], t(planes), xs[1], xs[2], ea_t, t(src), t(dst), t(mask), xs[3],
        return_attention=True)
    grads_p = torch.autograd.grad((out_p.float() * g_t.float()).sum(), xs)
    assert (dense_gat.KERNEL_BF16.launches,
            dense_gat.KERNEL_BWD_BF16.launches) == n0
    _within_ulp(out_p, out_j, f"dense R={R} out")
    _close32(attn_p, attn_j)
    _within_ulp(grads_p[0], grads_j[0], f"dense R={R} d_nf", atol=1e-5)
    for gp, gj in zip(grads_p[1:], grads_j[1:]):
        _close32(gp, gj)
    assert float(out_p[2 * tn:].float().abs().max()) == 0.0  # empty tile


def test_segment_pass_bf16_matches_jax():
    """ops/segment.py:gat_attention_pass with bf16 node features and edge
    attributes against the JAX one: f32 logits and softmax, the
    probabilities cast to bf16 before the weighted bf16 segment sum
    (probs.to(h_src.dtype)). out within one bf16 ulp, the attention f32 to
    1e-5. d_nf is a sum of bf16 products accumulated in bf16 (the gathers'
    backward scatter-adds), which the two frameworks round at other
    places: held as the model's predictions are, within 2e-2 of its scale
    of JAX bf16's, and the port's distance from the f32 gradient at most
    twice JAX bf16's plus 1e-3 of the scale."""
    rng = np.random.default_rng(51)
    N, E, H, D, Da = 10, 40, 4, 8, 6
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N - 2, E).astype(np.int32)
    mask = (rng.random(E) > 0.2).astype(np.float32)
    nf_t, nf_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    ea_t, ea_j = _bf16(rng.standard_normal((E, H, Da)).astype(np.float32))
    g_t, g_j = _bf16(rng.standard_normal((N, H, D)).astype(np.float32))
    a = rng.standard_normal((H, 2 * D + Da)).astype(np.float32)

    def f(nf_, ea_):
        return jseg.gat_attention_pass(
            nf_, ea_, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(a), N,
            edge_mask=jnp.asarray(mask))

    (out_j, attn_j), vjp = jax.vjp(f, nf_j, ea_j)
    d_nf_j = _np(vjp((g_j, jnp.zeros_like(attn_j)))[0])
    f32 = jnp.float32
    (_, attn32), vjp32 = jax.vjp(f, nf_j.astype(f32), ea_j.astype(f32))
    d_nf32 = _np(vjp32((g_j.astype(f32), jnp.zeros_like(attn32)))[0])
    t = torch.from_numpy
    nf = nf_t.clone().requires_grad_()
    out_p, attn_p = segment.gat_attention_pass(
        nf, ea_t, t(src), t(dst), t(a), N, edge_mask=t(mask))
    (d_nf,) = torch.autograd.grad((out_p * g_t).sum(), [nf])
    assert out_p.dtype == BF and attn_p.dtype == torch.float32
    assert d_nf.dtype == BF
    _within_ulp(out_p, out_j, "segment out")
    _close32(attn_p, attn_j)
    d_nf = _np(d_nf)
    scale = float(np.abs(d_nf32).max())
    d_pj = float(np.abs(d_nf - d_nf_j).max()) / scale
    d_p32 = float(np.abs(d_nf - d_nf32).max()) / scale
    d_j32 = float(np.abs(d_nf_j - d_nf32).max()) / scale
    print(f"segment d_nf: |port - jax bf16| {d_pj:.3e} of scale, |port - "
          f"f32| {d_p32:.3e}, |jax bf16 - f32| {d_j32:.3e}")
    assert d_pj <= PRED_LIMIT
    assert d_p32 <= 2 * d_j32 + 1e-3


# --------------------------------------------------------------------------
# the whole model: gat2 and the three models on its encoder
# --------------------------------------------------------------------------

def _jnp(b):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        b)


@pytest.fixture(scope="module")
def aligned(ft_graphs):
    """(JAX batch, port batch): seven of the eight molecules (the first
    seven) and one padding graph, tile-aligned with TCSR metadata and
    planes."""
    builder = PortBuilder("exp1s")
    jg = ft_graphs[:7]
    pg = [builder.build(*port_engine.mol_3d(g.smiles), g.y, smiles=g.smiles)
          for g in jg]
    kw = dict(batch_size=len(jg) + 1, tcsr=True, align=True)
    bj = jax_pad_batch(jg, jax_spec_for(jg, **kw))
    bp = pad_batch(pg, spec_for(pg, **kw))
    assert bp.tm_atom is not None and bp.dp_bond is not None
    return _jnp(bj), bp


def _compare_model(label, jmodels, params, port, bj, bp):
    """The bounds of the module docstring for one model on one batch:
    prediction (the port's bf16 against JAX bf16 and JAX f32) and every
    parameter gradient of the MSE against jax.grad of the JAX bf16 model.
    Returns the measured values."""
    j32, j16 = jmodels
    y32 = np.asarray(j32.apply(params, bj, deterministic=True), np.float32)

    def loss(p):
        # a multi-task model's heads all fit the one label
        pred = j16.apply(p, bj, deterministic=True)
        return jax_mse(pred, jnp.broadcast_to(bj.y, pred.shape),
                       bj.graph_mask), pred

    (loss_j, y16), grads_j = jax.value_and_grad(loss, has_aux=True)(params)
    y16 = np.asarray(y16, np.float32)
    want = state_dict_from_jax(jax.device_get(grads_j))
    b = to_device(bp, "cpu")
    port.zero_grad(set_to_none=True)
    pred = port(b)
    loss_p = mse_loss(pred, b.y.expand_as(pred), b.graph_mask)
    loss_p.backward()
    yp = pred.detach().numpy()
    assert pred.dtype == torch.float32 and np.isfinite(yp).all()
    scale = float(np.abs(y32).max())
    d_pj = float(np.abs(yp - y16).max()) / scale
    d_p32 = float(np.abs(yp - y32).max()) / scale
    d_j32 = float(np.abs(y16 - y32).max()) / scale
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    worst, worst_name = 0.0, None
    for name, p in names.items():
        assert p.dtype == torch.float32, name  # parameters stay f32
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert bool(torch.isfinite(got).all()), name
        w = want[name]
        rel = float((got - w).abs().max()) / max(float(w.abs().max()),
                                                 GRAD_FLOOR * top, 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    port.zero_grad(set_to_none=True)
    print(f"{label}: prediction |port - jax bf16| {d_pj:.3e} of scale "
          f"(limit {PRED_LIMIT}); |port - jax f32| {d_p32:.3e}, |jax bf16 "
          f"- jax f32| {d_j32:.3e} (limit 2x + 1e-3); loss {float(loss_p):.6f}"
          f" / {float(loss_j):.6f}; worst gradient {worst:.3e} of scale "
          f"({worst_name}; limit {GRAD_LIMIT})")
    assert d_pj <= PRED_LIMIT
    assert d_p32 <= 2 * d_j32 + 1e-3
    assert worst <= GRAD_LIMIT
    return d_pj, d_p32, d_j32, worst


@pytest.fixture(scope="module")
def gat2_carried(aligned):
    """The JAX f32 and bf16 gat2 models, the bf16 model's params (f32) and
    the port's bf16 model holding them."""
    j16 = JaxModel(**SMALL, **HEAD, dtype=jnp.bfloat16)
    params = j16.init(jax.random.PRNGKey(0),
                      dataclasses.replace(aligned[0], **_NO_KERNELS),
                      deterministic=True)
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(params))
    port = FragNetFineTune(**SMALL, **HEAD, dtype=BF)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return (JaxModel(**SMALL, **HEAD), j16), params, port.eval()


@pytest.mark.parametrize("path", ["aligned-tcsr", "segment"])
def test_gat2_bf16_matches_jax(aligned, gat2_carried, path):
    jmodels, params, port = gat2_carried
    bj, bp = aligned
    if path == "segment":
        bj = dataclasses.replace(bj, **_NO_KERNELS)
        bp = dataclasses.replace(bp, **_NO_KERNELS)
    _compare_model(f"gat2 {path}", jmodels, params, port, bj, bp)


@pytest.mark.parametrize("mv", list(FAMILIES))
def test_gat2_encoder_families_bf16_match_jax(aligned, mv):
    """gat2_transformer, gat2_transformer2 and gat2_multitask in bf16 on
    the aligned-tcsr route: the encoder in bf16, the post-processing in
    f32 (the promoted type)."""
    jcls, pcls, extra = FAMILIES[mv]
    j16 = jcls(**SMALL, **extra, dtype=jnp.bfloat16)
    params = j16.init(jax.random.PRNGKey(3),
                      dataclasses.replace(aligned[0], **_NO_KERNELS),
                      deterministic=True)
    port = pcls(**SMALL, **extra, dtype=BF)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    _compare_model(mv, (jcls(**SMALL, **extra), j16), params, port.eval(),
                   *aligned)


# --------------------------------------------------------------------------
# the fast-path policy, run_finetune and the refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mv", MODEL_VERSIONS + ("gat2_masked",
                                                 "gat2_masked2"))
def test_fastpath_dtype_matches_jax(mv):
    """fastpath.resolve's dtype_name and supports_dtype against the JAX
    package's for every model_version, at each spelling of the key (off
    the TPU the JAX default is f32, as the port's)."""
    assert fastpath.supports_dtype(mv) == jfastpath.supports_dtype(mv)
    for section in ({}, {"dtype": "bf16"}, {"dtype": "bfloat16"},
                    {"dtype": "f32"}, {"dtype": "float32"}):
        want = jfastpath.resolve(section, model_version=mv).dtype_name
        fp = fastpath.resolve(section, model_version=mv, device="cpu")
        assert fp.dtype_name == want, (mv, section)
        assert fp.dtype == {"bf16": BF, "f32": torch.float32}[want]


def _small_opt(tmp_path, **finetune):
    return Config({
        "seed": 7, "exp_dir": str(tmp_path), "model_version": "gat2",
        "finetune": {
            "data": {"name": "esol", "split": "random", "n_synthetic": 16},
            "model": dict(SMALL, **HEAD, drop_ratio=0.1, act="relu",
                          fthead="FTHead3"),
            "target_type": "regr", "batch_size": 4, "n_epochs": 1,
            "dtype": "bf16", **finetune},
    })


def test_run_finetune_bf16_cpu_trains_and_predicts(tmp_path, capsys):
    """run_finetune(device="cpu") with finetune.dtype=bf16 on the TCSR
    batches (the plain versions): one epoch of training, predictions
    written; the model computes in bf16 and keeps f32 parameters."""
    rmse, model = run_finetune(_small_opt(tmp_path, tcsr=True),
                               device="cpu")
    out = capsys.readouterr().out
    assert "dtype=bf16" in out and "test rmse:" in out
    assert all(layer.dtype == BF for layer in model.pretrain.layers)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with open(tmp_path / "preds_seed_7.pkl", "rb") as f:
        preds = pickle.load(f)
    assert preds["pred"].shape == preds["y"].shape
    assert np.isfinite(preds["pred"]).all() and np.isfinite(rmse)
    assert rmse == preds["rmse"]


def test_build_model_passes_dtype_to_its_families_only(tmp_path):
    """build_model gives bf16 to gat2 and the models on its encoder and
    builds the others in f32, as the JAX package's build_model does."""
    for mv in MODEL_VERSIONS:
        opt = _small_opt(tmp_path)
        opt.set_path("model_version", mv)
        model = build_model(opt, n_classes=1, dtype=BF)
        layers = [m for m in model.modules() if hasattr(m, "num_heads")
                  and hasattr(m, "policy")]
        dts = {m.dtype for m in layers}
        if fastpath.supports_dtype(mv):
            assert dts == {BF}, mv
        else:
            assert dts <= {torch.float32}, mv


_DIST = {"dp": {"mode": "dp", "n_devices": 2},
         "ep": {"mode": "ep", "n_devices": 2}}


@pytest.fixture(scope="module")
def port_datasets(ft_graphs):
    """(train, val, test, n_tasks, task) of the port's graphs of the eight
    molecules: 4 / 2 / 2."""
    builder = PortBuilder("exp1s")
    pg = [builder.build(*port_engine.mol_3d(g.smiles), g.y, smiles=g.smiles)
          for g in ft_graphs]
    return pg[:4], pg[4:6], pg[6:], 1, "regr"


@pytest.mark.parametrize("case", ["kernel.attr", "kernel.fc=attr", "dp",
                                  "ep"])
def test_run_finetune_bf16_refuses_what_slice_16_runs(tmp_path, capsys,
                                                      port_datasets, case):
    """run_finetune(device="cpu") with finetune.dtype=bf16 under the
    dense-attr policy (kernel.attr, kernel.fc=attr: the plain versions of
    K7, K8 and K9 in bf16) and under dist.mode=dp|ep over two gloo ranks
    (K3's bf16 plain versions under ep): one epoch trains, the test metric
    and the predictions are written, and the model that comes back
    computes in bf16 with f32 parameters; the ranks agree."""
    kernel = {"kernel.attr": {"attr": True},
              "kernel.fc=attr": {"fc": "attr"}}.get(case, {})
    opt = _small_opt(tmp_path, tcsr=True, kernel=kernel)
    reports = []
    if case in _DIST:
        opt.set_path("dist", dict(_DIST[case], timeout_s=120,
                                  join_timeout_s=300))
    rmse, model = run_finetune(opt, device="cpu", datasets=port_datasets,
                               rank_reports=reports)
    if case not in _DIST:  # ranks print in their own processes
        out = capsys.readouterr().out
        assert "dtype=bf16" in out and "test rmse:" in out
    assert all(layer.dtype == BF for layer in model.pretrain.layers)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if kernel:
        assert all(layer.policy == fastpath.resolve_kernel_policy(
            opt.finetune) for layer in model.pretrain.layers)
    assert np.isfinite(rmse)
    with open(tmp_path / "preds_seed_7.pkl", "rb") as f:
        preds = pickle.load(f)
    assert np.isfinite(preds["pred"]).all() and rmse == preds["rmse"]
    if case in _DIST:
        assert len(reports) == 2
        for r in reports:
            assert np.isfinite(r["train_loss"]).all()
            assert (r["value"], r["train_loss"]) == (
                reports[0]["value"], reports[0]["train_loss"])


def test_trainers_refuse_bf16(tmp_path):
    """run_task refuses bf16 before featurizing anything: the reference's
    task trainers build their models without a compute dtype, so they run
    f32 only (the pretraining trainers run bf16:
    tests/test_torch_bf16_paths.py)."""
    from fragnet_tpu_torch.train.tasks import run_task

    with pytest.raises(NotImplementedError,
                       match="run_task runs f32 only.*without a compute "
                             "dtype"):
        run_task("cdrp", _small_opt(tmp_path), device="cpu")


def test_f32_only_passes_refuse_bf16():
    """The passes and wrappers that run bf16 now — K3's edge-partitioned
    pass, the plane builder K6, the dense-attr pass and its kernels K7 and
    K8 — still refuse every other type (f16 here) on the CPU too: no kernel
    reads it, and no path widens it quietly."""
    N, H, D, E = 16, 2, 4, 8
    half = torch.float16
    nf = torch.zeros((N, H, D), dtype=half)
    idx = torch.zeros(E, dtype=torch.int32)
    mask = torch.zeros(E)
    with pytest.raises(ValueError, match="dtype"):
        tcsr_gat.tcsr_gat_pass_ep(nf, torch.zeros((E, 3), dtype=half), idx,
                                  idx, mask, torch.zeros((H, 2 * D + 3)),
                                  None, 0)
    with pytest.raises(ValueError, match="dtype"):
        dense_gat.dense_attr_gat_pass(nf, torch.zeros((E, 3), dtype=half),
                                      idx, idx, mask,
                                      torch.zeros((H, 2 * D + 3)),
                                      torch.zeros((1, N, N)), None)
    with pytest.raises(ValueError, match="dtype"):
        dense_gat.build_dense_planes_device(idx, idx, mask,
                                            torch.zeros((E, 1), dtype=half),
                                            N, None)
    z = torch.zeros((N, H))
    nf2 = nf.reshape(N, H * D)
    for fn, args in (
            (dense_gat.dense_attr_fwd,
             (torch.zeros((1, N, N)), z, z, nf2, torch.zeros((E, H)), idx,
              idx, mask, None, False)),
            (dense_gat.dense_attr_bwd,
             (torch.zeros((1, N, N)), z, z, nf2, torch.zeros((E, H)), idx,
              idx, mask, None, z, z, torch.zeros((N, H * D)), z, False))):
        with pytest.raises(ValueError, match="dtype"):
            fn(*args)
