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
