"""The GAT logit terms (fragnet_tpu_torch/ops/gat_logits.py) on the CPU.

The plain backward written out from the formulas (gat_logits_bwd_plain:
every product and sum in f64, each gradient rounded once) against autograd
of the f64 einsums the CPU path runs, at the passes' head shapes (H, D) in
(4, 32), (3, 8), (1, 32), (8, 16), edge widths Da in 1, 6, 32, 128 and f32
and bf16 rows: within one ulp of the gradient's type (the two sum the
rows in other orders, in f64). The dispatch: CPU tensors take the f64
einsums, value for value and gradient for gradient, and never the kernels'
Function. The kernels' walk (``plan``): the load width and slots chosen
for Da = 128, 32 and 6, rows that start off a 16-byte boundary, and the
shapes it refuses. The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest
import torch

from fragnet_tpu_torch.ops import gat_logits, tcsr_gat
from fragnet_tpu_torch.ops.gat_logits import (gat_logits_bwd_plain,
                                              gat_logits_plain, plan)

HEADS = [(4, 32), (3, 8), (1, 32), (8, 16)]
DA = [1, 6, 32, 128]
DTYPES = [torch.float32, torch.bfloat16]


def _ulp(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of each value of ``t`` in ``dtype`` (f32: 24 bits, bf16: 8)."""
    bits = 24 if dtype == torch.float32 else 8
    _, e = torch.frexp(t.double())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64), e - bits)


def _within_ulp(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    assert torch.isfinite(g).all()
    assert bool(((g - w).abs() <= _ulp(w, want.dtype)).all()), \
        float((g - w).abs().max())


def _inputs(rng, H, D, Da, dtype, N=37, E=53):
    a = torch.from_numpy(rng.standard_normal((H, 2 * D + Da))
                         .astype(np.float32))
    nf = torch.from_numpy(rng.standard_normal((N, H, D))
                          .astype(np.float32)).to(dtype)
    ea = torch.from_numpy(rng.standard_normal((E, Da))
                          .astype(np.float32)).to(dtype)
    d_wn = torch.from_numpy(rng.standard_normal((N, 2 * H))
                            .astype(np.float32))
    d_wea = torch.from_numpy(rng.standard_normal((E, H)).astype(np.float32))
    return a, nf, ea, d_wn, d_wea


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("Da", DA)
@pytest.mark.parametrize("H,D", HEADS)
def test_bwd_plain_matches_autograd_of_the_einsum(H, D, Da, dtype):
    rng = np.random.default_rng(H * 1000 + D * 10 + Da)
    a, nf, ea, d_wn, d_wea = _inputs(rng, H, D, Da, dtype)
    a.requires_grad_(True)
    nf.requires_grad_(True)
    ea.requires_grad_(True)
    wn, w_ea = gat_logits_plain(nf, ea, a, Da)
    assert wn.dtype == w_ea.dtype == torch.float32
    torch.autograd.backward([wn, w_ea], [d_wn, d_wea])
    d_a, d_nf, d_ea = gat_logits_bwd_plain(nf.detach(), ea.detach(),
                                           a.detach(), Da, d_wn, d_wea)
    _within_ulp(d_nf, nf.grad)
    _within_ulp(d_ea, ea.grad)
    _within_ulp(d_a, a.grad)


@pytest.mark.parametrize("H,D", HEADS)
def test_bwd_plain_node_rows_alone(H, D):
    """node_logits' form: only node rows, d_a's edge columns exactly 0."""
    rng = np.random.default_rng(H + D)
    Da = 6
    a, nf, _, d_wn, _ = _inputs(rng, H, D, Da, torch.float32)
    a.requires_grad_(True)
    nf.requires_grad_(True)
    wn, w_ea = gat_logits_plain(nf, None, a, Da)
    assert w_ea is None
    wn.backward(d_wn)
    d_a, d_nf, d_ea = gat_logits_bwd_plain(nf.detach(), None, a.detach(),
                                           Da, d_wn, None)
    assert d_ea is None
    assert torch.equal(d_a[:, D:D + Da], torch.zeros(H, Da))
    _within_ulp(d_nf, nf.grad)
    _within_ulp(d_a, a.grad)


def test_cpu_dispatch_is_the_f64_einsum(monkeypatch):
    """node_logits and prologue on CPU tensors: the f64 einsums' values and
    gradients bit for bit, and no call of the kernels' Function."""
    def refuse(*_args, **_kw):
        raise AssertionError("the CPU path reached GatLogitsFn")

    monkeypatch.setattr(gat_logits.GatLogitsFn, "apply", refuse)
    rng = np.random.default_rng(7)
    H, D, Da = 4, 32, 128
    a, nf, ea, d_wn, d_wea = _inputs(rng, H, D, Da, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (a, nf, ea)]
    wn, w_ea = tcsr_gat.prologue(leaves[1], leaves[2], leaves[0])
    torch.autograd.backward([wn, w_ea], [d_wn, d_wea])
    wn_n = tcsr_gat.node_logits(nf, a, Da)

    ref = [t.clone().requires_grad_(True) for t in (a, nf, ea)]
    a_nodes = torch.stack([ref[0][:, :D], ref[0][:, D + Da:]])
    wn_r = torch.einsum("nhd,khd->nkh", ref[1].double(),
                        a_nodes.double()).float().reshape(-1, 2 * H)
    w_ea_r = torch.einsum("ed,hd->eh", ref[2].double(),
                          ref[0][:, D:D + Da].double()).float()
    torch.autograd.backward([wn_r, w_ea_r], [d_wn, d_wea])
    assert torch.equal(wn, wn_r) and torch.equal(w_ea, w_ea_r)
    assert torch.equal(wn_n, wn_r.detach())
    for got, want in zip(leaves, ref):
        assert torch.equal(got.grad, want.grad)


@pytest.mark.parametrize("Da,elem,V,Qp,TR", [
    (128, 4, 4, 32, 8),     # atom / frag edge rows, f32: 16-byte loads
    (32, 4, 4, 8, 32),      # bond-graph edge rows, f32
    (6, 4, 2, 4, 64),       # fconn attributes, f32: 8-byte loads
    (1, 4, 1, 1, 256),      # one column: a slot a row
    (128, 2, 4, 32, 8),     # bf16: K·V ≤ 16 caps the load at 8 bytes
])
def test_plan_edge_rows(Da, elem, V, Qp, TR):
    p = plan(1000, 1, Da, 4, Da, elem, 0)
    assert (p.V, p.Qp, p.TR) == (V, Qp, TR)
    assert p.tiles == -(-1000 // TR)


@pytest.mark.parametrize("H,D,elem,V,Qp", [
    (4, 32, 4, 4, 8), (3, 8, 4, 4, 2), (1, 32, 4, 4, 8), (8, 16, 4, 4, 4),
    (4, 32, 2, 8, 4),       # bf16 node rows: 16-byte loads of 8 values
])
def test_plan_node_rows(H, D, elem, V, Qp):
    p = plan(500, H, D, 2, H * D, elem, 0)
    assert (p.V, p.Qp, p.TR) == (V, Qp, 256 // (H * Qp))


@pytest.mark.parametrize("ptr,stride,V", [
    (0, 128, 4), (8, 128, 2), (4, 128, 1), (0, 130, 2), (0, 129, 1)])
def test_plan_narrows_the_load_off_alignment(ptr, stride, V):
    """Rows that start off a 16-byte boundary, or lie an odd number of
    columns apart, take narrower loads; nothing is refused for it."""
    assert plan(10, 1, 128, 4, stride, 4, ptr).V == V


def test_plan_empty_rows():
    assert plan(0, 4, 32, 2, 128, 4, 0).tiles == 0


@pytest.mark.parametrize("S,L,K", [(1, 32, 17), (1, 4096, 4), (64, 40, 2)])
def test_plan_refuses(S, L, K):
    with pytest.raises(ValueError, match="gat_logits"):
        plan(10, S, L, K, S * L, 4, 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(3)
    a, nf, ea, _, _ = _inputs(rng, 4, 32, 32, torch.float32)
    with pytest.raises(ValueError, match="no gat_logits kernel"):
        gat_logits.gat_logits_fwd(nf, ea, a, 32)
