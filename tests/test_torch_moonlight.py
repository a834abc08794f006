"""The Moonlight-16B-A3B protein tower in DTA (fragnet_tpu_torch/model/
moonlight.py) and the token dispatch and combine (ops/moe.py) on the CPU,
at a small size: width 64, 4 heads, nope / rope / v 16 / 8 / 16, kv LoRA
32, 8 experts with 2 a token and 4 held, one dense and one MoE layer, a
batch of 3 pairs of at most 24 residues with padding.

Held against the plain reference of tests/ref_moonlight.py (the drug
encoder against the benchmark's plain one, perfbench/reference/model.py,
with dropout off): the DTA loss and every gradient within 1e-5 of each
leaf's scale (f32 sums in other orders: the reference's experts and
attention are the same products, its combine indexes where the program
gathers), Adam's first step within 1e-6 of each leaf's scale (the step is
lr·m/√v: a gradient's rounding moves it by its relative error, and a leaf
whose gradient is near 0 by up to lr), the shares' partial outputs adding
up to the uncut layer within 1e-5, padding tokens routed nowhere,
predictions that follow a permutation of the pairs, and the chosen
experts equal to the reference's. The plain dispatch and combine are held
to autograd of the dense formula, and the kernel wrappers refuse CPU
tensors; run_task trains and predicts with the tower.
"""

import numpy as np
import pytest
import torch

import ref_moonlight as ref
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.data.batcher import BatchLoader
from fragnet_tpu_torch.data.dta import build_dta_graphs, synthetic_dta_dataset
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.hiergraph import spec_for
from fragnet_tpu_torch.model.dta import DTAModel
from fragnet_tpu_torch.model.moonlight import (BIAS_UPDATE_SPEED, MoE,
                                              MoonlightConfig, moe_layers)
from fragnet_tpu_torch.ops import moe as moe_ops
from fragnet_tpu_torch.train.optim import make_optimizer
from fragnet_tpu_torch.train.tasks import (build_task_model,
                                           make_standardized_steps, run_task,
                                           standardized_loss)

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1)
# the published constants the reference reads beside the widths
REF = {**TINY, "rope_theta": 50000.0, "rms_norm_eps": 1e-5,
       "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
       "bias_update_speed": BIAS_UPDATE_SPEED}
L = 24
MEAN, SDEV = 5.0, 0.8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ref.tf32_off()
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return MoonlightConfig.from_dict({**TINY, **kw})


@pytest.fixture(scope="module")
def graphs():
    g = build_dta_graphs(synthetic_dta_dataset(n=3, seed=5,
                                               seq_len_range=(6, 24)),
                         max_seq_len=L)
    # one sequence at the full length, the others padded
    g[1].protein[:] = np.random.default_rng(0).integers(1, 26, L)
    return g


@pytest.fixture(scope="module")
def batch(graphs):
    spec = spec_for(graphs, batch_size=3, tcsr=True)
    return next(iter(BatchLoader(graphs, 3, spec=spec)))


def _model(held=4, seed=0):
    m = DTAModel(num_layer=2, num_heads=2, emb_dim=16, drop_ratio=0.0,
                 protein_encoder="moonlight", protein_max_len=L,
                 moonlight=_cfg(experts_held=held),
                 generator=torch.Generator().manual_seed(seed))
    # a correction bias of the benchmark's size, so that it matters
    g = torch.Generator().manual_seed(seed + 1)
    for layer in moe_layers(m.target_model).values():
        b = layer.gate.e_score_correction_bias
        b.copy_(torch.rand(b.shape, generator=g) * 0.02 - 0.01)
    return m


def _biases(model):
    """The correction biases as they are now (a training forward moves
    them)."""
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith("e_score_correction_bias")}


def _drug_reference(graphs, w, device="cpu"):
    """The drug encodings (G, 2·emb) by the benchmark's plain reference."""
    from perfbench.reference import layout, model as pref

    rows = layout.padded_rows(list(graphs), len(graphs))
    b = pref.make_batch(list(graphs), rows, layout.tiles(list(graphs)),
                        device)
    xa, xf, _, _ = pref.encoder(w, "drug_model.pretrain", b, 2, 2, 0.0, True)
    return pref.pool_graphs(b, xa, xf)


def _reference_loss(graphs, w, biases, held, c=None):
    c = c or REF
    tokens = torch.as_tensor(np.stack([g.protein for g in graphs]))
    prot, choices = ref.tower(w, biases, tokens, c, held)
    pred = ref.dta_forward(w, _drug_reference(graphs, w), prot)
    y = torch.tensor([float(g.y[0]) for g in graphs])
    return ref.dta_loss(pred, y, MEAN, SDEV + 1e-5), pred, choices


def _program_loss(model, batch):
    b = to_device(batch, "cpu")
    model.train()
    out = model(b)
    mean, sdev = torch.tensor(MEAN), torch.tensor(SDEV) + 1e-5
    return standardized_loss(out, b.y, b.graph_mask, mean, sdev), out


def _close(a, b, tol, what):
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a - b).abs().max())
    assert err <= tol * scale, (what, err, scale)


def _check_gradients(prog, ref_grads):
    """Each leaf within 1e-5 of its largest element; a leaf of the drug
    encoder within 1e-5 of the larger of that and a thousandth of the
    largest leaf's. The floor is for its leaves whose gradient is a nearly
    cancelling sum (an edge embedding's, 1e-5 of the largest, off by
    2.6e-5 of itself), and for those whose exact gradient is 0 (the
    earlier layers' fragment-connection attention, which no loss reaches),
    where the program has round-off."""
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for n, g in prog.items():
        r = ref_grads[n]
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        if n.startswith("drug_model."):
            scale = max(scale, 1e-3 * top)
        assert err <= 1e-5 * scale, (n, err, scale)


def test_dta_loss_and_gradients_match_the_reference(graphs, batch):
    model = _model()
    biases = _biases(model)
    loss, _ = _program_loss(model, batch)
    loss.backward()
    w = {n: p.detach().clone().requires_grad_()
         for n, p in model.named_parameters()}
    r_loss, _, choices = _reference_loss(graphs, w, biases, range(4))
    r_loss.backward()
    # the training forward then moved the biases as noaux_tc does
    tokens = torch.as_tensor(np.stack([g.protein for g in graphs]))
    after = ref.balance(biases, choices, tokens, REF)
    assert all(torch.equal(v, after[k]) for k, v in _biases(model).items())
    assert any(not torch.equal(v, biases[k]) for k, v in after.items())
    _close(loss.detach(), r_loss.detach(), 1e-5, "loss")
    # a parameter computed and unused (the drug encoder's edge embedding)
    # gets no gradient
    _check_gradients({n: p.grad if p.grad is not None else
                      torch.zeros_like(p) for n, p in
                      model.named_parameters()},
                     {n: v.grad if v.grad is not None else
                      torch.zeros_like(v) for n, v in w.items()})
    tower = [n for n in w if n.startswith("target_model.")]
    assert all(float(w[n].grad.abs().max()) for n in tower
               if "embed_tokens" not in n)


def test_adam_first_step_matches_the_reference(graphs, batch):
    """One step of make_standardized_steps: the gradient Adam received
    (its first moment over 1 − β1) against the reference's, and the new
    weights against the reference's Adam on that gradient."""
    model = _model(seed=3)
    biases = _biases(model)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, _ = make_optimizer(model.parameters(), "adam", lr=1e-3)
    step, _ = make_standardized_steps(model, opt, MEAN, SDEV, "cpu")
    step(batch)
    b1 = opt.param_groups[0]["betas"][0]
    got = {n: opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
           else torch.zeros_like(p) for n, p in model.named_parameters()}
    w = {n: v.clone().requires_grad_() for n, v in w0.items()}
    loss, _, _ = _reference_loss(graphs, w, biases, range(4))
    grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
    _check_gradients(got, {n: g if g is not None else torch.zeros_like(w[n])
                           for n, g in zip(w, grads)})
    moved = [n for n, p in model.named_parameters() if p in opt.state]
    after = ref.adam({n: w0[n] for n in moved}, got, {}, lr=1e-3)
    for n, p in model.named_parameters():
        _close(p.detach(), after[n] if n in after else w0[n], 1e-6, n)


def test_shares_add_up_to_the_uncut_layer():
    torch.manual_seed(0)
    full = MoE(_cfg(), torch.Generator().manual_seed(1))
    with torch.no_grad():
        full.gate.e_score_correction_bias.uniform_(-0.01, 0.01)
    sd = full.state_dict()
    parts = []
    for held in ((0, 1, 2, 3), (4, 5, 6, 7)):
        part = MoE(_cfg(experts_held=held), None).eval()
        part.load_state_dict({k: v for k, v in sd.items()
                              if k in part.state_dict()}, strict=True)
        parts.append(part)
    x = torch.randn(3, L, 64)
    real = torch.ones(3, L, dtype=torch.bool)
    real[0, 17:] = False
    real[2, 5:] = False
    with torch.no_grad():
        shared = full.shared_experts(x)
        total = parts[0](x, real) + parts[1](x, real) - shared
        w = {f"mlp.{k}": v for k, v in sd.items()}
        uncut, _ = ref.moe(w, sd["gate.e_score_correction_bias"], "mlp", x,
                           real, REF, range(8))
    _close(total, uncut, 1e-5, "shares")


def test_padding_tokens_are_routed_nowhere():
    g = torch.Generator().manual_seed(2)
    layer = MoE(_cfg(experts_held=4), g)
    h = torch.randn(3 * L, 64)
    real = torch.rand(3 * L, generator=g) < 0.6
    idx, _ = layer.gate(h)
    r = moe_ops.plan_routes(idx, layer.local_of, 4, real)
    assert (r.pos[~real] == -1).all()
    held = (idx < 4) & real[:, None]
    assert sum(r.counts) == len(r.tok) == int(held.sum())
    assert r.tokens_held == int(held.any(1).sum())
    assert real[r.tok.long()].all()
    # each held slot's row holds its token, the rows sorted by expert
    t, k = torch.nonzero(r.pos >= 0, as_tuple=True)
    assert (r.tok[r.pos[t, k].long()].long() == t).all()
    experts = idx[t, k][torch.argsort(r.pos[t, k])]
    assert (experts[1:] >= experts[:-1]).all()
    assert r.counts == [int((experts == e).sum()) for e in range(4)]


def test_permuting_pairs_permutes_predictions(graphs):
    model = _model(seed=5)
    model.eval()
    perm = [2, 0, 1]
    outs = []
    for gs in (graphs, [graphs[i] for i in perm]):
        spec = spec_for(gs, batch_size=3, tcsr=True)
        b = to_device(next(iter(BatchLoader(gs, 3, spec=spec))), "cpu")
        with torch.no_grad():
            outs.append(model(b)[:, 0])
    _close(outs[1], outs[0][perm], 1e-5, "permuted predictions")


def test_chosen_experts_equal_the_reference(graphs, batch):
    model = _model(seed=7)
    biases = _biases(model)
    got = []
    gate = moe_layers(model.target_model)[1].gate
    hook = gate.register_forward_hook(lambda m, i, o: got.append(o[0]))
    with torch.no_grad():
        _program_loss(model, batch)
        w = dict(model.named_parameters())
        _, _, choices = _reference_loss(graphs, w, biases, range(4))
    hook.remove()
    real = torch.as_tensor(np.stack([g.protein for g in graphs])).reshape(
        -1) != 0
    assert torch.equal(got[0][real], choices[0][real])


# ---------------------------------------------------------------------------
# the dispatch and combine
# ---------------------------------------------------------------------------

def _routes(T, K, A_of, seed):
    """pos (T, K) with ``A_of`` held slots placed at random, -1 elsewhere,
    and the tokens of the rows."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randperm(T * K, generator=g)[:A_of]
    pos = torch.full((T * K,), -1, dtype=torch.int32)
    pos[flat] = torch.randperm(A_of, generator=g).to(torch.int32)
    pos = pos.view(T, K)
    tok = torch.empty(A_of, dtype=torch.int32)
    t, k = torch.nonzero(pos >= 0, as_tuple=True)
    tok[pos[t, k].long()] = t.to(torch.int32)
    return pos, tok


def _dense(pos, A, w=None):
    """(T, A): M[t, pos[t, k]] = w[t, k] (1 without w), so that combine is
    M @ y and gather is Mᵀ's pattern."""
    T, K = pos.shape
    M = torch.zeros(T, A, dtype=torch.float64)
    t, k = torch.nonzero(pos >= 0, as_tuple=True)
    M[t, pos[t, k].long()] = 1.0 if w is None else w[t, k].double()
    return M


@pytest.mark.parametrize("T,K,A", [(0, 2, 0), (1, 6, 1), (37, 6, 50),
                                   (16, 2, 0)])
def test_plain_dispatch_and_combine_match_the_dense_formula(T, K, A):
    D = 12
    pos, tok = _routes(T, K, A, T + A)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(T, D, generator=g, dtype=torch.float64)
    y = torch.randn(A, D, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(T, K, generator=g, dtype=torch.float64,
                    requires_grad=True)
    d_out = torch.randn(T, D, generator=g, dtype=torch.float64)
    # combine and its backward
    out = moe_ops.combine_plain(y.float(), pos, w.float())
    M = torch.zeros(T, A, dtype=torch.float64)
    t, k = torch.nonzero(pos >= 0, as_tuple=True)
    M = M.index_put((t, pos[t, k].long()), w[t, k], accumulate=True)
    dense = M @ y
    assert torch.allclose(out.double(), dense.detach(), atol=1e-6)
    (dense * d_out).sum().backward()
    d_y, d_w = moe_ops.combine_bwd_plain(y.detach().float(), pos,
                                         w.detach().float(), d_out.float())
    assert torch.allclose(d_y.double(), y.grad, atol=1e-6)
    assert torch.allclose(d_w.double(), w.grad, atol=1e-6)
    # the unweighted combine is the gather's backward
    xg = x.clone().requires_grad_()
    rows = moe_ops.gather_plain(xg, tok)
    assert torch.equal(rows, x[tok.long()])
    d_rows = torch.randn(A, D, generator=g, dtype=torch.float64)
    (rows * d_rows).sum().backward()
    back = moe_ops.combine_plain(d_rows, pos, None)
    assert torch.allclose(back, xg.grad, atol=1e-12)
    assert torch.allclose(_dense(pos, A) @ d_rows, xg.grad, atol=1e-12)


def test_kernel_wrappers_refuse_cpu_tensors():
    pos, tok = _routes(4, 2, 3, 0)
    y, x = torch.zeros(3, 8), torch.zeros(4, 8)
    w, d = torch.zeros(4, 2), torch.zeros(4, 8)
    for call in (lambda: moe_ops.moe_gather(x, tok),
                 lambda: moe_ops.moe_combine(y, pos, w),
                 lambda: moe_ops.moe_combine_bwd(y, pos, w, d)):
        with pytest.raises(ValueError, match="no moe_route kernel"):
            call()


# ---------------------------------------------------------------------------
# the normal path
# ---------------------------------------------------------------------------

def _opt(**model):
    return Config({"seed": 3, "exp_dir": None, "finetune": {
        "model": {"num_layer": 1, "num_heads": 2, "emb_dim": 16,
                  "protein_encoder": "moonlight",
                  "moonlight": {**TINY, "experts_held": 4}, **model},
        "batch_size": 4, "lr": 1e-3, "n_epochs": 2, "es_patience": 5}})


def test_run_task_trains_and_predicts_with_the_tower(tmp_path):
    g = build_dta_graphs(synthetic_dta_dataset(n=12, seed=2,
                                               seq_len_range=(6, 24)),
                         max_seq_len=L)
    opt = _opt()
    opt.set_path("exp_dir", str(tmp_path))
    rmse, model = run_task("dta", opt, quiet=True, device="cpu", graphs=g)
    assert np.isfinite(rmse)
    assert model.protein_encoder == "moonlight"
    tower = model.target_model
    assert tower.config.held == (0, 1, 2, 3)
    assert model.fc1.in_features == 2 * 16 + 64
    assert (tmp_path / "dta.ckpt").exists()


def test_build_task_model_keys_and_refusals(graphs):
    m = build_task_model("dta", _opt(), graphs)
    assert len(m.target_model.layers) == 2
    assert sorted(moe_layers(m.target_model)[1].experts) == ["0", "1", "2",
                                                             "3"]
    with pytest.raises(ValueError, match="transformer|cnn|moonlight"):
        build_task_model("dta", _opt(protein_encoder="lstm"), graphs)
    opt = _opt()
    opt.set_path("finetune.dtype", "bf16")
    with pytest.raises(NotImplementedError, match="f32 only"):
        run_task("dta", opt, quiet=True, device="cpu", graphs=graphs)
    with pytest.raises(ValueError, match="experts_held"):
        _cfg(experts_held=(0, 9)).check()
