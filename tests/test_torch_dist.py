"""The port's data-parallel mode on the CPU against fragnet_tpu's: the
DPBatchLoader's windows (and its spill where the JAX loader raises), one
data-parallel Adam step over two gloo ranks against the JAX update with the
mean of ``jax.grad`` over the two micro-batches, ``run_finetune`` under
``dist.mode=dp``, and two OS processes started with torchrun's variables
(``dist.multihost=true`` on the CPU) against the one-process step.

Ranks are spawned processes (dist/launch.py) that import torch and the
port only; their functions live in fragnet_tpu_torch/dist/checks.py. The
group meets through a file under tmp_path and every collective and the
whole run time out. Tolerance: 1e-4 relative (a small model, two
frameworks); the torchrun-style processes' step against the port's own
one-process step 1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fragnet_tpu.dist.data_parallel import DPBatchLoader as JaxDPLoader
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.train.loop import mse_loss as jax_mse
from fragnet_tpu.train.optim import make_optimizer as jax_optimizer

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.dist import checks
from fragnet_tpu_torch.dist.data_parallel import DPBatchLoader
from fragnet_tpu_torch.dist.launch import run_ranks
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import spec_for
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax
from fragnet_tpu_torch.train.finetune import run_finetune
from fragnet_tpu_torch.train.loop import mse_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 2
SMALL = dict(num_layer=2, num_heads=4, emb_dim=32, h1=16, h2=16, h3=16,
             h4=16, drop_ratio=0.0)


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = PortBuilder("exp1s")
    return [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                          smiles=g.smiles) for g in ft_graphs]


def _fields(b):
    return {f.name: getattr(b, f.name) for f in dataclasses.fields(b)
            if isinstance(getattr(b, f.name), np.ndarray)}


def test_dp_loader_windows_match_jax(ft_graphs, port_graphs):
    """Where every window fits: each rank's micro-batch equals the JAX
    loader's stacked batch at that rank, shuffled epoch after epoch, and
    every graph is covered once per epoch."""
    spec_j = jax_spec_for(ft_graphs, batch_size=2)
    spec_p = spec_for(port_graphs, batch_size=2)
    jl = JaxDPLoader(ft_graphs, 2, S, spec_j, shuffle=True, seed=3)
    pls = [DPBatchLoader(port_graphs, 2, S, spec_p, rank=r, shuffle=True,
                         seed=3) for r in range(S)]
    for _epoch in range(2):
        stacked = list(jl)
        per_rank = [list(pl) for pl in pls]
        assert len(stacked) == len(per_rank[0]) == len(per_rank[1]) \
            == len(jl)
        n = 0
        for k, sb in enumerate(stacked):
            for r in range(S):
                want = _fields(sb)
                for name, got in _fields(per_rank[r][k]).items():
                    np.testing.assert_array_equal(got, want[name][r],
                                                  err_msg=f"{name} {k} {r}")
                n += int(per_rank[r][k].graph_mask.sum())
        assert n == len(port_graphs)


def test_dp_loader_spills_where_jax_raises(ft_graphs, port_graphs):
    """A spec sized for one molecule and windows of 2 per rank: the JAX
    loader's padding raises; the port's closes windows early and still
    covers every graph once. A last window shorter than the ranks leaves a
    rank an empty micro-batch, whose masked loss is 0."""
    spec_j = jax_spec_for(ft_graphs, batch_size=1)
    with pytest.raises(ValueError, match="exceeds spec"):
        list(JaxDPLoader(ft_graphs, 2, S, spec_j))
    spec_p = spec_for(port_graphs, batch_size=1)
    loader = DPBatchLoader(port_graphs, 2, S, spec_p)
    wins = loader.windows()
    assert len(wins) > len(loader)  # the spill added windows
    assert sorted(g.smiles for w in wins for g in w) == \
        sorted(g.smiles for g in port_graphs)
    counts = [sum(int(b.graph_mask.sum()) for b in
                  DPBatchLoader(port_graphs, 2, S, spec_p, rank=r))
              for r in range(S)]
    assert sum(counts) == len(port_graphs)

    graphs = port_graphs[:7]
    short = [list(DPBatchLoader(graphs, 3, S, spec_for(graphs, 4), rank=r))
             for r in range(S)]
    assert len(short[0]) == len(short[1]) == 2
    empty = short[1][-1]
    assert float(empty.graph_mask.sum()) == 0.0
    model = FragNetFineTune(**SMALL).eval()
    b = to_device(empty, "cpu")
    with torch.no_grad():
        loss = mse_loss(model(b), b.y, b.graph_mask)
    assert float(loss) == 0.0


def test_dp_step_matches_jax_mean_gradient_update(tmp_path, ft_graphs,
                                                  port_graphs):
    model = JaxModel(**SMALL)
    spec_j = jax_spec_for(ft_graphs, batch_size=2)
    stacked = next(iter(JaxDPLoader(ft_graphs, 2, S, spec_j)))
    micro = [jax.tree.map(lambda x: None if x is None else jnp.asarray(x[r]),
                          stacked) for r in range(S)]
    params = jax.jit(lambda b: model.init(jax.random.PRNGKey(1), b,
                                          deterministic=True))(micro[0])
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jax_mse(model.apply(p, b, deterministic=True), b.y,
                             b.graph_mask)))
    lg = [grad(params, b) for b in micro]
    mean_g = jax.tree.map(lambda *g: sum(g) / S, *(g for _, g in lg))
    lr = 1e-3
    tx = jax_optimizer("adam", lr=lr)
    upd, _ = tx.update(mean_g, tx.init(params), params)
    want_p = state_dict_from_jax(jax.device_get(
        optax.apply_updates(params, upd)))
    want_g = state_dict_from_jax(jax.device_get(mean_g))
    sd = state_dict_from_jax(jax.device_get(params))
    res = run_ranks(checks.dp_step_rank, S,
                    (SMALL, sd, port_graphs, spec_for(port_graphs, 2), 2, lr),
                    device="cpu", timeout_s=120, join_timeout_s=300,
                    workdir=str(tmp_path))
    scale = max(float(g.abs().max()) for g in want_g.values())
    loss_j = sum(float(l) for l, _ in lg) / S
    for r in res:
        assert abs(r["loss"] - loss_j) <= 1e-4 * loss_j
        for name, w in want_g.items():
            got = r["grads"][name]
            np.testing.assert_allclose(
                got.numpy(), w.numpy(), rtol=1e-4,
                atol=1e-4 * max(float(w.abs().max()), 1e-2 * scale))
            np.testing.assert_allclose(
                r["params"][name].numpy(), want_p[name].numpy(), rtol=1e-4,
                atol=1e-4 * float(want_p[name].abs().max()))


def test_run_finetune_dp_two_ranks(tmp_path, port_graphs):
    opt = Config({
        "seed": 7, "exp_dir": str(tmp_path), "model_version": "gat2",
        "dist": {"mode": "dp", "n_devices": S, "timeout_s": 120,
                 "join_timeout_s": 300},
        "finetune": {"model": dict(SMALL, act="relu", fthead="FTHead3"),
                     "target_type": "regr", "batch_size": 2,
                     "n_epochs": 2}})
    reports = []
    datasets = (port_graphs[:4], port_graphs[4:6], port_graphs[6:], 1,
                "regr")
    rmse, model = run_finetune(opt, datasets=datasets, device="cpu",
                               rank_reports=reports)
    assert np.isfinite(rmse)
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["val_score"] == reports[1]["val_score"]
    assert len(reports[0]["val_score"]) == 2
    assert reports[0]["value"] == reports[1]["value"] == rmse
    with open(tmp_path / "scalars.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("train/loss") == 2 and tags.count("test/rmse") == 1
    assert (tmp_path / "ft.ckpt").exists()
    assert (tmp_path / "preds_seed_7.pkl").exists()
    assert isinstance(model, FragNetFineTune)


# --------------------------------------------------------------------------
# multi-process runs on the CPU: processes started as torchrun starts them
# --------------------------------------------------------------------------

_TORCHRUN_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
import torch.distributed as dist
from fragnet_tpu_torch.config import Config
from fragnet_tpu_torch.dist import checks
from fragnet_tpu_torch.dist.data_parallel import initialize_distributed
from fragnet_tpu_torch.train.finetune import run_finetune

args = torch.load(sys.argv[1], weights_only=False)
info = initialize_distributed(device="cpu", timeout_s=120)
out = {"rank": info.rank, "world": info.world_size, "backend": info.backend,
       "step": checks.dp_step_rank(*args["step"])}
out["value"], _ = run_finetune(Config(args["opt"]), quiet=True,
                               datasets=args["datasets"], device="cpu")
torch.save(out, sys.argv[2] + ".%%d" %% info.rank)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_processes_join_on_the_cpu(tmp_path, port_graphs):
    """Two OS processes with torchrun's variables (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT on localhost) join one gloo group
    (the counterpart of tests/test_multiprocess.py): one data-parallel
    Adam step equals the one-process step — the mean of the two
    micro-batches' losses and gradients, then Adam — at 1e-5; then
    ``run_finetune`` with ``dist.multihost=true`` runs as each process's
    rank, both ranks reporting the same test RMSE."""
    import subprocess
    import sys

    from fragnet_tpu_torch.train.optim import make_optimizer

    model_kw = dict(SMALL, drop_ratio=0.0)
    model = FragNetFineTune(**model_kw,
                            generator=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    graphs, spec, lr = port_graphs[:4], spec_for(port_graphs, 2), 1e-3
    opt = {"seed": 7, "exp_dir": str(tmp_path / "run"),
           "model_version": "gat2",
           "dist": {"mode": "dp", "n_devices": S, "multihost": True,
                    "timeout_s": 120},
           "finetune": {"model": dict(SMALL, act="relu", fthead="FTHead3"),
                        "target_type": "regr", "batch_size": 2,
                        "n_epochs": 1}}
    args = tmp_path / "args.pt"
    torch.save({"step": (model_kw, sd, graphs, spec, 2, lr), "opt": opt,
                "datasets": (port_graphs[:4], port_graphs[4:6],
                             port_graphs[6:], 1, "regr")}, args)
    script = tmp_path / "worker.py"
    script.write_text(_TORCHRUN_WORKER % {"repo": REPO})
    port = _free_port()
    procs = []
    for rank in range(S):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(S), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(args), str(tmp_path / "out")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    res = [torch.load(f"{tmp_path / 'out'}.{r}", weights_only=False)
           for r in range(S)]
    assert [(r["rank"], r["world"], r["backend"]) for r in res] == \
        [(r, S, "gloo") for r in range(S)]

    # the one-process step: both micro-batches' mean loss and gradient
    losses, grads = [], []
    for rank in range(S):
        model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
        b = to_device(next(iter(DPBatchLoader(graphs, 2, S, spec,
                                              rank=rank))), "cpu")
        loss = mse_loss(model(b), b.y, b.graph_mask)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    model.load_state_dict(sd)
    mean = {n: (grads[0][n] + grads[1][n]) / S for n in grads[0]}
    for n, p in model.named_parameters():
        p.grad = mean.get(n)
    adam, _ = make_optimizer(model.parameters(), "adam", lr=lr)
    adam.step()
    for r in res:
        step = r["step"]
        assert abs(step["loss"] - sum(losses) / S) <= 1e-5 * sum(losses) / S
        for n, w in mean.items():
            np.testing.assert_allclose(step["grads"][n].numpy(), w.numpy(),
                                       rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(
                step["params"][n].numpy(), p.detach().numpy(), rtol=1e-5,
                atol=1e-5 * float(p.detach().abs().max()))
    assert np.isfinite(res[0]["value"]) and res[0]["value"] == res[1]["value"]
    assert (tmp_path / "run" / "ft.ckpt").exists()
