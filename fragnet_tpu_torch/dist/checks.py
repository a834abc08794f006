"""Rank functions that hold the distributed paths against the
single-device ones: each runs inside a process group (dist/launch.py:
run_ranks) and returns what the caller compares — tests/test_torch_ep.py,
tests/test_torch_dist.py and chip_smoke.py phases 20-24. They live in the
package so that a spawned rank imports torch and this package only.

Every gradient returned is averaged over the ranks
(data_parallel.average_gradients), as the training steps average it.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict

import torch
import torch.distributed as dist


def _cpu(t):
    return None if t is None else t.detach().cpu()


def calls_rank(calls) -> list:
    """``[fn(*args) for fn, args in calls]`` in one process group, so that
    several checks share one start of the ranks."""
    return [fn(*args) for fn, args in calls]


def timed_calls_rank(calls) -> list:
    """``calls_rank``'s results, each with the seconds its call took in
    this rank: ``[(result, seconds), ...]``."""
    out = []
    for fn, args in calls:
        t0 = time.perf_counter()
        out.append((fn(*args), time.perf_counter() - t0))
    return out


def ep_pass_rank(nf, ea, src, dst, mask, avec, meta, g_out,
                 self_loops: bool, device: str = "cpu") -> Dict:
    """One ``tcsr_gat_pass_ep`` over the caller's whole-level arrays, this
    rank taking its shard of ``ea``/``src``/``dst``/``mask``: (out, attn,
    and the gradients of Σ out·g_out w.r.t. nf, ea and avec)."""
    from fragnet_tpu_torch.dist.data_parallel import average_gradients
    from fragnet_tpu_torch.graphs.batch import _tensor
    from fragnet_tpu_torch.ops.tcsr_gat import tcsr_gat_pass_ep

    rank, S = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    meta = dataclasses.replace(meta, **{
        f.name: _tensor(getattr(meta, f.name), dev)
        for f in dataclasses.fields(meta)
        if not isinstance(getattr(meta, f.name), int)})
    nf, ea, avec = (t.to(dev).requires_grad_() for t in (nf, ea, avec))
    Es = src.shape[0] // S
    sl = slice(rank * Es, (rank + 1) * Es)
    out, attn = tcsr_gat_pass_ep(
        nf, ea[sl], src[sl].to(dev), dst[sl].to(dev), mask[sl].to(dev),
        avec, meta, rank, self_loops=self_loops, return_attention=True)
    (out * g_out.to(dev)).sum().backward()
    average_gradients([nf, ea, avec])
    return {"out": _cpu(out), "attn": _cpu(attn), "d_nf": _cpu(nf.grad),
            "d_ea": _cpu(ea.grad), "d_avec": _cpu(avec.grad)}


def ep_segment_pass_rank(nf, ea, src, dst, mask, avec, g_out, data,
                         seg_ids, n_seg: int, seg_mask) -> Dict:
    """The segment edge-partitioned pass (dist/edge_partition.py:
    edge_partitioned_gat_pass) over every shard's arrays ((S, Es, ...), as
    shard_edges lays them out), this rank computing on its own: (out, and
    the averaged gradients of Σ out·g_out w.r.t. nf, ea and avec), and
    ``edge_partitioned_segment_sum`` of (data, seg_ids, seg_mask)."""
    from fragnet_tpu_torch.dist.data_parallel import average_gradients
    from fragnet_tpu_torch.dist.edge_partition import (
        EPContext, edge_partitioned_gat_pass, edge_partitioned_segment_sum)

    ctx = EPContext(dist.get_rank(), dist.get_world_size())
    nf, ea, avec = (t.clone().requires_grad_() for t in (nf, ea, avec))
    out = edge_partitioned_gat_pass(ctx, nf, ea, src, dst, mask, avec)
    (out * g_out).sum().backward()
    average_gradients([nf, ea, avec])
    return {"out": _cpu(out), "d_nf": _cpu(nf.grad), "d_ea": _cpu(ea.grad),
            "d_avec": _cpu(avec.grad),
            "segment_sum": _cpu(edge_partitioned_segment_sum(
                ctx, data, seg_ids, n_seg, mask=seg_mask))}


def ep_finetune_rank(opt_dict, datasets, device: str = "cpu") -> Dict:
    """``run_finetune`` as this rank of the running group (the launcher's
    rank report, train/finetune.py:_finetune_rank, without the state
    dict), with what it printed and whether every parameter of the trained
    model (rank 0's) is finite."""
    import contextlib
    import io

    from fragnet_tpu_torch.train.finetune import _finetune_rank

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        report = _finetune_rank(opt_dict, False, datasets, device)
    sd = report.pop("state_dict")
    params = list(sd.values()) if sd is not None else []
    return dict(report, printed=text.getvalue(),
                finite=all(bool(torch.isfinite(p).all()) for p in params))


def _ep_model(model_kw, state_dict, dev):
    from fragnet_tpu_torch.dist.edge_partition import EPContext
    from fragnet_tpu_torch.model.finetune import FragNetFineTune

    ctx = EPContext(dist.get_rank(), dist.get_world_size())
    model = FragNetFineTune(**model_kw, ep=ctx)
    model.load_state_dict(state_dict)
    return model.to(dev), ctx


def ep_model_rank(model_kw, state_dict, batch, lr: float,
                  device: str = "cpu", hooks=None) -> Dict:
    """The edge-partitioned FragNetFineTune (carried weights, eval mode:
    dropout off) on ``batch`` (numpy: with every shard's EPTileMeta, the
    fused mode, or with no tile metadata, the segment mode), both forwards
    with ``hooks`` (one LayerHooks per layer, or None): its predictions and
    last-layer attentions, the MSE and every parameter's averaged gradient,
    then the parameters after one SGD step of ``lr``."""
    from fragnet_tpu_torch.dist.data_parallel import average_gradients
    from fragnet_tpu_torch.dist.edge_partition import ep_local_batch
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import mse_loss

    dev = torch.device(device)
    model, ctx = _ep_model(model_kw, state_dict, dev)
    model.eval()
    b = ep_local_batch(to_device(batch, dev), ctx.rank, ctx.size)
    with torch.no_grad():
        pred, attn = model(b, return_attentions=True, hooks=hooks)
    loss = mse_loss(model(b, hooks=hooks), b.y, b.graph_mask)
    loss.backward()
    average_gradients(list(model.parameters()))
    grads = {n: _cpu(p.grad) for n, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    opt.step()
    return {"pred": _cpu(pred), "loss": float(loss),
            "attn": {k: _cpu(getattr(attn, k))
                     for k in ("atoms", "frags", "bonds", "fbonds")},
            "grads": grads,
            "params": {n: _cpu(p) for n, p in model.named_parameters()}}


def dp_step_rank(model_kw, state_dict, graphs, spec, batch_size: int,
                 lr: float, device: str = "cpu") -> Dict:
    """One data-parallel Adam step (dist/data_parallel.py:
    make_dp_train_step) on this rank's micro-batch of the first window of
    ``graphs``: the averaged loss, every parameter's averaged gradient and
    the parameters after the step. ``model_kw`` should set drop_ratio 0 for
    a comparison."""
    from fragnet_tpu_torch.dist.data_parallel import (DPBatchLoader,
                                                      average_gradients,
                                                      make_dp_train_step)
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.model.finetune import FragNetFineTune
    from fragnet_tpu_torch.train.loop import mse_loss
    from fragnet_tpu_torch.train.optim import make_optimizer

    rank, S = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    model = FragNetFineTune(**model_kw)
    model.load_state_dict(state_dict)
    model = model.to(dev)
    loader = DPBatchLoader(graphs, batch_size, S, spec, rank=rank)
    batch = next(iter(loader))
    # the averaged gradient, read before the step consumes it
    b = to_device(batch, dev)
    mse_loss(model(b), b.y, b.graph_mask).backward()
    average_gradients(list(model.parameters()))
    grads = {n: _cpu(p.grad) for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt, _ = make_optimizer(model.parameters(), "adam", lr=lr)
    loss = float(make_dp_train_step(model, opt, "mse", dev)(batch))
    return {"loss": loss, "grads": grads,
            "params": {n: _cpu(p) for n, p in model.named_parameters()}}


def ep_card_step_rank(model_kw, state_dict, batch, capture: bool = True
                      ) -> Dict:
    """chip_smoke.py phases 20 and 22, on the card: one edge-partitioned
    train step's loss, predictions, attentions and averaged gradients
    (carried weights, dropout off) and the kernel launches it made (by
    launcher symbol; ``batch`` with EPTileMeta runs K3, one without tile
    metadata the segment mode, which launches none), with layer 0's K3
    forward calls (their inputs, for the kernel-vs-plain check) when
    ``capture``; then
    the step's wall time (median of 5 after a warm-up, each ended by a
    synchronize) and, under the profiler, its device busy time, K3's
    device time and the collectives' host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.dist.data_parallel import average_gradients
    from fragnet_tpu_torch.dist.edge_partition import ep_local_batch
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.ops import _cuda, tcsr_gat
    from fragnet_tpu_torch.train.loop import mse_loss

    dev = torch.device("cuda", torch.cuda.current_device())
    model, ctx = _ep_model(model_kw, state_dict, dev)
    model.eval()

    calls = []
    orig = tcsr_gat.tcsr_gat_ep_fwd

    def rec(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    def step(record: bool = False):
        b = ep_local_batch(to_device(batch, dev), ctx.rank, ctx.size)
        if record:
            tcsr_gat.tcsr_gat_ep_fwd = rec
        try:
            pred, attn = model(b, return_attentions=True)
        finally:
            tcsr_gat.tcsr_gat_ep_fwd = orig
        loss = mse_loss(pred, b.y, b.graph_mask)
        loss.backward()
        average_gradients(list(model.parameters()), ctx.group)
        return loss, pred, attn

    before = _cuda.launch_counts()
    loss, pred, attn = step(record=capture)
    launches = {k: n - before.get(k, 0)
                for k, n in _cuda.launch_counts().items()}
    out = {"loss": float(loss), "pred": _cpu(pred), "launches": launches,
           "attn": {k: _cpu(getattr(attn, k))
                    for k in ("atoms", "frags", "bonds", "fbonds")},
           "grads": {n: _cpu(p.grad) for n, p in model.named_parameters()},
           # layer 0's bond, atom, fconn and frag passes, in call order
           "calls": calls[:4] if capture else None}
    model.zero_grad(set_to_none=True)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        model.zero_grad(set_to_none=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    busy = k3 = coll = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            ms = e.self_device_time_total / 1e3
            busy += ms
            if "tcsr_gat_fwd_kernel" in e.key or "tcsr_gat_bwd_kernel" in e.key:
                k3 += ms
        elif e.device_type == DeviceType.CPU and (
                "c10d::" in e.key or "allreduce" in e.key.lower()
                or "allgather" in e.key.lower()):
            coll += e.self_cpu_time_total / 1e3
    out.update(wall_ms=statistics.median(walls[1:]), busy_ms=busy,
               k3_device_ms=k3, collectives_ms=coll)
    return out
