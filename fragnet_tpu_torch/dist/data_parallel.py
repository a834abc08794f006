"""Process groups, collectives and data-parallel training on
torch.distributed (counterpart of fragnet_tpu/dist/data_parallel.py).

One process per rank. A rank's device is ``cuda:(local_rank %
device_count)``; the backend is NCCL when every rank has a card of its own
(world size ≤ device count) and gloo when ranks share a card or run on the
CPU (NCCL refuses two ranks on one device). The collectives
(collectives.py) move a tensor to the backend's device and back, so one
code path serves both.

Data parallelism: every rank holds the same parameters, takes its own
micro-batch of each window of ``per_device_batch × world`` graphs
(round-robin, as the JAX package's ``stack_for_dp``), and the gradients are
averaged over the ranks before every optimizer step (``average_gradients``,
the JAX step's ``pmean``), so every rank applies the same update. A bf16
model (``finetune.dtype=bf16``) runs each rank's micro-batch through the
bf16 entries of the GAT kernels; its parameters and gradients stay f32, so
the all-reduce moves f32 as in an f32 run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from fragnet_tpu_torch.dist.collectives import all_gather, all_reduce


@dataclasses.dataclass(frozen=True)
class DistInfo:
    rank: int
    world_size: int
    backend: str
    device: torch.device


def backend_for(world_size: int, device_type: str) -> str:
    """NCCL when each of ``world_size`` ranks has a card of its own, else
    gloo (ranks that share a card, or CPU ranks)."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def device_for(local_rank: int, device: Union[str, torch.device]
               ) -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)`` for a CUDA run,
    else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           init_method: Optional[str] = None,
                           device: Union[str, torch.device] = "cuda",
                           timeout_s: float = 300.0) -> DistInfo:
    """Join a process group: the one already initialized, else the rank,
    world size and ``init_method`` given (a launcher that spawned its
    ranks), else ``torchrun``'s RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR environment. Chooses the backend once (``backend_for``)
    and sets the rank's CUDA device. Collectives that wait longer than
    ``timeout_s`` fail instead of hanging."""
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = device_for(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return DistInfo(dist.get_rank(), dist.get_world_size(),
                        dist.get_backend(), dev)
    backend = backend_for(world_size, dev.type)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return DistInfo(rank, world_size, backend, dev)


def average_gradients(params: Sequence[torch.nn.Parameter],
                      group=None) -> None:
    """Replace every parameter's gradient by its mean over the ranks (the
    JAX step's ``pmean``): one all-reduce of a flat buffer, a missing
    gradient counted as zeros (a parameter off the loss's path, as layer
    L−2's fragment attention vector, still takes part on every rank)."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = all_reduce(flat, group, average=True)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


def gather_numpy(x, group=None) -> np.ndarray:
    """Every rank's array (numpy, or a tensor on any device) stacked on a
    new leading axis, as numpy."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return all_gather(t.cpu(), group).numpy()


# ---------------------------------------------------------------------------
# data-parallel loader and steps
# ---------------------------------------------------------------------------

def stack_for_dp(graphs: Sequence, n_devices: int, spec, rank: int,
                 n_tasks: int = 1, with_targets: bool = False):
    """Rank ``rank``'s micro-batch of one window: every ``n_devices``-th
    graph from position ``rank`` (the JAX package's round-robin split),
    padded to ``spec``; a rank with no graph gets an empty batch."""
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch

    return pad_batch(list(graphs)[rank::n_devices], spec, n_tasks=n_tasks,
                     with_targets=with_targets, template=graphs[0])


class DPBatchLoader:
    """Rank ``rank``'s micro-batches: windows of up to ``per_device_batch ×
    n_devices`` graphs, split round-robin over the ranks and padded per
    rank to one shared PadSpec (the JAX package's DPBatchLoader, which
    stacks every rank's micro-batch on a leading axis). Every rank walks the
    same windows from the same seed, so all take the same number of steps.

    A window closes early when the next graph would not fit its rank's
    micro-batch under the spec, and that graph opens the next window (the
    spill of ``BatchLoader``); the JAX loader pads fixed windows and raises
    there. Where every window fits, the windows are the JAX loader's. A
    graph too large for an empty micro-batch is skipped loudly, or raises
    with ``on_oversize='error'`` (eval loaders)."""

    def __init__(self, graphs: Sequence, per_device_batch: int,
                 n_devices: int, spec, rank: int = 0, shuffle: bool = False,
                 seed: int = 0, n_tasks: int = 1, with_targets: bool = False,
                 on_oversize: str = "skip"):
        if on_oversize not in ("skip", "error"):
            raise ValueError(f"on_oversize={on_oversize!r} (skip|error)")
        self.graphs = list(graphs)
        self.bs = per_device_batch
        self.n_devices = n_devices
        self.spec = spec
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.n_tasks = n_tasks
        self.with_targets = with_targets
        self.on_oversize = on_oversize
        self._epoch = 0

    def __len__(self) -> int:
        """Windows of a full epoch when none spills (a spill adds one)."""
        window = self.bs * self.n_devices
        return (len(self.graphs) + window - 1) // window

    def windows(self) -> List[List]:
        """One epoch of windows (advances the shuffle state)."""
        from fragnet_tpu_torch.graphs.hiergraph import fits

        order = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        S, window = self.n_devices, self.bs * self.n_devices
        out, i = [], 0
        while i < len(order):
            win: List = []
            parts: List[List] = [[] for _ in range(S)]
            while i < len(order) and len(win) < window:
                g = self.graphs[order[i]]
                part = parts[len(win) % S]
                if fits(part + [g], self.spec):
                    part.append(g)
                    win.append(g)
                    i += 1
                elif part:
                    break  # spills into the next window
                else:
                    if self.on_oversize == "error":
                        raise ValueError(
                            f"molecule exceeds the PadSpec in an eval "
                            f"loader: {g.smiles}")
                    print(f"[dp] molecule too large for spec, skipped: "
                          f"{g.smiles}")
                    i += 1
            if win:
                out.append(win)
        return out

    def __iter__(self):
        for win in self.windows():
            yield stack_for_dp(win, self.n_devices, self.spec, self.rank,
                               n_tasks=self.n_tasks,
                               with_targets=self.with_targets)


def make_dp_train_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       loss_name: str = "mse",
                       device: Union[str, torch.device] = "cuda",
                       group=None, scheduler=None) -> Callable:
    """``train_step(batch) -> loss``: forward and backward on this rank's
    micro-batch, gradients averaged over the ranks, then the optimizer and
    scheduler step. Returns the loss averaged over the ranks (the JAX
    step's ``pmean``; an empty micro-batch's masked loss is 0 and counts)."""
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import LOSSES

    loss_fn = LOSSES[loss_name]

    def train_step(batch):
        b = to_device(batch, device)
        model.train()
        loss = loss_fn(model(b), b.y, b.graph_mask)
        loss.backward()
        average_gradients(list(model.parameters()), group)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        optimizer.zero_grad(set_to_none=True)
        return all_reduce(loss.detach(), group, average=True)

    return train_step


def make_dp_eval_step(model: torch.nn.Module, loss_name: str = "mse",
                      device: Union[str, torch.device] = "cuda",
                      group=None) -> Callable:
    """``eval_step(batch) -> (loss averaged over the ranks, this rank's
    predictions)``; TrainerFineTune gathers predictions, targets and masks
    over the ranks for its metrics."""
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import LOSSES

    loss_fn = LOSSES[loss_name]

    def eval_step(batch):
        b = to_device(batch, device)
        model.eval()
        with torch.no_grad():
            out = model(b)
            return all_reduce(loss_fn(out, b.y, b.graph_mask), group,
                              average=True), out

    return eval_step
