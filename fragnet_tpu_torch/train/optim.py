"""Optimizer and LR schedule of the finetune recipe (counterpart of
fragnet_tpu/train/optim.py, which builds them on optax).

Covers the JAX package's optimizer surface: plain Adam
(finetune_gat2.py:257) with an optional linear ramp (finetune_gat2.py:
259-261) or a warmup-then-decay schedule (extra_optimizers.py, gat2_pl.py:
18-51), AdamW with an explicit weight decay, Adagrad, SGD, and clipping
by the global gradient norm. The schedule follows optax: it is evaluated
at the update count, 0 for the first update, and a ``LambdaLR`` over an
optimizer whose base lr is 1.0 gives each step exactly
``schedule(step)``. Adam, AdamW and SGD are ``torch.optim``'s: their
updates are optax's up to rounding. Adagrad is optax's
(``OptaxAdagrad``), which torch's is not; so is the clipping
(``clip_by_global_norm``), which torch's ``clip_grad_norm_`` is not (it
adds 1e-6 to the norm and clips below the limit too).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (transition_begin 0)."""
    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule to 0 (alpha 0, exponent 1)."""
    if not steps > 0:
        raise ValueError(f"the cosine decay needs positive decay steps, got "
                         f"{steps}")

    def sched(count: int) -> float:
        return init * 0.5 * (1 + math.cos(math.pi * min(count, steps)
                                          / steps))
    return sched


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules([first, then], [boundary])."""
    def sched(count: int) -> float:
        return first(count) if count < boundary else then(count - boundary)
    return sched


def make_schedule(
    name: Optional[str],
    base_lr: float,
    total_steps: int = 10000,
    warmup_steps: int = 0,
    end_factor: float = 1.0 / 3.0,
) -> Optional[Schedule]:
    """The learning rate at each update count (0 for the first update), as
    the JAX package's optax schedule gives it; None for a constant rate.

    * ``None``/"constant" — constant LR (returns None)
    * "linear"            — ramp end_factor·lr → lr over ``warmup_steps``
                            updates, or total_steps // 20 when that is 0
                            (finetune_gat2.py:259-261)
    * "cosine_warmup"     — linear warmup 0 → lr, then cosine decay to 0
                            at ``total_steps`` (optax's
                            warmup_cosine_decay_schedule)
    * "linear_warmup"     — linear warmup 0 → lr, then linear decay to 0
    """
    if name in (None, "constant"):
        return None
    if name == "linear":
        return _linear(base_lr * end_factor, base_lr,
                       max(1, warmup_steps or total_steps // 20))
    warm = max(1, warmup_steps)
    if name == "cosine_warmup":
        return _join(_linear(0.0, base_lr, warm),
                     _cosine(base_lr, max(2, total_steps) - warm), warm)
    if name == "linear_warmup":
        return _join(_linear(0.0, base_lr, warm),
                     _linear(base_lr, 0.0, max(1, total_steps - warmup_steps)),
                     warm)
    raise ValueError(f"unknown schedule {name!r} "
                     f"(constant|linear|cosine_warmup|linear_warmup)")


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad: the accumulator of squared gradients starts at
    ``initial_accumulator_value`` (0.1) and the update is
    −lr · g · rsqrt(acc + eps) with eps = 1e-7 inside the root (torch's
    Adagrad starts at 0 and adds eps outside the root)."""

    def __init__(self, params, lr: float = 1e-2,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum"] = torch.full_like(p, group["initial"])
                acc = st["sum"]
                acc.addcmul_(p.grad, p.grad)
                p.addcmul_(p.grad, torch.rsqrt(acc + group["eps"]),
                           value=-group["lr"])
        return loss


def clip_by_global_norm(max_norm: float) -> Callable:
    """An optimizer step pre-hook that clips the gradients as optax's
    clip_by_global_norm does: g stays when the global norm ‖g‖ (over every
    parameter's gradient) is below ``max_norm``, else becomes g / ‖g‖ ·
    max_norm. The decision is made on the device (no host sync)."""
    @torch.no_grad()
    def hook(optimizer, args, kwargs):
        grads = [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        if not grads:
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return hook


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    name: str = "adam",
    lr: float = 1e-4,
    schedule: Optional[Schedule] = None,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
) -> Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """(optimizer, scheduler or None) over ``params``. torch Adam defaults:
    b1=0.9 b2=0.999 eps=1e-8 (AdamW the same, with ``weight_decay``, which
    optax applies as lr·wd·p — torch's decoupled decay). With ``schedule``
    the rate of update k is ``schedule(k)`` (the scheduler steps once per
    update). With ``grad_clip`` every step first clips the gradients by
    their global norm (``clip_by_global_norm``), as the JAX package's
    ``optax.chain(clip_by_global_norm(grad_clip), tx)`` does."""
    base = 1.0 if schedule is not None else lr
    if name == "adam":
        opt = torch.optim.Adam(params, lr=base, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=base, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
    elif name == "adagrad":
        opt = OptaxAdagrad(params, lr=base)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=base)
    else:
        raise ValueError(f"unknown optimizer {name!r} "
                         f"(adam|adamw|adagrad|sgd)")
    if grad_clip:
        opt.register_step_pre_hook(clip_by_global_norm(float(grad_clip)))
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, schedule)
             if schedule is not None else None)
    return opt, sched
