"""What decides ``correct`` for a training cell: the program's first
steps, recorded in set-up through the window's own step call, against
the reference's same steps from the same weights, batches and dropout
seeds.

Three numbers, each with the cell's limit:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as Adam received it (read back from
  its first moment after one step), leaf by leaf: the gap between the
  program's and the reference's norm of the leaf, over the larger of the
  reference's norm of that leaf and of the median leaf; the median of
  these over the leaves;
* ``update_gap``: the same of each leaf's change over the steps. Leaves
  whose reference gradient is under a thousandth of the median leaf's
  move under Adam by round-off alone and are left out of it.

The median leaf, not the worst: the worst leaf's gap is the rounding of
one small leaf (a bias whose gradient is a nearly cancelling sum, an
attention vector whose Adam steps amplify it) and swings by orders of
magnitude from seed to seed; it is reported beside the median.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

QUIET_LEAF = 1e-3


class FirstSteps:
    """The program's first steps, run through ``step`` on ``batches``,
    each after seeding the dropout stream with its seed."""

    def __init__(self, model: torch.nn.Module, optimizer, step: Callable,
                 batches: Sequence, seeds: Sequence[int]):
        b1 = optimizer.param_groups[0]["betas"][0]
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        for k, (b, s) in enumerate(zip(batches, seeds)):
            torch.manual_seed(s)
            self.losses.append(step(b))
            if k == 0:
                # a leaf that got no gradient (an earlier layer's fragment
                # attention, whose output reaches no loss) has no state
                self.grad = {n: (optimizer.state[p]["exp_avg"] / (1.0 - b1)
                                 ).clone() if p in optimizer.state
                             else torch.zeros_like(p)
                             for n, p in model.named_parameters()}
        self.after = {n: p.detach().clone()
                      for n, p in model.named_parameters()}

    def result(self):
        return self.losses, self.grad, self.after


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys
          ) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def training_numbers(prog, ref, w0: Dict[str, torch.Tensor]
                     ) -> Dict[str, float]:
    """``prog`` and ``ref``: each (losses, first gradient, weights after
    the steps). The checked numbers are the median leaf's gaps; the worst
    leaf's, and which leaf it is, come beside them."""
    p_loss = [float(x) for x in prog[0]]
    ref_losses, ref_grad, ref_after = ref
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(p_loss, ref_losses))
    g_r = _norms(ref_grad)
    grad = _gaps(_norms(prog[1]), g_r, g_r)
    med = float(np.median(list(g_r.values())))
    moving = [k for k in g_r if g_r[k] >= QUIET_LEAF * med]
    d_p = _norms({k: prog[2][k] - w0[k] for k in moving})
    d_r = _norms({k: ref_after[k] - w0[k] for k in moving})
    upd = _gaps(d_p, d_r, moving)
    g_leaf = max(grad, key=grad.get)
    u_leaf = max(upd, key=upd.get)
    return {"loss_gap": loss_gap,
            "grad_gap": float(np.median(list(grad.values()))),
            "update_gap": float(np.median(list(upd.values()))),
            "grad_gap_worst": grad[g_leaf], "grad_leaf": g_leaf,
            "update_gap_worst": upd[u_leaf], "update_leaf": u_leaf}


def reference_steps(loss_fn: Callable, w0: Dict[str, torch.Tensor],
                    batches: Sequence, seeds: Sequence[int], opt: Dict,
                    adam: Callable):
    """The reference's steps from ``w0``: (losses, first gradient,
    weights after the last step)."""
    w = {k: v.clone() for k, v in w0.items()}
    state: Dict = {}
    losses, first = [], None
    for k, (b, s) in enumerate(zip(batches, seeds)):
        torch.manual_seed(s)
        leaves = {n: v.detach().requires_grad_() for n, v in w.items()}
        loss = loss_fn(leaves, b)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        g = {n: (x if x is not None else torch.zeros_like(leaves[n]))
             for n, x in zip(leaves, grads)}
        losses.append(float(loss.detach()))
        if k == 0:
            first = {n: x.detach().clone() for n, x in g.items()}
        w = adam({n: v.detach() for n, v in leaves.items()}, g, state, opt)
        del loss, grads, g, leaves
    return losses, first, w
