"""Closed loop of DTA training steps (``make_standardized_steps``' train
step) over padded batches held on the device, as ``run_task`` caches
them.

Traffic parameters: ``drugs`` (a featurized pool), ``proteins`` (how many,
and their length distribution), ``batch_size``, ``train_batches``. The
pairs are every drug with every protein (Davis's grid); the seed draws the
pairs of the train batches, the weights, the dropout stream and the order
of the batches in each epoch. The labels are standardized by the train
pairs' mean and population std.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.common import check, dta_data, pool, task
from perfbench.costs import flops
from perfbench.reference import model as ref


class Session:
    def __init__(self, ctx):
        from fragnet_tpu_torch.train.optim import make_optimizer
        from fragnet_tpu_torch.train.tasks import make_standardized_steps

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg = ctx, cfg
        d, pr = tr["drugs"], tr["proteins"]
        self.drugs = pool.pool("drug", d["n"], d["profile"], d["seed"],
                               ctx.workers)
        prng = np.random.default_rng(pr["seed"])
        seqs = dta_data.proteins(prng, pr["n"], pr)
        L = cfg["protein"]["max_len"]
        self.toks = np.stack([dta_data.encode(s, L) for s in seqs])
        lp = dta_data.logps([g.smiles for g in self.drugs])
        self.ys = np.array([[dta_data.affinity(a, s) for s in seqs]
                            for a in lp])
        n_p = len(seqs)
        self.pairs = np.array([(i, j) for i in range(len(self.drugs))
                               for j in range(n_p)])
        graphs_of = lambda ix: dta_data.stack(self.pairs[ix], self.drugs,
                                              self.toks, self.ys)
        B = tr["batch_size"]
        self.B = B
        order = np.random.default_rng(pr["seed"]).permutation(len(self.pairs))
        self.probe = graphs_of(order)
        self.spec = task.spec(self.probe, B, {"probe": "dta", **d, **pr})
        ctx.mark("pool and spec")

        self.idx = task.draw_batches(
            np.random.default_rng(ctx.sub_seed("batches")), len(self.pairs),
            tr["train_batches"], B, graphs_of, self.spec)
        self.graphs = [graphs_of(ix) for ix in self.idx]
        ys = np.array([g.y[0] for b in self.graphs for g in b])
        self.labels = ys
        self.batches = task.device_batches(self.graphs, self.spec, ctx.device)
        ctx.mark("batches on the device")

        self.model, self.w0 = task.build_model(cfg, ctx)
        o = cfg["optimizer"]
        self.opt, _ = make_optimizer(self.model.parameters(), o["name"],
                                     lr=o["lr"])
        self._step, _ = make_standardized_steps(
            self.model, self.opt, float(ys.mean()), float(ys.std()),
            ctx.device)
        ctx.mark("model")

        self._order_rng = np.random.default_rng(ctx.sub_seed("order"))
        self._queue: List[int] = []
        n_check = tr["check_steps"]
        self.check_batches = [self._next() for _ in range(n_check)]
        self.check_seeds = [ctx.sub_seed(f"dropout{k}")
                            for k in range(n_check)]
        self.first = check.FirstSteps(
            self.model, self.opt, self._step,
            [self.batches[i] for i in self.check_batches], self.check_seeds)
        ctx.mark("first steps")
        self.losses: List[torch.Tensor] = []
        self.done: List[int] = []
        for _ in range(tr["warmup_steps"]):
            self.step()
        ctx.mark("warm-up")
        self.items_per_step = B

    def _next(self) -> int:
        if not self._queue:
            self._queue = list(self._order_rng.permutation(len(self.idx)))
        return int(self._queue.pop(0))

    def step(self):
        i = self._next()
        self.losses.append(self._step(self.batches[i]))
        self.done.append(i)

    def begin_window(self):
        self.losses, self.done = [], []

    def end_window(self) -> Dict[str, int]:
        ok = torch.isfinite(torch.stack(self.losses)).cpu().numpy()
        return {"attempted": len(ok), "failed": int((~ok).sum())}

    def release(self):
        del self._step, self.opt, self.model, self.batches
        task.release(self.ctx.device)

    def model_flops(self, steps: List[int]) -> float:
        per = {}
        for i in set(steps):
            g = self.graphs[i]
            per[i] = 3 * flops.dta_forward(
                flops.real_counts(g),
                dta_data.real_lengths(np.stack([x.protein for x in g])),
                self.cfg)
        return float(sum(per[i] for i in steps))

    def reference(self):
        stats = ref.label_stats(self.labels)
        batches = [task.ref_batch(
            self.graphs[i], self.probe, self.B, self.spec, self.ctx.device,
            np.stack([g.protein for g in self.graphs[i]]),
            np.array([g.y[0] for g in self.graphs[i]]))
            for i in self.check_batches]
        return check.reference_steps(
            lambda w, b: ref.dta_loss(w, b, self.cfg, stats, True), self.w0,
            batches, self.check_seeds, self.cfg["optimizer"], ref.adam)

    def numbers(self) -> Dict[str, float]:
        return check.training_numbers(self.first.result(), self.reference(),
                                      self.w0)
