"""Closed loop of DTA screening: ``make_standardized_steps``' ``predict``
(eval mode, no gradient) over padded batches held on the device, every
pair of a batch carrying the same target protein.

Traffic parameters: ``library`` (a featurized pool), ``protein`` (the
length distribution), ``batch_size``. The seed draws the target protein,
the weights and the library's split into batches; the window scores the
batches in turn. The predictions come back in label units: the model
de-standardizes them with the statistics of the labels it was trained on,
which the traffic states (``label_stats``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.common import dta_data, pool, task
from perfbench.costs import flops
from perfbench.reference import model as ref


class Session:
    def __init__(self, ctx):
        from fragnet_tpu_torch.train.optim import make_optimizer
        from fragnet_tpu_torch.train.tasks import make_standardized_steps

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg = ctx, cfg
        lib, pr = tr["library"], tr["protein"]
        self.lib = pool.pool("drug", lib["n"], lib["profile"], lib["seed"],
                             ctx.workers)
        seq = dta_data.proteins(np.random.default_rng(ctx.sub_seed("target")),
                                1, pr)[0]
        self.tok = dta_data.encode(seq, cfg["protein"]["max_len"])
        graphs_of = lambda ix: [dta_data.pair_graph(self.lib[i], self.tok,
                                                    0.0) for i in ix]
        B = tr["batch_size"]
        self.B = B
        n_b = len(self.lib) // B
        self.probe = graphs_of(
            np.random.default_rng(lib["seed"]).permutation(len(self.lib)))
        self.spec = task.spec(self.probe, B, {"probe": "screen", **lib})
        ctx.mark("pool and spec")
        self.idx = task.draw_batches(
            np.random.default_rng(ctx.sub_seed("batches")), len(self.lib),
            n_b, B, graphs_of, self.spec)
        self.graphs = [graphs_of(ix) for ix in self.idx]
        self.batches = task.device_batches(self.graphs, self.spec, ctx.device)
        ctx.mark("batches on the device")

        self.model, self.w0 = task.build_model(cfg, ctx)
        st = tr["label_stats"]
        self.stats = (float(st["mean"]), float(st["std"]))
        opt, _ = make_optimizer(self.model.parameters(), "adam", lr=1e-4)
        _, self._predict = make_standardized_steps(
            self.model, opt, *self.stats, ctx.device)
        ctx.mark("model")
        self.outs: List[torch.Tensor] = []
        self.done: List[int] = []
        self._at = 0
        for _ in range(tr["warmup_steps"]):
            self.step()
        ctx.mark("warm-up")
        self.items_per_step = B

    def step(self):
        i = self._at % len(self.batches)
        self._at += 1
        self.outs.append(self._predict(self.batches[i]))
        self.done.append(i)

    def begin_window(self):
        self.outs, self.done = [], []

    def end_window(self) -> Dict[str, int]:
        out = torch.stack(self.outs)
        ok = torch.isfinite(out).all(dim=1).cpu().numpy()
        self.window_out = out.cpu().double().numpy()
        return {"attempted": len(ok), "failed": int((~ok).sum())}

    def release(self):
        del self._predict, self.model, self.batches, self.outs
        task.release(self.ctx.device)

    def model_flops(self, steps: List[int]) -> float:
        per = {}
        for i in set(steps):
            g = self.graphs[i]
            per[i] = flops.dta_forward(
                flops.real_counts(g),
                dta_data.real_lengths(np.stack([x.protein for x in g])),
                self.cfg)
        return float(sum(per[i] for i in steps))

    def reference(self) -> np.ndarray:
        """(batches, B) predictions in label units, in eval mode."""
        mean, sdev = self.stats[0], self.stats[1] + 1e-5
        out = []
        with torch.no_grad():
            for g in self.graphs:
                b = task.ref_batch(g, self.probe, self.B, self.spec,
                                   self.ctx.device,
                                   np.stack([x.protein for x in g]),
                                   np.array([x.y[0] for x in g]))
                out.append((ref.dta_forward(self.w0, b, self.cfg, False)
                            * sdev + mean).double().cpu().numpy())
        return np.stack(out)

    def gaps(self, out: np.ndarray, done, r: np.ndarray) -> Dict[str, float]:
        """``pred_gap``: predictions ``out`` (one row per step, of the
        batches ``done``) against the reference's ``r`` for their batches,
        the largest gap in standardized units (over the labels' std)."""
        gap = np.abs(np.asarray(out) - r[np.asarray(done)]).max()
        return {"pred_gap": float(gap / self.stats[1])}

    def numbers(self) -> Dict[str, float]:
        """Every prediction of the window against the reference's."""
        return self.gaps(self.window_out, self.done, self.reference())
