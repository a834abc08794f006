"""``task_train``'s closed loop of DTA training steps with the
Moonlight-16B-A3B protein tower (dta-fragnet-moonlight): the same pairs,
batches, steps and checks, with the model, its operation count and its
reference replaced.

The tower's weights are drawn from the seed as the configuration assumes:
normal(0, 0.02), RMSNorm weights 1; the drug encoder and the head as
``weights.make`` draws them. The routers' correction biases are then set
as a deployment's balancing leaves them, by the reference
(``setup_biases``: noaux_tc's rule, each expert's bias stepped against
its load on the first batch's residues), and loaded into the program and
given to the reference alike; the program moves them at γ after each
training step. With biases drawn at random and held, the seed's random
gates sent from 0.5x to 2x their share of the tokens to the 8 experts
held here, and the step time followed (a 4% spread of the rate over
seeds).

Beside ``check``'s gaps, ``correct`` compares routes: ``route_diff``
counts the real tokens of the first check step, over the expert layers,
whose chosen experts differ between the program and the reference at the
same weights and inputs. Steps 2 and 3 may route a few residues otherwise
after the first update's rounding (a legitimate flip at a near-tie), which
puts the program's ``loss_gap`` up to 4e-5, next to the TF32 control's
1e-4: the loss is held to a limit far above both and far below a fault's
gap (a half batch's, 0.27 and more), and ``grad_gap`` and ``update_gap``
are what fail the control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# imported here so that a program without the tower fails at once
from fragnet_tpu_torch.model.moonlight import MoonlightConfig, moe_layers

from perfbench.common import check, dta_data, task, weights
from perfbench.costs import flops, moe as moe_cost
from perfbench.drivers import task_train
from perfbench.metrics import _counts
from perfbench.reference import model as ref, moonlight as ref_ml

ASSIGNMENTS = "fragnet.protein.moe.assignments"
# the pairs of the first train batch whose residues balance the routers
BALANCE_PAIRS = 8


def draw_weights(model: torch.nn.Module, ctx) -> Dict[str, torch.Tensor]:
    """The parameters from the seed, on the device."""
    shapes = weights.shapes_of(model)
    tower = [(n, s) for n, s in shapes if n.startswith("target_model.")]
    w = weights.make([(n, s) for n, s in shapes
                      if not n.startswith("target_model.")],
                     ctx.sub_seed("weights"), ctx.device)
    g = torch.Generator(device=ctx.device)
    g.manual_seed(ctx.sub_seed("tower weights"))
    for n, s in tower:
        w[n] = torch.ones(s, device=ctx.device) if n.endswith("norm.weight") \
            else torch.randn(s, generator=g, device=ctx.device) * 0.02
    return w


def build_model(cfg: Dict, ctx, tokens: torch.Tensor):
    """(model, parameters from the seed, correction biases balanced on
    ``tokens`` by the reference at those parameters, loaded into the
    model too)."""
    from fragnet_tpu_torch.model.dta import DTAModel
    from fragnet_tpu_torch.model.layers import KernelPolicy

    m = cfg["model"]
    with torch.device(ctx.device):
        model = DTAModel(
            num_layer=m["num_layer"], num_heads=m["num_heads"],
            drop_ratio=m["drop_ratio"], emb_dim=m["emb_dim"],
            atom_features=m["atom_features"],
            frag_features=m["frag_features"],
            edge_features=m["edge_features"], fedge_in=m["fedge_in"],
            fbond_edge_in=m["fbond_edge_in"], protein_encoder="moonlight",
            protein_max_len=cfg["protein"]["max_len"],
            moonlight=MoonlightConfig.from_dict(cfg),
            policy=KernelPolicy(**cfg["kernel"]))
    w0 = draw_weights(model, ctx)
    biases = ref_ml.setup_biases(w0, tokens, cfg)
    model.load_state_dict({**w0, **biases})
    return model, w0, biases


def capture_routes(model: torch.nn.Module):
    """(a list that receives each expert layer's chosen experts at its
    first call, in layer order; the hooks, to remove)."""
    layers = moe_layers(model.target_model)
    got: List = [None] * len(layers)

    def hook_for(k):
        def hook(_mod, _inp, out):
            if got[k] is None:
                got[k] = out[0].detach().clone()
        return hook

    hooks = [layer.gate.register_forward_hook(hook_for(k))
             for k, layer in enumerate(layers.values())]
    return got, hooks


def route_diff(prog: List[torch.Tensor], ref_choices: List[torch.Tensor],
               tokens: torch.Tensor) -> int:
    """Real tokens, over the expert layers, whose sets of chosen experts
    differ."""
    real = (tokens != 0).reshape(-1)
    n = 0
    for a, b in zip(prog, ref_choices):
        differ = (a.sort(1).values != b.to(a.device).sort(1).values).any(1)
        n += int((differ & real.to(a.device)).sum())
    return n


class Session(task_train.Session):
    def __init__(self, ctx):
        built = {}

        def build(cfg, ctx_):
            # task_train has put the batches on the device by now
            model, w0, biases = build_model(
                cfg, ctx_, self.batches[0].protein[:BALANCE_PAIRS])
            built["biases"] = biases
            built["routes"] = capture_routes(model)
            return model, w0

        # task_train builds its model through task.build_model; for the
        # length of the set-up that is this tower's
        orig = task.build_model
        task.build_model = build
        try:
            super().__init__(ctx)
        finally:
            task.build_model = orig
        self.biases = built["biases"]
        self.routes, hooks = built["routes"]
        for h in hooks:
            h.remove()
        self.ref_choices = None

    def model_flops(self, steps: List[int]) -> float:
        """3 × the forward of each traced step, the experts' part from the
        program's count of held assignments over the traced window."""
        from fragnet_tpu_torch import obs

        cfg = self.cfg
        per = {}
        for i in set(steps):
            g = self.graphs[i]
            per[i] = moe_cost.dta_forward(
                flops.real_counts(g),
                dta_data.real_lengths(np.stack([x.protein for x in g])), 0.0,
                cfg)
        routed = _counts.total(obs.span_table(), ASSIGNMENTS) or 0.0
        return 3.0 * (sum(per[i] for i in steps) + routed * 2 * 3
                      * cfg["hidden_size"] * cfg["moe_intermediate_size"])

    def reference(self):
        stats = ref.label_stats(self.labels)
        batches = [task.ref_batch(
            self.graphs[i], self.probe, self.B, self.spec, self.ctx.device,
            np.stack([g.protein for g in self.graphs[i]]),
            np.array([g.y[0] for g in self.graphs[i]]))
            for i in self.check_batches]
        losses, first, after, choices = ref_ml.reference_steps(
            self.w0, self.biases, batches, self.check_seeds, self.cfg,
            stats, self.ctx.traffic["reference_micro_batch"])
        self.ref_choices = choices
        self.check_tokens = batches[0].protein
        return losses, first, after

    def numbers(self) -> Dict[str, float]:
        out = check.training_numbers(self.first.result(), self.reference(),
                                     self.w0)
        out["route_diff"] = route_diff(self.routes, self.ref_choices,
                                       self.check_tokens)
        return out
