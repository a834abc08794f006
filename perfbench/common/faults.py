"""Faults planted in the program underneath a run, to show that the
comparison that decides ``correct`` catches them: a step that leaves its
state unchanged, half of each batch left out of the loss (the mean taken
over the rest), and an answer altered where the model produces it. Each is
a context manager that patches the program while it is open."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def unchanged_state():
    """Adam's step does nothing: the weights never move."""
    orig = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


def _first_half(b):
    """The batch with every molecule of the second half masked out."""
    G = b.graph_mask.shape[0]
    keep_g = (torch.arange(G, device=b.graph_mask.device) < G // 2).to(
        b.graph_mask.dtype)
    keep_a = keep_g[b.atom_batch.long()] * b.atom_mask
    keep_e = keep_a[b.edge_src.long()] * b.edge_mask
    return dataclasses.replace(b, graph_mask=b.graph_mask * keep_g,
                               atom_mask=keep_a, edge_mask=keep_e)


@contextlib.contextmanager
def half_batch():
    """The training losses over the first half of each batch only."""
    from fragnet_tpu_torch.train import pretrain, tasks

    pt, st = pretrain.pretrain_loss, tasks.standardized_loss

    def pt_half(preds, batch, compat=False):
        return pt(preds, _first_half(batch), compat)

    def st_half(out, y, graph_mask, mean, sdev):
        G = graph_mask.shape[0]
        keep = (torch.arange(G, device=graph_mask.device) < G // 2).to(
            graph_mask.dtype)
        return st(out, y, graph_mask * keep, mean, sdev)

    pretrain.pretrain_loss, tasks.standardized_loss = pt_half, st_half
    try:
        yield
    finally:
        pretrain.pretrain_loss, tasks.standardized_loss = pt, st


@contextlib.contextmanager
def altered_answer():
    """The DTA model's output for the first pair of every batch moved by
    one unit."""
    from fragnet_tpu_torch.model import dta

    orig = dta.DTAModel.forward

    def forward(self, batch):
        out = orig(self, batch)
        bump = torch.zeros_like(out)
        bump[0] = 1.0
        return out + bump

    dta.DTAModel.forward = forward
    try:
        yield
    finally:
        dta.DTAModel.forward = orig


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
