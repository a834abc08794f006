"""Weights from the seed: one uniform draw on the device by a seeded
``torch.Generator``, cut into the leaves and scaled by their kind. The
same tensors go into the program's model and, as a copy taken before its
first step, to the reference."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

_ATTN = (".a_b", ".a", ".f_a_b", ".f")


def _bound(name: str, shape: Tuple[int, ...]) -> float:
    """Half-width of the leaf's uniform draw; 0 for a bias."""
    if name.endswith((".bias", ".beta")):
        return 0.0
    if name.endswith(("_embeddings.weight",)):
        return math.sqrt(3.0 / shape[1])          # variance 1/dim
    if name.endswith(_ATTN):
        h, width = shape                           # xavier, gain 1.414
        return math.sqrt(12.0 * 1.414 ** 2 / (h + width))
    return 1.0 / math.sqrt(shape[-1])              # 1/sqrt(fan_in)


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for the named shapes, in f32 on ``device``."""
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        if name.endswith(".gamma"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = (u[at:at + n] * _bound(name, shape)).view(shape)
        at += n
    return out


def shapes_of(model: torch.nn.Module):
    return [(k, tuple(p.shape)) for k, p in model.named_parameters()]
