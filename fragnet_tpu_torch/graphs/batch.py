"""Batch bridge: a numpy ``HierGraphBatch`` → the same container holding
torch tensors on a device.

Every array field becomes a tensor of the same dtype (f32 stays f32, i32
stays i32 — the kernels take int32 indices); the ``TileMeta`` of each level
carries its arrays as tensors too, and its static widths unchanged. ``None``
stays ``None``, so the layer's dispatch sees exactly which kernel metadata
the batch has.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from fragnet_tpu_torch.graphs.hiergraph import HierGraphBatch

_TM_FIELDS = ("tm_atom", "tm_bond", "tm_frag", "tm_fc")
_TM_ARRAYS = ("ew_blk", "sw_tile", "flat_slot", "cw")


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def to_device(batch: HierGraphBatch,
              device: Union[str, torch.device]) -> HierGraphBatch:
    device = torch.device(device)
    kw = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is None:
            kw[f.name] = None
        elif f.name in _TM_FIELDS:
            kw[f.name] = dataclasses.replace(
                v, **{a: _tensor(getattr(v, a), device) for a in _TM_ARRAYS})
        else:
            kw[f.name] = _tensor(v, device)
    return HierGraphBatch(**kw)
