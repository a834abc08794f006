"""Batch bridge: a numpy ``HierGraphBatch`` → the same container holding
torch tensors on a device, and the host→device move of a packed batch
buffer (data/packing.py).

Every array field becomes a tensor of the same dtype (f32 stays f32, i32
stays i32 — the kernels take int32 indices); the ``TileMeta`` (or
``EPTileMeta``) of each level carries its arrays as tensors too, and its
static widths unchanged. ``None``
stays ``None``, so the layer's dispatch sees exactly which kernel metadata
the batch has. A batch already on the target device (a device-cached batch,
data/batcher.py:DeviceCacheLoader) is returned as it is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np
import torch

from fragnet_tpu_torch.graphs.hiergraph import HierGraphBatch

_TM_FIELDS = ("tm_atom", "tm_bond", "tm_frag", "tm_fc")


def _device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with the current CUDA index filled in, so it compares equal
    to a tensor's ``.device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def to_device(batch: HierGraphBatch,
              device: Union[str, torch.device]) -> HierGraphBatch:
    device = _device(device)
    x = batch.x_atoms
    if isinstance(x, torch.Tensor) and x.device == device:
        return batch  # moved as a whole: already there
    kw = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is None:
            kw[f.name] = None
        elif f.name in _TM_FIELDS:
            kw[f.name] = dataclasses.replace(v, **{
                a.name: _tensor(getattr(v, a.name), device)
                for a in dataclasses.fields(v)
                if isinstance(getattr(v, a.name), (np.ndarray, torch.Tensor))})
        else:
            kw[f.name] = _tensor(v, device)
    return HierGraphBatch(**kw)


class PackedUploader:
    """Moves packed uint8 buffers to ``device``.

    To a CUDA device, each numpy buffer is copied into one of ``DEPTH``
    pinned host buffers and from there with a ``non_blocking`` copy on the
    current stream, so the host returns before the transfer ends. An event
    recorded after each copy guards its pinned buffer: the buffer is reused
    (``DEPTH`` uploads later) only once that event has completed, so a copy
    in flight is never overwritten. A buffer already on ``device`` is
    returned as it is; to the CPU a numpy buffer becomes a tensor (sharing
    its memory unless it is read-only)."""

    DEPTH = 3

    def __init__(self, device: Union[str, torch.device]):
        self.device = _device(device)
        self._pinned: List[torch.Tensor] = []
        self._events: List[torch.cuda.Event] = []
        self._next = 0

    def __call__(self, buf) -> torch.Tensor:
        if isinstance(buf, torch.Tensor):
            if buf.device == self.device:
                return buf
            buf = buf.cpu().numpy()
        buf = np.ascontiguousarray(buf)
        if self.device.type != "cuda":
            # a buffer received from a pack worker is read-only: copy it
            return torch.from_numpy(buf if buf.flags.writeable
                                    else buf.copy()).to(self.device)
        slot = self._next
        self._next = (slot + 1) % self.DEPTH
        if len(self._pinned) <= slot:
            self._pinned.append(torch.empty(buf.shape, dtype=torch.uint8,
                                            pin_memory=True))
            self._events.append(torch.cuda.Event())
        else:
            self._events[slot].synchronize()  # its last copy has finished
            if tuple(self._pinned[slot].shape) != buf.shape:
                self._pinned[slot] = torch.empty(buf.shape, dtype=torch.uint8,
                                                 pin_memory=True)
        pinned = self._pinned[slot]
        pinned.numpy()[...] = buf
        out = torch.empty(buf.shape, dtype=torch.uint8, device=self.device)
        out.copy_(pinned, non_blocking=True)
        self._events[slot].record(torch.cuda.current_stream(self.device))
        return out
