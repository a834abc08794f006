"""Edge-partitioned training on torch.distributed (counterpart of
fragnet_tpu/dist/edge_partition.py).

When one batch has more message edges than one card should hold, the EDGE
arrays of every level are split into one contiguous shard per rank and the
node state stays replicated. Two modes, chosen per batch by its metadata,
as in the JAX package:

  * the fused mode (a batch with every shard's ``EPTileMeta``): each rank
    runs K3 (ops/tcsr_gat.py:tcsr_gat_pass_ep) on its shard's
    destination-tile grid, and the softmax statistics combine across the
    ranks with an all-gather. Every rank builds every shard's
    ``EPTileMeta``, so each knows the others' grid rows. A bf16 model runs
    K3's bf16 entries on its shard; the statistics, the gathered sums and
    the gradients stay f32.
  * the segment mode (a batch with no tile metadata; ``dist.tcsr=false``,
    or the fused mode's pins failed): each rank runs the segment pass on
    its shard (ops/segment.py:gat_attention_pass with ``ep``) and the
    statistics combine with three all-reduces, MAX, SUM, SUM (and a fourth
    SUM for the attention vectors when asked for):

        m      = max over ranks of the local segment max of the logits
        denom  = Σ over ranks of the local Σ exp(logit − m)
        out    = Σ over ranks of the local Σ prob·h_src

    The JAX package computes it with XLA segment ops and mesh collectives,
    no Pallas kernel, so on the card it runs as torch ops.

Gradient convention (the one shard_map's transposes give the JAX package):
every rank computes the same replicated forward and the same loss, unscaled;
the differentiable all-gather's backward all-reduces (SUM) the cotangent
and keeps the rank's block, so a shard's sums receive S times their true
cotangent; after ``backward()`` every parameter gradient is averaged over
the ranks (data_parallel.average_gradients). Replicated contributions
average to themselves, each shard's, carried at S×, to the true sum over
shards — one update equals the single-device update on the whole batch.
Dropout acts on replicated tensors, so every rank draws the same masks:
the step seeds every rank identically from the step count. The replicated
forward is the same on every rank only up to the order of CUDA's atomic
sums, so the steps return the loss and predictions averaged over the ranks:
every rank then reads the same values, and makes the same early-stopping
decision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from fragnet_tpu_torch.dist.collectives import all_reduce, all_reduce_sum
from fragnet_tpu_torch.dist.data_parallel import average_gradients

# per-level EDGE arrays split over the ranks; node-space state replicated
EP_SHARDED_FIELDS = (
    "edge_src", "edge_dst",
    "bg_src", "bg_dst", "bg_mask", "ea_bonds",
    "frag_src", "frag_dst",
    "fc_src", "fc_dst", "fc_mask", "ea_fbonds",
)


@dataclasses.dataclass(frozen=True)
class EPContext:
    """What an edge-partitioned layer needs to know of the ranks (the JAX
    package's ``ep_axis``): this rank, the number of shards and the process
    group (None: the default group)."""

    rank: int
    size: int
    group: object = None


def shard_edges(arrs, n_shards: int, pad_value=0):
    """Pad each (E, ...) array to a multiple of ``n_shards`` and reshape to
    (n_shards, E/n_shards, ...). The LAST array must be the edge mask — its
    padding is forced to 0."""
    out = []
    E = arrs[0].shape[0]
    Ep = ((E + n_shards - 1) // n_shards) * n_shards
    for i, a in enumerate(arrs):
        pad = [(0, Ep - E)] + [(0, 0)] * (a.ndim - 1)
        fill = pad_value if i < len(arrs) - 1 else 0
        ap = np.pad(np.asarray(a), pad, constant_values=fill)
        out.append(ap.reshape((n_shards, Ep // n_shards) + a.shape[1:]))
    return out


def edge_partitioned_gat_pass(
    ctx: EPContext,
    node_feats_h: torch.Tensor,   # (N, H, D) — replicated
    edge_attr_h: torch.Tensor,    # (S, Es, H, Da) — every shard's
    src: torch.Tensor,            # (S, Es)
    dst: torch.Tensor,            # (S, Es)
    edge_mask: torch.Tensor,      # (S, Es)
    attn_vec: torch.Tensor,       # (H, 2D+Da) — replicated
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Same math as ops.segment.gat_attention_pass over the union of all
    edge shards (``shard_edges``' layout); every rank of ``ctx.group``
    calls it with the same arrays and computes on its own shard,
    ``ctx.rank``: the segment EP pass (the JAX package's ``_local_pass``,
    whose numerator it normalises before the sum instead of after).
    Returns the replicated (N, H, D) aggregate."""
    from fragnet_tpu_torch.ops.segment import gat_attention_pass

    r = ctx.rank
    return gat_attention_pass(node_feats_h, edge_attr_h[r], src[r], dst[r],
                              attn_vec, node_feats_h.shape[0],
                              edge_mask=edge_mask[r],
                              negative_slope=negative_slope, ep=ctx,
                              need_attn=False)[0]


def edge_partitioned_segment_sum(
    ctx: EPContext,
    data: torch.Tensor,           # (S*R, ...) row-sharded
    segment_ids: torch.Tensor,    # (S*R,) row-sharded
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-shard segment sum (atom→fragment pooling when atoms are
    partitioned): this rank's contiguous block of rows summed locally,
    then one differentiable SUM all-reduce. Every rank passes the whole
    arrays."""
    from fragnet_tpu_torch.ops.segment import segment_sum

    R = data.shape[0] // ctx.size
    rows = slice(ctx.rank * R, (ctx.rank + 1) * R)
    part = segment_sum(data[rows], segment_ids[rows], num_segments,
                       mask=None if mask is None else mask[rows])
    return all_reduce_sum(part, ctx.group)


def with_ep_tile_meta(batch, n_shards: int, tn: int = 128, te: int = 256,
                      pins: Optional[dict] = None):
    """Attach per-shard TCSR metadata (ops/tcsr.py:EPTileMeta) for all four
    levels. Returns ``(batch, True)`` on success or the unchanged batch +
    False when any level violates the layout assumptions. Edge counts must
    be divisible by n_shards·te and node counts by tn. ``pins`` optionally
    fixes the widths per level ({'tm_atom': (Tg, n_chunks, k_src), ...})
    so every batch of a run has the same grid and windows."""
    from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta

    def pin_kw(level):
        if pins is None or level not in pins:
            return {}
        tg, c, k = pins[level]
        return {"n_tiles_grid": tg, "n_chunks": c, "k_src": k}

    tms = dict(
        tm_atom=build_ep_tile_meta(
            batch.edge_src, batch.edge_dst, batch.edge_mask,
            batch.x_atoms.shape[0], n_shards, tn, te, **pin_kw("tm_atom")),
        tm_bond=build_ep_tile_meta(
            batch.bg_src, batch.bg_dst, batch.bg_mask,
            batch.nf_bonds.shape[0], n_shards, tn, te, **pin_kw("tm_bond")),
        tm_frag=build_ep_tile_meta(
            batch.frag_src, batch.frag_dst, batch.fconn_mask,
            batch.x_frags.shape[0], n_shards, tn, te, **pin_kw("tm_frag")),
        tm_fc=build_ep_tile_meta(
            batch.fc_src, batch.fc_dst, batch.fc_mask,
            batch.nf_fbonds.shape[0], n_shards, tn, te, **pin_kw("tm_fc")),
    )
    if any(v is None for v in tms.values()):
        return batch, False
    return dataclasses.replace(batch, **tms), True


_LEVELS = ("tm_atom", "tm_bond", "tm_frag", "tm_fc")


def pin_ep_widths(loaders, n_shards: int, tn: int = 128, te: int = 256,
                  n_probe_epochs: int = 2) -> dict:
    """Probe full epochs of every loader and return ONE set of per-level
    widths {'tm_atom': (Tg, n_chunks, k_src), ...} with one unit of slack on
    each (shuffling loaders re-window molecules per epoch;
    build_ep_tile_meta clamps each pin to its array bound)."""
    pins: dict = {}
    for loader in loaders:
        for _ in range(n_probe_epochs):
            for b in loader:
                b2, ok = with_ep_tile_meta(b, n_shards, tn, te)
                if not ok:
                    raise ValueError(
                        "EP tile-meta probe failed: batch violates TCSR "
                        "layout (pad edge counts to a multiple of "
                        "n_shards*te and node counts to tn)")
                for lvl in _LEVELS:
                    tm = getattr(b2, lvl)
                    cur = pins.get(lvl, (1, 1, 1))
                    pins[lvl] = (max(cur[0], tm.n_tiles_grid),
                                 max(cur[1], tm.n_chunks),
                                 max(cur[2], tm.k_src))
    return {lvl: (tg + 1, c + 1, k + 1) for lvl, (tg, c, k) in pins.items()}


class EPMetaLoader:
    """Wraps a batch loader for edge-partitioned training: attaches pinned
    EPTileMeta (``pins`` from pin_ep_widths over all of a run's loaders, or
    probed from this one) to every yielded batch. Raises, as the JAX
    loader does, when a later batch exceeds the pinned windows."""

    def __init__(self, loader, n_shards: int, tn: int = 128, te: int = 256,
                 n_probe_epochs: int = 2, pins: Optional[dict] = None):
        self.loader = loader
        self.n_shards = n_shards
        self.tn, self.te = tn, te
        self.pins = pins if pins is not None else pin_ep_widths(
            [loader], n_shards, tn, te, n_probe_epochs)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            b2, ok = with_ep_tile_meta(b, self.n_shards, self.tn, self.te,
                                       pins=self.pins)
            if not ok:
                raise RuntimeError(
                    "batch exceeds the pinned EP tile windows; re-run with "
                    "a larger probe")
            yield b2


def ep_local_batch(batch, rank: int, n_shards: int):
    """Rank ``rank``'s view of an edge-partitioned batch (the JAX package's
    ``ep_batch_specs``): its contiguous slice of every field in
    EP_SHARDED_FIELDS, everything else whole. A batch whose four levels
    carry ``n_shards``-shard EPTileMeta (the fused mode) keeps them whole,
    since the pass reads its own rows by rank and every shard's t0; a batch
    with no tile metadata (the segment mode) has each sharded field padded
    to a multiple of ``n_shards`` first, as ``shard_edges`` pads (the
    masks' padding 0). Single-device TileMeta, or a mix, raises; so do ELL
    tables, as in the JAX package."""
    from fragnet_tpu_torch.ops.tcsr import EPTileMeta

    if batch.atom_nbr_edge is not None:
        raise ValueError("edge-partitioned mode does not support ELL tables")

    tms = [getattr(batch, lvl) for lvl in _LEVELS]
    fused = all(isinstance(tm, EPTileMeta) and tm.ew_blk.shape[0] == n_shards
                for tm in tms)
    if not fused and any(tm is not None for tm in tms):
        lvl, tm = next((lvl, tm) for lvl, tm in zip(_LEVELS, tms)
                       if not isinstance(tm, EPTileMeta)
                       or tm.ew_blk.shape[0] != n_shards)
        raise ValueError(
            f"edge-partitioned mode needs {n_shards}-shard EPTileMeta "
            f"for {lvl} (with_ep_tile_meta), or no tile metadata at all "
            f"(the segment path), got {type(tm).__name__}")
    kw = {}
    for name in EP_SHARDED_FIELDS:
        v = getattr(batch, name)
        n = v.shape[0]
        if n % n_shards:
            if fused:
                raise ValueError(f"{name}: {n} rows do not split into "
                                 f"{n_shards} shards")
            pad = n_shards - n % n_shards
            v = _pad_rows(v, pad)
        es = v.shape[0] // n_shards
        kw[name] = v[rank * es:(rank + 1) * es]
    return dataclasses.replace(batch, **kw)


def _pad_rows(v, pad: int):
    """``v`` (numpy or torch) with ``pad`` zero rows appended."""
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    return np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])


def shard_rows(x, ctx: EPContext, n: int):
    """Rows ``[rank·n, (rank+1)·n)`` of a replicated (M, ...) tensor, padded
    with zero rows to ``n`` where M is not a multiple of the shard count:
    a layer's slice of the per-edge features that match its sharded edge
    arrays (``ep_local_batch``)."""
    part = x[ctx.rank * n:(ctx.rank + 1) * n]
    return part if part.shape[0] == n else _pad_rows(part, n - part.shape[0])


def make_ep_train_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, ctx: EPContext,
                       loss_name: str = "mse",
                       device: Union[str, torch.device] = "cuda",
                       scheduler=None, seed: int = 0) -> Callable:
    """``train_step(batch) -> loss`` (averaged over the ranks): ``model``
    must be built with ``ep=ctx``. Each rank runs the forward on its slice
    of the batch (the replicated loss), the backward, the gradient average
    over the ranks, then the optimizer and scheduler step; dropout is
    seeded from ``seed`` and the step count, the same on every rank."""
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import LOSSES

    loss_fn = LOSSES[loss_name]
    n_steps = [0]

    def train_step(batch):
        b = ep_local_batch(to_device(batch, device), ctx.rank, ctx.size)
        torch.manual_seed(seed + n_steps[0])
        n_steps[0] += 1
        model.train()
        loss = loss_fn(model(b), b.y, b.graph_mask)
        loss.backward()
        average_gradients(list(model.parameters()), ctx.group)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        optimizer.zero_grad(set_to_none=True)
        return all_reduce(loss.detach(), ctx.group, average=True)

    return train_step


def make_ep_eval_step(model: torch.nn.Module, ctx: EPContext,
                      loss_name: str = "mse",
                      device: Union[str, torch.device] = "cuda") -> Callable:
    """``eval_step(batch) -> (loss, predictions)``, both averaged over the
    ranks."""
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import LOSSES

    loss_fn = LOSSES[loss_name]

    def eval_step(batch):
        b = ep_local_batch(to_device(batch, device), ctx.rank, ctx.size)
        model.eval()
        with torch.no_grad():
            out = model(b)
            loss = loss_fn(out, b.y, b.graph_mask)
        return (all_reduce(loss, ctx.group, average=True),
                all_reduce(out, ctx.group, average=True))

    return eval_step
