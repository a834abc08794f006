"""Masking-based contribution attribution on replica batches (counterpart
of fragnet_tpu/interp/attribution.py).

Reference behavior (fragnet/vizualize/viz.py:901-1167 and model_attr.py):
contribution(entity) = prediction(unmasked) − prediction(entity masked at
every layer). The JAX package vmaps the masked forward over entity
indices; a kernel launched through ctypes does not batch under
``torch.func.vmap``, so here each family is ONE forward over a replica
batch: replica 0 is the molecule unmasked, replica 1 + r the molecule with
entity r masked in every layer. The batch is tile-aligned with TCSR
metadata and dense planes, as ``run_finetune`` builds it, so on the card
every GAT pass runs a kernel; on the CPU the same code runs the kernels'
plain versions. Each replica's masks are explicit rows found from that
replica's own offsets in the padded batch (an aligned replica may start at
a tile boundary, not at r · n) and never touch another replica's rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.hiergraph import (HierGraphBatch, pad_batch,
                                                spec_for)
from fragnet_tpu_torch.model.layers import LayerHooks

FAMILIES = ("atom", "bond", "fconn", "fragment")


def n_connections(graph) -> int:
    """A graph's fragment connections: pairs of directed fconn rows, or the
    one unpaired self_cn row of a single-fragment molecule (the exp1s
    rule; the two layouts never mix)."""
    if graph.n_fconn >= 2 and graph.n_frags > 1:
        return graph.n_fconn // 2
    return graph.n_fconn


def family_sizes(graph) -> Dict[str, int]:
    """The entities ``FragNetInterpreter.interpret`` masks, by family:
    atoms, undirected bonds, fragment connections (at least one, as in the
    JAX package) and fragments — one replica each."""
    return {"atom": graph.n_atoms, "bond": graph.n_edges // 2,
            "fconn": max(n_connections(graph), 1), "fragment": graph.n_frags}


def pad_graphs(graphs: Sequence) -> HierGraphBatch:
    """One host batch of ``graphs``: tile-aligned, with TCSR metadata and
    every dense plane level (the kernel paths' batch, on any device)."""
    spec = spec_for(list(graphs), batch_size=len(graphs), tcsr=True)
    return pad_batch(list(graphs), spec, strict_tcsr=True)


def _first_rows(owner: np.ndarray, mask: np.ndarray, n: int) -> np.ndarray:
    """The first real row of each of graphs 0..n-1 on one axis, from the
    rows' owning graph and mask."""
    out = np.empty((n,), np.int64)
    for g in range(n):
        out[g] = np.flatnonzero((owner == g) & (mask > 0))[0]
    return out


def _pair_rows(start: np.ndarray, n_rows: int) -> np.ndarray:
    """Rows 2r, 2r+1 of replica 1 + r, offset by its start, kept inside its
    own ``n_rows`` rows: a single-fragment molecule's one (self_cn) fconn
    row has no partner, and the row after it is the next replica's."""
    r = np.arange(start.shape[0])
    rows = np.stack([2 * r, 2 * r + 1], axis=1)
    return (rows + start[:, None])[rows < n_rows]


def replica_batch(graph, family: str, n: int
                  ) -> Tuple[HierGraphBatch, Dict[str, np.ndarray]]:
    """(host batch of 1 + n copies of ``graph``, the LayerHooks fields that
    mask entity r of ``family`` in replica 1 + r and nothing in replica 0)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r} {FAMILIES}")
    b = pad_graphs([graph] * (n + 1))
    R = n + 1
    if family == "atom":
        a_off = _first_rows(b.atom_batch, b.atom_mask, R)[1:]
        return b, {"atom_rows": a_off + np.arange(n)}
    if family == "bond":
        e_off = _first_rows(b.atom_batch[b.edge_src], b.edge_mask, R)[1:]
        return b, {"bond_rows": _pair_rows(e_off, graph.n_edges)}
    if family == "fconn":
        c_off = _first_rows(b.frag_batch[b.frag_src], b.fconn_mask, R)[1:]
        return b, {"fconn_rows": _pair_rows(c_off, graph.n_fconn)}
    f_off = _first_rows(b.frag_batch, b.frag_mask, R)[1:]
    vec = np.isin(b.atom_to_frag, f_off + np.arange(n)) * b.atom_mask
    return b, {"atom_zero_vec": vec.astype(np.float32)}


def predict(model, batch, hooks: Optional[LayerHooks] = None,
            return_attentions: bool = False):
    """The model's forward, dropout off, on a host (or device) batch moved
    to the model's device; ``hooks`` applies to every layer."""
    dev = next(model.parameters()).device
    hl = None if hooks is None else [hooks] * len(model.pretrain.layers)
    with torch.no_grad():
        return model(to_device(batch, dev),
                     return_attentions=return_attentions, hooks=hl)


def _first_task(pred: torch.Tensor) -> np.ndarray:
    pred = pred[:, 0] if pred.ndim == 2 else pred
    return pred.cpu().numpy()


def _contributions(model, graph, family: str, n: int) -> np.ndarray:
    if n <= 0:
        return np.zeros((0,), np.float32)
    batch, fields = replica_batch(graph, family, n)
    dev = next(model.parameters()).device
    hooks = LayerHooks(**{k: torch.as_tensor(v, device=dev)
                          for k, v in fields.items()})
    pred = _first_task(predict(model, batch, hooks))
    return pred[0] - pred[1:n + 1]


def atom_contributions(model, graph, n_atoms: Optional[int] = None
                       ) -> np.ndarray:
    """Per-atom contribution = pred − pred(atom hidden state zeroed in every
    layer) (viz.py:901-936). Returns (n_atoms,)."""
    n = graph.n_atoms if n_atoms is None else n_atoms
    return _contributions(model, graph, "atom", n)


def bond_contributions(model, graph, n_bonds: Optional[int] = None
                       ) -> np.ndarray:
    """Per-(undirected)-bond contribution: bond k masks directed-edge rows
    2k, 2k+1 of the evolving bond features in every layer (viz.py:986-1050;
    gat2.py:171-177)."""
    n = graph.n_edges // 2 if n_bonds is None else n_bonds
    return _contributions(model, graph, "bond", n)


def fconn_contributions(model, graph, n_conn: Optional[int] = None
                        ) -> np.ndarray:
    """Per-fragment-connection contribution: connection k masks fconn rows
    2k, 2k+1 (viz.py:1063-1167; gat2.py:274-278) — the one row of a
    single-fragment molecule's self connection."""
    n = n_connections(graph) if n_conn is None else n_conn
    return _contributions(model, graph, "fconn", n)


def fragment_contributions(model, graph, n_frags: Optional[int] = None
                           ) -> np.ndarray:
    """Per-fragment contribution: zero ALL atoms of the fragment after every
    layer (model_attr.py:734-766, 115-133)."""
    n = graph.n_frags if n_frags is None else n_frags
    return _contributions(model, graph, "fragment", n)
