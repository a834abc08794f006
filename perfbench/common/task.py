"""What the two DTA drivers share: the program's DTA model from the
configuration with the weights from the seed, padded batches held on the
device as ``run_task`` holds them, and the reference's batches."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.common import pool, weights
from perfbench.reference import layout, model as ref


def build_model(cfg: Dict, ctx):
    from fragnet_tpu_torch.model.dta import DTAModel
    from fragnet_tpu_torch.model.layers import KernelPolicy

    m, p = cfg["model"], cfg["protein"]
    model = DTAModel(
        num_layer=m["num_layer"], num_heads=m["num_heads"],
        drop_ratio=m["drop_ratio"], emb_dim=m["emb_dim"],
        atom_features=m["atom_features"], frag_features=m["frag_features"],
        edge_features=m["edge_features"], fedge_in=m["fedge_in"],
        fbond_edge_in=m["fbond_edge_in"], protein_encoder="transformer",
        protein_vocab_size=p["vocab"], protein_layers=p["layers"],
        protein_heads=p["heads"], protein_intermediate=p["ffn"],
        protein_max_len=p["max_len"],
        policy=KernelPolicy(**cfg["kernel"])).to(ctx.device)
    w0 = weights.make(weights.shapes_of(model), ctx.sub_seed("weights"),
                      ctx.device)
    model.load_state_dict(w0, strict=True)
    return model, w0


def spec(probe: Sequence, batch: int, params: Dict):
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    return pool.cached_spec(
        {**params, "batch": batch},
        lambda: spec_for(list(probe), batch_size=batch, tcsr=True))


def draw_batches(rng: np.random.Generator, n_items: int, n_batches: int,
                 batch: int, graphs_of, spec_) -> List[np.ndarray]:
    """``n_batches`` disjoint batches of item ids, drawn again until every
    batch fits the spec and its pinned TCSR windows."""
    from fragnet_tpu_torch.graphs.hiergraph import fits, pad_batch

    while True:
        ids = rng.choice(n_items, n_batches * batch, replace=False)
        out = [ids[i * batch:(i + 1) * batch] for i in range(n_batches)]
        try:
            if all(fits(graphs_of(ix), spec_) for ix in out):
                for ix in out:
                    pad_batch(graphs_of(ix), spec_, strict_tcsr=True,
                              build_dense=False)
                return out
        except ValueError:
            pass


def device_batches(batches: Sequence[Sequence], spec_, device) -> list:
    """Each batch padded (with its dense planes) and moved to the device
    once, as ``run_task``'s device cache does."""
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch

    return [to_device(pad_batch(list(g), spec_), device) for g in batches]


def ref_batch(graphs: Sequence, probe: Sequence, batch: int, spec_,
              device, tokens: np.ndarray, labels: np.ndarray):
    rows = layout.padded_rows(list(probe), batch)
    spec_rows = {"atom": spec_.n_atoms, "bond": spec_.n_edges,
                 "frag": spec_.n_frags, "fc": spec_.n_fconn}
    if rows != spec_rows:
        raise RuntimeError(f"padded rows: reference {rows}, program "
                           f"{spec_rows}")
    return ref.make_batch(list(graphs), rows, layout.tiles(list(probe)),
                          device, proteins=tokens, labels=labels)


def release(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
