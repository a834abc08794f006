"""Pretraining entry point of the port: the 4-target geometric objective
(counterpart of fragnet_tpu/train/pretrain.py; reference
fragnet/train/pretrain/pretrain_gat2.py and pretrain_utils.py:4-56).

Usage:
    python -m fragnet_tpu_torch.train.pretrain --config configs/pt/unimol.yaml \
        [k=v ...] [--device cuda|cpu]

The reference's loss overwrites the bond-length term with the dihedral term,
making the effective loss angle + 2·dihedral + energy (pretrain_utils.py:
22-26); the default is the intended sum of all four, and
``pretrain.compat_loss_overwrite=true`` reproduces the reference.

On CUDA, when the train set is not cached on the device (``pretrain.cache``
off, or a set beyond ``fastpath.CACHE_BUDGET_BYTES`` — any real pretraining
set), training runs from packed single-buffer batches (data/packing.py):
kept on the device when they fit ``pretrain.hbm_cache_gb``, else in host
memory within ``pretrain.host_cache_gb``, else packed every epoch by spawned
workers. The step decodes each buffer on the device and rebuilds the dense
planes there with the plane builder kernel (ops/dense_gat.py).

``pretrain.mode=property|structure`` runs the auxiliary pretraining
(``run_aux_pretrain``): FragNetFineTune on a property table's columns or on
each molecule's ring count (31 classes, ``pretrain.loss=cel``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch


def pretrain_loss(preds, batch, compat_loss_overwrite: bool = False
                  ) -> torch.Tensor:
    """Masked MSE over the four geometric targets."""
    bl, ba, da, energy = preds
    e_mask = batch.edge_mask[:, None]
    a_mask = batch.atom_mask[:, None]
    g_mask = batch.graph_mask

    def mse(pred, true, mask):
        return torch.sum((pred - true) ** 2 * mask) / torch.clamp(
            torch.sum(mask), min=1.0)

    loss_angle = mse(ba, batch.bnd_angl, a_mask)
    loss_e = torch.sum((energy[:, 0] - batch.y[:, 0]) ** 2 * g_mask) \
        / torch.clamp(torch.sum(g_mask), min=1.0)
    if compat_loss_overwrite:
        # Reference quirks reproduced exactly (pretrain_utils.py:22-26):
        # (1) loss_lngth is overwritten by the dihedral term, so the total is
        #     angle + 2·dihedral + energy;
        # (2) that dihedral term is MSELoss(da_pred (E,1), dh_true (E,)) —
        #     a silent torch broadcast to (E,E). Its mean decomposes into
        #     per-array moments, computable in O(E):
        #     mean_{i,j}(p_i − t_j)² = E[p²] − 2·E[p]·E[t] + E[t²].
        em = batch.edge_mask
        ne = torch.clamp(torch.sum(em), min=1.0)
        p = da[:, 0] * em
        t = batch.dh_angl.reshape(-1) * em
        bcast_dihed = (torch.sum(p * p) / ne
                       - 2.0 * (torch.sum(p) / ne) * (torch.sum(t) / ne)
                       + torch.sum(t * t) / ne)
        return bcast_dihed + loss_angle + bcast_dihed + loss_e
    loss_lngth = mse(bl, batch.bnd_lngth, e_mask)
    loss_dihed = mse(da, batch.dh_angl, e_mask)
    return loss_lngth + loss_angle + loss_dihed + loss_e


def make_pretrain_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       compat_loss_overwrite: bool = False,
                       layout=None,
                       device: Union[str, torch.device] = "cuda") -> Callable:
    """``step(batch) -> loss`` (a 0-d device tensor; the step does not wait
    for the device). ``batch`` is a HierGraphBatch (numpy, or already on
    ``device``), or with ``layout`` (a data.packing.PackLayout) a packed
    uint8 buffer: moved to ``device`` through pinned memory and decoded
    there, the dense planes that the model's kernel policy reads rebuilt
    by the plane builder."""
    from fragnet_tpu_torch import obs
    from fragnet_tpu_torch.data.packing import plane_levels, unpack_batch
    from fragnet_tpu_torch.graphs.batch import PackedUploader, to_device
    from fragnet_tpu_torch.train.loop import apply_gradients

    upload = PackedUploader(device) if layout is not None else None
    planes = plane_levels(model.policy)

    def step(batch):
        with obs.span("fragnet.step"):
            with obs.span("fragnet.data.upload"):
                b = to_device(batch, device) if layout is None \
                    else upload(batch)
            if layout is not None:
                b = unpack_batch(b, layout, planes)
            model.train()
            with obs.span("fragnet.model.forward"):
                preds = model(b)
            with obs.span("fragnet.train.loss"):
                loss = pretrain_loss(preds, b, compat_loss_overwrite)
            apply_gradients(loss, optimizer)
            return loss.detach()

    return step


def make_pretrain_eval(model: torch.nn.Module,
                       compat_loss_overwrite: bool = False,
                       device: Union[str, torch.device] = "cuda") -> Callable:
    from fragnet_tpu_torch.graphs.batch import to_device

    def eval_step(batch):
        b = to_device(batch, device)
        model.eval()
        with torch.no_grad():
            return pretrain_loss(model(b), b, compat_loss_overwrite)

    return eval_step


class PretrainTrainer:
    """Epoch driver (reference pretrain_utils.Trainer:4-56).

    ``layout``: when set, the step consumes packed uint8 buffers (the
    packed-transport path, data/packing.py) and decodes them on the
    device."""

    def __init__(self, model, optimizer, compat_loss_overwrite: bool = False,
                 layout=None, device: Union[str, torch.device] = "cuda"):
        self.model = model
        self._step = make_pretrain_step(model, optimizer,
                                        compat_loss_overwrite, layout=layout,
                                        device=device)
        self._eval = make_pretrain_eval(model, compat_loss_overwrite, device)

    def train_epoch(self, batches: Iterable) -> float:
        """Mean step loss; the losses are fetched once, after the last
        step."""
        it = batches.prefetch() if hasattr(batches, "prefetch") else batches
        return _mean([self._step(b) for b in it])

    def validate(self, batches: Iterable) -> float:
        total, n = 0.0, 0
        for batch in batches:
            total += float(self._eval(batch))
            n += 1
        return total / max(n, 1)


def _mean(losses: List[torch.Tensor]) -> float:
    if not losses:
        return 0.0
    return float(torch.stack(losses).double().sum()) / len(losses)


def structure_ring_count(mol) -> int:
    """SSSR ring count via the cyclomatic number B − A + components — the
    nRings structure-pretraining target (pretrain_gat_str.py; n_classes=31)
    of a chem/mol.py molecule (the JAX package's also takes an RDKit one,
    which neither package's machines have)."""
    return max(0, mol.GetNumBonds() - mol.GetNumAtoms()
               + len(mol.connected_components()))


def aux_targets(opt):
    """(SMILES, per-molecule target lists, n_classes) of the auxiliary
    pretraining: ``pretrain.prop_csv``'s rows (or ``n_synthetic`` synthetic
    molecules) with their property columns (``target_pos`` picks one), or
    in ``structure`` mode each molecule's ring count (molecules whose 3D
    embedding fails are dropped)."""
    from fragnet_tpu_torch.chem import engine
    from fragnet_tpu_torch.data.synthetic import synthetic_dataset
    from fragnet_tpu_torch.data.tables import read_csv

    seed = int(opt.get("seed", 42))
    pt = opt.pretrain
    prop_csv = pt.get("prop_csv", None)
    if prop_csv:
        # the numbers parsed as pandas' read_csv parses them
        df = read_csv(prop_csv)
    else:
        df = synthetic_dataset(n=int(pt.get("n_synthetic", 128)),
                               task="regression", seed=seed)
    smiles = list(df["smiles"])
    if pt.get("mode", "property") == "structure":
        # ring-count target computed on the fly (pretrain_gat_str.py)
        pairs = []
        for s in smiles:
            r = engine.mol_3d(s, seed=seed)
            if r:
                pairs.append((s, [float(structure_ring_count(r[0]))]))
        return ([p[0] for p in pairs], [p[1] for p in pairs],
                int(pt.get("n_classes", 31)))
    tcols = [c for c in df if c != "smiles"]
    tp = pt.get("target_pos", None)
    if tp is not None:
        tcols = [tcols[int(tp)]]
    targets = [[float(df[c][i]) for c in tcols] for i in range(len(smiles))]
    return smiles, targets, int(pt.get("n_classes", len(tcols)))


def cel_loss(out: torch.Tensor, y: torch.Tensor,
             graph_mask: torch.Tensor) -> torch.Tensor:
    """Integer-class cross-entropy on the labels ``y[:, 0]`` over real
    graphs (optax.softmax_cross_entropy_with_integer_labels, masked, over
    max(Σ mask, 1)); padding graphs carry label 0 and mask 0 and add
    nothing."""
    labels = y[:, 0].long()
    ls = torch.nn.functional.cross_entropy(out, labels, reduction="none")
    return torch.sum(ls * graph_mask) / torch.clamp(torch.sum(graph_mask),
                                                    min=1.0)


def build_aux_model(opt, n_classes: int, policy=None,
                    generator: Optional[torch.Generator] = None,
                    dtype: torch.dtype = torch.float32):
    """The auxiliary pretraining's model: FragNetFineTune with
    ``n_classes`` outputs at ``pretrain.model``'s encoder widths (its head
    at the class defaults, as the JAX package builds it), its encoder
    computing in ``dtype``."""
    from fragnet_tpu_torch.model.finetune import FragNetFineTune
    from fragnet_tpu_torch.model.layers import KernelPolicy

    m = opt.pretrain.get("model", {})
    return FragNetFineTune(
        n_classes=n_classes,
        num_layer=int(m.get("num_layer", 4)),
        num_heads=int(m.get("num_heads", 4)),
        drop_ratio=float(m.get("drop_ratio", 0.15)),
        emb_dim=int(m.get("emb_dim", 128)),
        atom_features=int(opt.get("atom_features", 167)),
        frag_features=int(opt.get("frag_features", 167)),
        edge_features=int(opt.get("edge_features", 17)),
        fedge_in=int(opt.get("fedge_in", 6)),
        fbond_edge_in=int(opt.get("fbond_edge_in", 6)),
        policy=policy or KernelPolicy(), generator=generator, dtype=dtype,
    )


def run_aux_pretrain(opt, quiet: bool = False,
                     device: Union[str, torch.device, None] = None):
    """Molecular-property / structure-property pretraining — the analogs of
    pretrain_gat_mol.py:33-97 (multi-property regression from a CSV keyed by
    SMILES) and pretrain_gat_str.py (ring-count classification); the JAX
    package's run_aux_pretrain. Model is the standard finetune
    architecture (the reference trains FragNetFineTune on the auxiliary
    target); the checkpoint ``exp_dir/<chkpoint_name>`` is its state dict,
    whose ``pretrain.*`` encoder ``run_finetune`` transfers with
    ``pretrain.use``. Loss ``mse`` or ``cel`` (``pretrain.loss``; the
    structure mode's classes take ``cel``). ``pretrain.dtype`` (f32 or
    bf16) is the encoder's compute type, as in the JAX package. Runs on
    CUDA unless ``device="cpu"``. Returns (best score, checkpoint path)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.datasets import build_graphs
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.obs import ScalarLogger
    from fragnet_tpu_torch.train import fastpath
    from fragnet_tpu_torch.train.checkpoint import save_params
    from fragnet_tpu_torch.train.earlystop import EarlyStopping
    from fragnet_tpu_torch.train.finetune import seed_everything
    from fragnet_tpu_torch.train.loop import (TrainerFineTune,
                                              make_eval_step, make_train_step)
    from fragnet_tpu_torch.train.optim import make_optimizer

    seed = int(opt.get("seed", 42))
    seed_everything(seed)
    exp_dir = opt.get("exp_dir", "exps/pt_aux")
    os.makedirs(exp_dir, exist_ok=True)
    pt = opt.pretrain
    mode = pt.get("mode", "property")
    loss_name = pt.get("loss", "mse")

    smiles, targets, n_classes = aux_targets(opt)
    graphs = build_graphs(smiles, targets)
    if not quiet:
        print(f"aux pretrain ({mode}): {len(graphs)} graphs, "
              f"n_classes={n_classes}, loss={loss_name}")
    train_g, val_g = split_graphs(graphs, seed)

    fp = fastpath.resolve(pt, model_version="gat2", device=device)
    fastpath.reduce_bf16_gemms_in_f32(fp)
    bs = int(pt.get("batch_size", 32))
    spec = spec_for(graphs, batch_size=bs, tcsr=fp.tcsr)
    n_tasks_data = 1 if (mode == "structure" or loss_name == "cel") else n_classes
    train_loader = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                               seed=seed, n_tasks=n_tasks_data)
    val_loader = BatchLoader(val_g, bs, spec=spec, n_tasks=n_tasks_data)
    train_loader = fastpath.maybe_cache(train_loader, fp.device, spec=spec,
                                        n_tasks=n_tasks_data,
                                        policy=fp.cache, seed=seed)
    val_loader = fastpath.maybe_cache(val_loader, fp.device, spec=spec,
                                      n_tasks=n_tasks_data,
                                      policy=fp.cache, seed=seed + 1)

    model = build_aux_model(opt, n_classes, policy=fp.kernel,
                            generator=torch.Generator().manual_seed(seed),
                            dtype=fp.dtype).to(fp.device)
    # the JAX package draws an init batch here (model.init), which advances
    # the train loader's shuffle state
    next(iter(train_loader))
    optimizer, _ = make_optimizer(model.parameters(),
                                  pt.get("optimizer", "adam"),
                                  lr=float(pt.get("lr", 1e-4)))

    steps = {}
    if loss_name == "cel":
        # integer-class cross-entropy (pretrain_gat_mol.py:80 'cel' branch)
        steps = dict(
            train_step=make_train_step(model, optimizer, cel_loss,
                                       fp.device),
            eval_step=make_eval_step(model, cel_loss, fp.device))
    trainer = TrainerFineTune(model, optimizer, target_type="regr",
                              device=fp.device, **steps)

    ckpt = os.path.join(exp_dir, pt.get("chkpoint_name", "pt_aux.ckpt"))
    es = EarlyStopping(patience=int(pt.get("es_patience", 50)), path=ckpt,
                       save_fn=save_params)
    t0 = time.time()
    with ScalarLogger(exp_dir) as logger:
        for epoch in range(int(pt.get("n_epochs", 50))):
            train_loss = trainer.train_epoch(train_loader)
            val_loss = trainer.validate(val_loader)
            es(val_loss, model)
            logger.log("train/loss", train_loss, epoch)
            logger.log("val/loss", val_loss, epoch)
            if not quiet and epoch % 5 == 0:
                print(f"epoch {epoch:4d} train {train_loss:.5f} "
                      f"val {val_loss:.5f} [{time.time() - t0:.1f}s]")
            if es.early_stop:
                break
    return es.best_score, ckpt


def load_pretrain_graphs(opt) -> list:
    """The pretraining set: pickle shards from ``pretrain.data_dir``, else
    ``pretrain.n_synthetic`` synthetic SMILES featurized with their
    conformer geometry targets and force-field energy."""
    from fragnet_tpu_torch.data.datasets import PretrainData, load_data_parts
    from fragnet_tpu_torch.data.synthetic import synthetic_dataset

    pt = opt.pretrain
    seed = int(opt.get("seed", 42))
    if pt.get("data_dir", None):
        return load_data_parts(pt.data_dir, dedup=False)
    df = synthetic_dataset(n=int(pt.get("n_synthetic", 256)),
                           task="regression", seed=seed)
    maker = PretrainData(data_type=opt.get("data_type", "exp1s"),
                         num_conf=int(pt.get("num_conf", 1)),
                         compat_reference_targets=bool(
                             pt.get("compat_reference_targets", False)))
    return maker.get_pt_dataset(list(df["smiles"]), seed=seed)


def split_graphs(graphs: list, seed: int) -> Tuple[list, list]:
    """(train, val): a seeded permutation, the first tenth (at least one
    graph) for validation."""
    order = np.random.default_rng(seed).permutation(len(graphs))
    n_val = max(1, len(graphs) // 10)
    return ([graphs[i] for i in order[n_val:]],
            [graphs[i] for i in order[:n_val]])


def build_pretrain_model(opt, policy=None,
                         generator: Optional[torch.Generator] = None,
                         dtype: torch.dtype = torch.float32):
    """FragNetPreTrain (or a masked variant, ``pretrain.model_version``)
    at the config's widths, its encoder computing in ``dtype``."""
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.model.pretrain import (FragNetPreTrain,
                                                  FragNetPreTrainMasked,
                                                  FragNetPreTrainMasked2)

    pt = opt.pretrain
    m = pt.get("model", {})
    kw = dict(
        num_layer=int(m.get("num_layer", 4)),
        num_heads=int(m.get("num_heads", 4)),
        drop_ratio=float(m.get("drop_ratio", 0.2)),
        emb_dim=int(m.get("emb_dim", 128)),
        atom_features=int(opt.get("atom_features", 167)),
        frag_features=int(opt.get("frag_features", 167)),
        edge_features=int(opt.get("edge_features", 17)),
        fedge_in=int(opt.get("fedge_in", 6)),
        fbond_edge_in=int(opt.get("fbond_edge_in", 6)),
        policy=policy or KernelPolicy(),
        generator=generator,
        dtype=dtype,
    )
    mv = pt.get("model_version", "gat2")
    seed = int(opt.get("seed", 42))
    if mv == "gat2_masked":
        return FragNetPreTrainMasked(mask_seed=seed, **kw)
    if mv == "gat2_masked2":
        # input-level 30% feature masking (pretrain_heads.py:219-228)
        return FragNetPreTrainMasked2(mask_seed=seed, **kw)
    if mv != "gat2":
        raise ValueError(f"unknown pretrain.model_version {mv!r} "
                         f"(gat2|gat2_masked|gat2_masked2)")
    return FragNetPreTrain(**kw)


def _packed_transport(device: torch.device) -> bool:
    """Whether an uncached train set runs from packed buffers: on CUDA, the
    device the plane builder serves (the JAX package's TPU gate)."""
    return device.type == "cuda"


def run_pretrain(opt, quiet: bool = False,
                 device: Union[str, torch.device, None] = None,
                 graphs: Optional[list] = None):
    """The geometric pretraining run (the JAX package's run_pretrain,
    fragnet_tpu/train/pretrain.py:309-513): the model from ``seed``, an
    optional resume from ``pretrain.saved_checkpoint``, ``n_epochs`` epochs
    of the 4-target loss with validation every ``val_every`` epochs,
    early stopping saving ``exp_dir/<chkpoint_name>`` on each improvement,
    ``scalars.jsonl`` (train loss and message-edges/s per epoch, val loss)
    and, with ``pretrain.profile``, a trace of epoch 1. ``graphs`` replaces
    ``load_pretrain_graphs(opt)``. ``pretrain.dtype`` (f32 or bf16) is the
    encoder's compute type; in bf16 the packed transport carries the bond
    attributes in bf16, as the JAX package's does. Runs on CUDA unless
    ``device="cpu"``. Returns (best score, checkpoint path)."""
    from fragnet_tpu_torch.data.batcher import (BatchLoader, DeviceCacheLoader,
                                                DevicePackedCacheLoader,
                                                PackedCacheLoader)
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.obs import ScalarLogger, profile_trace
    from fragnet_tpu_torch.train import fastpath
    from fragnet_tpu_torch.train.checkpoint import load_params, save_params
    from fragnet_tpu_torch.train.earlystop import EarlyStopping
    from fragnet_tpu_torch.train.finetune import seed_everything
    from fragnet_tpu_torch.train.optim import make_optimizer

    pt = opt.pretrain
    if pt.get("mode", "geometric") in ("property", "structure"):
        return run_aux_pretrain(opt, quiet=quiet, device=device)
    model_version = pt.get("model_version", "gat2")
    fp = fastpath.resolve(pt, model_version=model_version, device=device)
    fastpath.reduce_bf16_gemms_in_f32(fp)
    seed = int(opt.get("seed", 42))
    seed_everything(seed)
    exp_dir = opt.get("exp_dir", "exps/pt")
    os.makedirs(exp_dir, exist_ok=True)

    if graphs is None:
        graphs = load_pretrain_graphs(opt)
    if not quiet:
        print(f"pretrain graphs: {len(graphs)}")
    train_g, val_g = split_graphs(graphs, seed)

    bs = int(pt.get("batch_size", 32))
    spec = spec_for(graphs, batch_size=bs, tcsr=fp.tcsr)
    train_loader = BatchLoader(train_g, bs, spec=spec, shuffle=True, seed=seed,
                               with_targets=True)
    val_loader = BatchLoader(val_g, bs, spec=spec, with_targets=True)
    train_loader = fastpath.maybe_cache(train_loader, fp.device, spec=spec,
                                        policy=fp.cache, seed=seed)
    val_loader = fastpath.maybe_cache(val_loader, fp.device, spec=spec,
                                      policy=fp.cache, seed=seed + 1)
    if not quiet:
        print(f"fastpath: tcsr={fp.tcsr} dtype={fp.dtype_name} "
              f"cache={fp.cache} device={fp.device}")

    model = build_pretrain_model(opt, policy=fp.kernel,
                                 generator=torch.Generator().manual_seed(seed),
                                 dtype=fp.dtype)
    # the JAX package draws an init batch here (model.init), which advances
    # the train loader's shuffle state; drawing it too keeps both packages
    # on the same batches from the same seed
    next(iter(train_loader))

    # resume (pretrain_gat2.py:130-131)
    if pt.get("saved_checkpoint", None) and os.path.exists(pt.saved_checkpoint):
        load_params(model, pt.saved_checkpoint)
        if not quiet:
            print(f"resumed from {pt.saved_checkpoint}")
    model = model.to(fp.device)

    optimizer, _ = make_optimizer(model.parameters(),
                                  pt.get("optimizer", "adam"),
                                  lr=float(pt.get("lr", 1e-4)))
    n_epochs = int(pt.get("n_epochs", 100))
    val_every = int(pt.get("val_every", 5))
    compat = bool(pt.get("compat_loss_overwrite", False))

    # packed transport: when the padded set is not cached on the device and
    # the run is on CUDA, train from packed single-buffer batches — cached
    # on the device, else in host memory, else packed every epoch by
    # spawned workers that overlap the device's work
    packed_stream = None
    if (not isinstance(train_loader, DeviceCacheLoader) and fp.tcsr
            and _packed_transport(fp.device)
            and pt.get("stream", "auto") != "off"):
        ploader = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                              seed=seed, with_targets=True, pack=True,
                              compute_dtype=fp.dtype_name)
        next(iter(ploader))  # build the pack layout in-parent
        ploader._epoch = 0   # the layout probe advanced the shuffle state
        trainer = PretrainTrainer(model, optimizer, compat,
                                  layout=ploader.layout, device=fp.device)
        n_workers = int(pt.get("stream_workers", 0)) or \
            max(2, min(4, os.cpu_count() or 2))
        hbm_gb = float(pt.get("hbm_cache_gb", 6.0))
        cache_gb = float(pt.get("host_cache_gb", 8.0))
        mb = ploader.layout.total_bytes / 1e6
        try:
            try:
                pcache = DevicePackedCacheLoader(
                    ploader, seed=seed + 7, workers=n_workers,
                    max_bytes=int(hbm_gb * (1 << 30)), device=fp.device)
                tier = "HBM"
            except MemoryError:
                pcache = PackedCacheLoader(
                    ploader, seed=seed + 7, workers=n_workers,
                    max_bytes=int(cache_gb * (1 << 30)))
                tier = "host"
            epoch_counts = [len(pcache)] * n_epochs
            packed_stream = pcache.stream(n_epochs)
            if not quiet:
                print(f"packed {tier} cache active ({mb:.1f} MB/batch x "
                      f"{len(pcache)} batches, {n_workers} pack workers)")
        except MemoryError:
            # exact per-epoch batch counts: greedy windowing varies with the
            # per-epoch shuffle, so walk the (cheap, pad-free) window
            # sequence once with a shuffle-state twin — keeps epoch
            # boundaries, and therefore reported train losses, exact
            sim = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                              seed=seed, with_targets=True)
            epoch_counts = [sum(1 for _ in sim._windows())
                            for _ in range(n_epochs)]
            packed_stream = ploader.stream(n_epochs, depth=4, process=True,
                                           workers=n_workers)
            if not quiet:
                print(f"packed process stream active ({mb:.1f} MB/batch, "
                      f"{epoch_counts[0]} batches/epoch, {n_workers} pack "
                      f"workers)")
    else:
        trainer = PretrainTrainer(model, optimizer, compat, device=fp.device)

    ckpt = os.path.join(exp_dir, pt.get("chkpoint_name", "pt.ckpt"))
    es = EarlyStopping(patience=int(pt.get("es_patience", 200)), path=ckpt,
                       save_fn=save_params)
    profile_dir = (os.path.join(exp_dir, "profile")
                   if pt.get("profile", False) else None)
    epoch_edges = fastpath.epoch_message_edges(
        train_g, num_layer=int(pt.get("model", {}).get("num_layer", 4)))
    t0 = time.time()
    try:
        with ScalarLogger(exp_dir) as logger:
            for epoch in range(n_epochs):
                te0 = time.perf_counter()
                with profile_trace(profile_dir if epoch == 1 else None):
                    if packed_stream is not None:
                        losses = []
                        for _ in range(epoch_counts[epoch]):
                            b = next(packed_stream, None)
                            if b is None:
                                break
                            losses.append(trainer._step(b))
                        train_loss = _mean(losses)
                    else:
                        train_loss = trainer.train_epoch(train_loader)
                edges_per_sec = epoch_edges / max(time.perf_counter() - te0,
                                                  1e-9)
                logger.log("train/loss", train_loss, epoch)
                logger.log("train/edges_per_sec", edges_per_sec, epoch)
                if epoch % val_every == 0 or epoch == n_epochs - 1:
                    val_loss = trainer.validate(val_loader)
                    es(val_loss, model)
                    logger.log("val/loss", val_loss, epoch)
                    if not quiet:
                        print(f"epoch {epoch:4d} train {train_loss:.5f} val "
                              f"{val_loss:.5f} {edges_per_sec / 1e6:.2f}M "
                              f"edges/s [{time.time() - t0:.1f}s]")
                    if es.early_stop:
                        break
    finally:
        if packed_stream is not None:
            packed_stream.close()  # stops the pack workers of a stream
    return es.best_score, ckpt


def main(argv=None):
    import ast

    from fragnet_tpu_torch.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = ap.parse_args(argv)
    opt = load_config(args.config)
    for ov in args.overrides:
        k, v = ov.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        opt.set_path(k, v)
    run_pretrain(opt, device=args.device)


if __name__ == "__main__":
    main()
