"""Finetune entry point of the port — counterpart of
fragnet_tpu/train/finetune.py (the analog of
fragnet/train/finetune/finetune_gat2.py).

Usage:
    python -m fragnet_tpu_torch.train.finetune --config configs/ft/esol.yaml \
        [k=v ...] [--device cuda|cpu]

    torchrun --nproc_per_node=2 -m fragnet_tpu_torch.train.finetune \
        --config configs/ft/esol.yaml dist.mode=ep [k=v ...]

The finetune: SMILES → graphs → tile-aligned padded batches with TCSR
metadata and dense planes → the config's ``model_version`` (gat2's
FragNetFineTune; gat2_transformer, gat2_transformer2, gat2_multitask on
the same encoder; the variants gat2_lite, gat2_edge, gcn2; the ablations
gat, gcn, gcn3) → masked loss → backward
through the GAT kernels → Adam, with validation, early stopping and a
checkpoint every epoch, then the test metric on the best parameters and
``preds_seed_{seed}.pkl``. ``finetune.n_epochs=0`` runs the prediction path
alone. ``dist.mode=dp`` trains data-parallel and ``dist.mode=ep``
edge-partitioned over ``dist.n_devices`` ranks (started by ``torchrun`` or
by the entry point itself). Any option the port does not run yet raises
instead of being ignored (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
import time
from typing import Optional, Union

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """(reference finetune_gat2.py:17-26)"""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


# the model_versions of the JAX package's build_model: gat2 and the models
# on its encoder (model/finetune.py, model/transformer.py), the variants
# (model/variants.py) and the ablations (model/ablations.py)
MODEL_VERSIONS = ("gat2", "gat2_transformer", "gat2_transformer2",
                  "gat2_multitask", "gat2_lite", "gat2_edge", "gcn2", "gat",
                  "gcn", "gcn3")


def _model_version(opt, ep=False) -> str:
    """The config's model_version, checked: an unknown one raises
    ValueError, and so does edge-partitioned training of a family other
    than gat2, as in the JAX package."""
    mv = opt.get("model_version", "gat2")
    if mv not in MODEL_VERSIONS:
        raise ValueError(f"unknown model_version {mv!r}")
    if ep and mv != "gat2":
        raise ValueError("edge-partitioned training currently supports "
                         "model_version=gat2")
    return mv


def model_kwargs(opt, n_classes: int) -> dict:
    """FragNetFineTune's arguments (the gat2 model) from the config's
    finetune.model; build_model takes the other families' from them (the
    variants take them all)."""
    _model_version(opt)
    m = opt.finetune.model
    return dict(
        n_classes=n_classes,
        atom_features=opt.get("atom_features", 167),
        frag_features=opt.get("frag_features", 167),
        edge_features=opt.get("edge_features", 17),
        fedge_in=opt.get("fedge_in", 6),
        fbond_edge_in=opt.get("fbond_edge_in", 6),
        num_layer=m.get("num_layer", 4),
        num_heads=m.get("num_heads", 4),
        drop_ratio=m.get("drop_ratio", 0.15),
        emb_dim=m.get("emb_dim", 128),
        h1=m.get("h1", 256), h2=m.get("h2", 256),
        h3=m.get("h3", 256), h4=m.get("h4", 256),
        act=m.get("act", "relu"),
        fthead=m.get("fthead", "FTHead3"),
    )


def build_model(opt, n_classes: int, policy=None,
                generator: Optional[torch.Generator] = None, ep=None,
                dtype: Optional[torch.dtype] = None):
    """The config's model_version (the JAX package's build_model,
    fragnet_tpu/train/finetune.py:52-155) with its defaults there; gat2
    edge-partitioned with ``ep`` (an EPContext). The ablations (gat, gcn,
    gcn3) take no num_heads, fthead or kernel policy: v1's bond pass runs
    on the TCSR kernel whatever ``kernel.bond`` says. ``dtype`` (the
    compute type) reaches only the families that take one
    (fastpath.supports_dtype, as the JAX package's :77-79); the others are
    built in f32."""
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.train.fastpath import supports_dtype

    mv = _model_version(opt, ep=ep is not None)
    kw = model_kwargs(opt, n_classes)
    common = dict(policy=policy or KernelPolicy(), generator=generator)
    dkw = {"dtype": dtype} if dtype is not None and supports_dtype(mv) \
        else {}
    if mv == "gat2":
        from fragnet_tpu_torch.model.finetune import FragNetFineTune

        return FragNetFineTune(**kw, **common, ep=ep, **dkw)
    if mv in ("gat2_lite", "gat2_edge", "gcn2"):
        from fragnet_tpu_torch.model import variants

        cls = {"gat2_lite": variants.FragNetFineTuneLite,
               "gat2_edge": variants.FragNetFineTuneEdge,
               "gcn2": variants.FragNetFineTuneGCN}[mv]
        return cls(**kw, **common)
    if mv in ("gat", "gcn", "gcn3"):
        from fragnet_tpu_torch.model.ablations import _AblationFineTune

        return _AblationFineTune(
            kind=mv, n_classes=n_classes, num_layer=kw["num_layer"],
            drop_ratio=kw["drop_ratio"], emb_dim=kw["emb_dim"],
            atom_features=kw["atom_features"],
            edge_features=kw["edge_features"], generator=generator)
    from fragnet_tpu_torch.model import transformer

    m = opt.finetune.model
    enc = {k: kw[k] for k in ("num_layer", "num_heads", "drop_ratio",
                              "emb_dim", "atom_features", "frag_features",
                              "edge_features", "fedge_in", "fbond_edge_in")}
    if mv == "gat2_transformer":
        return transformer.FragNetFineTuneTransformer(
            n_classes=n_classes, h1=kw["h1"],
            transformer_heads=m.get("transformer_heads", 1), **enc, **common,
            **dkw)
    if mv == "gat2_transformer2":
        return transformer.FragNetFineTuneTransformer2(
            n_classes=n_classes, h1=kw["h1"],
            num_attn_layer2=m.get("num_attn_layer2", 6),
            num_attn_heads2=m.get("num_attn_heads2", 4),
            drop_ratio2=m.get("drop_ratio2", 0.3),
            max_seq_len=m.get("max_seq_len", 64), **enc, **common, **dkw)
    # gat2_multitask: one scalar head per task, flattened to (G, n_tasks)
    # for the masked multi-task losses
    return transformer.FragNetFineTuneMultiTask(
        n_classes=1, n_multi_task_heads=m.get("n_multi_task_heads",
                                              n_classes),
        **enc, **common, **dkw)


def load_datasets(opt):
    """Returns (train_graphs, val_graphs, test_graphs, n_tasks, task)."""
    from fragnet_tpu_torch.data.datasets import (build_graphs,
                                                 load_pickle_dataset)
    from fragnet_tpu_torch.data.moleculenet import (load_moleculenet,
                                                    target_columns)
    from fragnet_tpu_torch.data.splitters import (random_scaffold_split,
                                                  random_split,
                                                  scaffold_split)

    ft = opt.finetune
    data = ft.get("data", None)

    # pre-featurized pickles (reference train/val/test.path flow)
    if ft.get("train", None) and ft.train.get("path", None):
        return (
            load_pickle_dataset(ft.train.path),
            load_pickle_dataset(ft.val.path),
            load_pickle_dataset(ft.test.path),
            int(ft.get("n_classes", 1)),
            ft.get("target_type", "regr"),
        )

    seed = int(opt.get("seed", 42))
    df = load_moleculenet(
        data.get("name", "esol"),
        data_dir=data.get("path", None),
        n_synthetic=int(data.get("n_synthetic", 512)),
        seed=seed,
    )
    tcols = target_columns(df)
    smiles = list(df["smiles"])
    split = data.get("split", "scaffold")
    if split == "scaffold":
        tr, va, te = scaffold_split(smiles)
    elif split == "random":
        tr, va, te = random_split(len(smiles), seed=seed)
    else:
        tr, va, te = random_scaffold_split(smiles, seed=seed)

    target_vals = np.stack([np.asarray(df[c], np.float64) for c in tcols],
                           axis=1)
    frag_type = data.get("frag_type", "brics")

    def make(idx):
        return build_graphs([smiles[i] for i in idx],
                            [target_vals[i] for i in idx],
                            frag_type=frag_type)

    task = ft.get("target_type", "regr")
    return make(tr), make(va), make(te), len(tcols), task


def _dist_mode(opt) -> str:
    dist = opt.get("dist", None)
    mode = str(dist.get("mode", "none")) if dist else "none"
    if mode not in ("none", "dp", "ep"):
        raise ValueError(f"dist.mode={mode!r} (none|dp|ep)")
    return mode


class _Silent:
    """The scalar logger of a rank other than 0: logs nothing."""

    def log(self, *args) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def run_finetune(opt, quiet: bool = False, datasets=None,
                 device: Union[str, torch.device, None] = None,
                 rank_reports: Optional[list] = None):
    """The finetune run (the JAX package's run_finetune,
    fragnet_tpu/train/finetune.py:210-484):
    build the model from ``seed``, load the encoder
    from a pretrain checkpoint when ``pretrain.use`` and ``pretrain.chk``
    are set, train ``finetune.n_epochs`` epochs with Adam, validate,
    early-stop and save ``exp_dir/ft.ckpt`` on each improvement, log
    ``scalars.jsonl``, then test the best parameters, print ``test rmse``
    (or ``roc_auc``) and write ``preds_seed_{seed}.pkl``. Runs on CUDA
    unless ``device="cpu"``. Returns (metric value, model holding the best
    parameters).

    ``dist.mode``: ``none`` runs on one device, caching the loaders on it as
    ``finetune.cache`` says (``fastpath.maybe_cache``), with one PadSpec
    per size bucket when ``finetune.n_buckets`` > 1
    (``BucketedBatchLoader``); ``dp`` (data
    parallel) and ``ep`` (edge-partitioned: the K3 kernels, or the
    segment mode under ``dist.tcsr=false`` or when the K3 pins fail, which
    prints ``ep fused kernel off: <reason>`` as the JAX package does) run
    ``dist.n_devices`` ranks of a process group. Inside a group (torchrun's
    RANK environment, or one the caller joined) this process runs its rank;
    otherwise it starts the ranks itself (dist/launch.py; one in this
    process, more spawned), returns rank 0's result, and appends each
    rank's report (value, losses, backend, kernel launches) to
    ``rank_reports`` when given. Rank 0 alone prints and writes files.
    ``dist.multihost`` (the JAX package's multi-process bring-up) needs no
    step of its own: processes started by torchrun on one host or many,
    on the card or on the CPU (gloo), each join the group from RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT; without them the run starts
    its ranks itself, as the JAX package's initialize is a no-op there."""
    import torch.distributed as tdist

    mode = _dist_mode(opt)
    _model_version(opt, ep=mode == "ep")
    if mode == "none":
        return _run(opt, quiet, datasets, device, None)[:2]
    if not tdist.is_initialized() and "RANK" not in os.environ:
        return _launch(opt, quiet, datasets, device, rank_reports)
    from fragnet_tpu_torch.dist.data_parallel import initialize_distributed

    dist = opt.dist
    info = initialize_distributed(
        device=device or "cuda",
        timeout_s=float(dist.get("timeout_s", 300)))
    return _run(opt, quiet, datasets, device, info)[:2]


def _n_ranks(opt, device) -> int:
    n = int(opt.dist.get("n_devices", 0))
    if n:
        return n
    return torch.cuda.device_count() if str(device) != "cpu" else 1


def _launch(opt, quiet, datasets, device, rank_reports):
    """Start the run's ranks (dist/launch.py) and return rank 0's (value,
    model), the model rebuilt here from rank 0's best parameters."""
    from fragnet_tpu_torch.dist.data_parallel import backend_for
    from fragnet_tpu_torch.dist.launch import run_ranks
    from fragnet_tpu_torch.train.fastpath import (resolve_device,
                                                  resolve_dtype,
                                                  resolve_kernel_policy)

    dev = resolve_device(device)
    n = _n_ranks(opt, dev)
    if datasets is None:
        datasets = load_datasets(opt)  # once, not in every rank
    if not quiet:
        print(f"dist: mode={opt.dist.mode} ranks={n} "
              f"backend={backend_for(n, dev.type)} device={dev.type}")
    exp_dir = opt.get("exp_dir", "exps/tmp")
    results = run_ranks(
        _finetune_rank, n, (opt.to_dict(), quiet, datasets, dev.type),
        device=dev, timeout_s=float(opt.dist.get("timeout_s", 300)),
        join_timeout_s=float(opt.dist.get("join_timeout_s", 3600)),
        workdir=exp_dir)
    if rank_reports is not None:
        rank_reports.extend({k: v for k, v in r.items() if k != "state_dict"}
                            for r in results)
    model = build_model(opt, n_classes=datasets[3],
                        policy=resolve_kernel_policy(opt.finetune),
                        dtype=resolve_dtype(opt.finetune))
    model.load_state_dict(results[0]["state_dict"])
    return results[0]["value"], model.to(dev)


def _finetune_rank(opt_dict, quiet, datasets, device):
    """One rank of a launched run: run_finetune inside the group; returns
    its report (rank 0's carries the best parameters, on the CPU)."""
    from fragnet_tpu_torch.config import Config
    from fragnet_tpu_torch.dist.data_parallel import initialize_distributed
    from fragnet_tpu_torch.ops import _cuda

    opt = Config(opt_dict)
    info = initialize_distributed(device=device)
    before = _cuda.launch_counts()
    value, model, history = _run(opt, quiet, datasets, device, info)
    after = _cuda.launch_counts()
    return {"rank": info.rank, "backend": info.backend,
            "device": str(info.device), "value": value, **history,
            "launches": {k: n - before.get(k, 0) for k, n in after.items()},
            "state_dict": ({k: v.detach().cpu()
                            for k, v in model.state_dict().items()}
                           if info.rank == 0 else None)}


def _run(opt, quiet, datasets, device, info):
    """The run on one device (``info`` None) or as one rank of a group
    (``info``: dist/data_parallel.py:DistInfo). Returns (value, model,
    history of the train losses and val scores)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.obs import ScalarLogger, profile_trace
    from fragnet_tpu_torch.train import fastpath
    from fragnet_tpu_torch.train.checkpoint import (
        save_params, transfer_pretrained_encoder)
    from fragnet_tpu_torch.train.earlystop import EarlyStopping
    from fragnet_tpu_torch.train.loop import TrainerFineTune
    from fragnet_tpu_torch.train.optim import make_optimizer, make_schedule

    ft = opt.finetune
    mode = "none" if info is None else _dist_mode(opt)
    rank, S = (0, 1) if info is None else (info.rank, info.world_size)
    lead = rank == 0
    say = lead and not quiet
    fp = fastpath.resolve(ft, model_version=opt.get("model_version", "gat2"),
                          device=device if info is None else info.device,
                          dist_mode=mode)
    seed = int(opt.get("seed", 42))
    seed_everything(seed)
    exp_dir = opt.get("exp_dir", "exps/tmp")
    if lead:
        os.makedirs(exp_dir, exist_ok=True)

    train_g, val_g, test_g, n_tasks, task = (
        datasets if datasets is not None else load_datasets(opt))
    if say:
        print(f"datasets: train={len(train_g)} val={len(val_g)} "
              f"test={len(test_g)} tasks={n_tasks} type={task}")
        print(f"fastpath: tcsr={fp.tcsr} dtype={fp.dtype_name} "
              f"cache={fp.cache} device={fp.device}")
    fastpath.reduce_bf16_gemms_in_f32(fp)

    bs = int(ft.get("batch_size", 16))
    ep = None
    if mode == "ep":
        from fragnet_tpu_torch.dist.edge_partition import EPContext

        # the fused mode (K3) unless dist.tcsr (or finetune.tcsr, the JAX
        # package's key) is false: the segment mode then. The K3 kernels
        # need node counts % tn and edge counts % (S·te): dist.tile sets
        # both, dist.tile_tn / dist.tile_te each (on CUDA the single-device
        # kernels' tiles, 8 on the CPU as in the JAX package off the TPU);
        # the segment mode pads to 8·S
        ep_tcsr = bool(opt.dist.get("tcsr", fp.tcsr))
        cuda = fp.device.type == "cuda"
        ep_tn = int(opt.dist.get("tile_tn",
                                 opt.dist.get("tile", 128 if cuda else 8)))
        ep_te = int(opt.dist.get("tile_te",
                                 opt.dist.get("tile", 256 if cuda else 8)))
        spec = spec_for(train_g + val_g + test_g, batch_size=bs,
                        multiple=max(ep_tn, ep_te) * S if ep_tcsr else 8 * S)
        ep = EPContext(rank, S)
        if say and not ep_tcsr:
            print("ep fused kernel off: dist.tcsr=false")
    else:
        spec = spec_for(train_g + val_g + test_g, batch_size=bs,
                        tcsr=fp.tcsr)
    model = build_model(opt, n_classes=n_tasks, policy=fp.kernel,
                        generator=torch.Generator().manual_seed(seed), ep=ep,
                        dtype=fp.dtype)
    model = model.to(fp.device)

    n_buckets = int(ft.get("n_buckets", 1))
    if mode == "dp":
        # this rank's micro-batch of every window of bs × S graphs
        from fragnet_tpu_torch.dist.data_parallel import DPBatchLoader

        train_loader = DPBatchLoader(train_g, bs, S, spec, rank=rank,
                                     shuffle=True, seed=seed,
                                     n_tasks=n_tasks)
        val_loader = DPBatchLoader(val_g, bs, S, spec, rank=rank,
                                   n_tasks=n_tasks, on_oversize="error")
        test_loader = DPBatchLoader(test_g, bs, S, spec, rank=rank,
                                    n_tasks=n_tasks, on_oversize="error")
    elif n_buckets > 1 and mode == "none":
        # size-bucketed padding (SURVEY §7 step 7): one PadSpec per size
        # quantile instead of one p95 spec for everything
        from fragnet_tpu_torch.data.batcher import BucketedBatchLoader

        kw = dict(n_buckets=n_buckets, n_tasks=n_tasks,
                  spec_kwargs={"tcsr": fp.tcsr})
        train_loader = BucketedBatchLoader(train_g, bs, shuffle=True,
                                           seed=seed, **kw)
        val_loader = BucketedBatchLoader(val_g, bs, on_oversize="error", **kw)
        test_loader = BucketedBatchLoader(test_g, bs, on_oversize="error",
                                          **kw)
    else:
        train_loader = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                                   seed=seed, n_tasks=n_tasks)
        # eval loaders hard-fail on oversized molecules instead of silently
        # shrinking the reported metric's denominator
        val_loader = BatchLoader(val_g, bs, spec=spec, n_tasks=n_tasks,
                                 on_oversize="error")
        test_loader = BatchLoader(test_g, bs, spec=spec, n_tasks=n_tasks,
                                  on_oversize="error")
    if mode == "ep" and ep_tcsr:
        # ONE set of pinned widths across train/val/test (the JAX package's
        # single compiled EP step); a probe failure prints its reason and
        # keeps the plain loaders: the segment mode, as in the JAX package
        from fragnet_tpu_torch.dist.edge_partition import (EPMetaLoader,
                                                           pin_ep_widths)

        try:
            pins = pin_ep_widths([train_loader, val_loader, test_loader], S,
                                 tn=ep_tn, te=ep_te)
            train_loader, val_loader, test_loader = (
                EPMetaLoader(ld, S, tn=ep_tn, te=ep_te, pins=pins)
                for ld in (train_loader, val_loader, test_loader))
            if say:
                print(f"ep fused kernel active (tn={ep_tn} te={ep_te})")
        except ValueError as e:
            if say:
                print(f"ep fused kernel off: {e}")
    if mode == "none":
        # device-resident caching: after the first pass the input pipeline
        # costs nothing (DeviceCacheLoader; reshuffles batch ORDER per
        # epoch). A bucketed loader has no single spec: the budget is
        # checked against the global one, as in the JAX package
        train_loader, val_loader, test_loader = (
            fastpath.maybe_cache(ld, fp.device,
                                 spec=getattr(ld, "spec", spec),
                                 n_tasks=n_tasks, policy=fp.cache,
                                 seed=seed + i)
            for i, ld in enumerate((train_loader, val_loader, test_loader)))
    # the JAX package draws an init batch here (model.init), which advances
    # the train loader's shuffle state; drawing it too keeps both packages
    # on the same batches from the same seed
    next(iter(train_loader))

    # pretrained encoder transfer (finetune_gat2.py:213-230)
    pt = opt.get("pretrain", None)
    if pt and pt.get("use", False) and pt.get("chk", None):
        transfer_pretrained_encoder(
            model, torch.load(pt.chk, map_location="cpu", weights_only=True))
        if say:
            print(f"loaded pretrained encoder from {pt.chk}")

    n_epochs = int(ft.get("n_epochs", 100))
    lr = float(ft.get("lr", 1e-4))
    sched = None
    if ft.get("use_schedular", False):
        sched = make_schedule("linear", lr,
                              total_steps=n_epochs * max(1, len(train_loader)))
    optimizer, scheduler = make_optimizer(model.parameters(), "adam", lr=lr,
                                          schedule=sched)
    loss_name = "mse" if task == "regr" else "bce"
    steps = {}
    if mode == "ep":
        from fragnet_tpu_torch.dist.edge_partition import (make_ep_eval_step,
                                                           make_ep_train_step)

        steps = dict(
            train_step=make_ep_train_step(model, optimizer, ep, loss_name,
                                          fp.device, scheduler,
                                          seed=seed + 1),
            eval_step=make_ep_eval_step(model, ep, loss_name, fp.device))
    elif mode == "dp":
        from fragnet_tpu_torch.dist.data_parallel import (gather_numpy,
                                                          make_dp_eval_step,
                                                          make_dp_train_step)

        torch.manual_seed(seed + 1 + rank)  # each rank its own dropout masks
        steps = dict(
            train_step=make_dp_train_step(model, optimizer, loss_name,
                                          fp.device, scheduler=scheduler),
            eval_step=make_dp_eval_step(model, loss_name, fp.device),
            gather=gather_numpy)
    elif ft.get("standardize", False) and task == "regr":
        # target standardization (reference finetune_norm.py:28-43): the
        # train graphs' per-task mean and population std; the loss on
        # standardized labels, validation and test in raw label space.
        # Under dist.mode=dp|ep the option has no effect, as in the JAX
        # package
        from fragnet_tpu_torch.train.tasks import make_standardized_ft_steps

        ys = np.stack([np.asarray(g.y, np.float32).reshape(-1)[:n_tasks]
                       for g in train_g])
        y_mean, y_sdev = ys.mean(axis=0), ys.std(axis=0)
        tr_step, ev_step = make_standardized_ft_steps(
            model, optimizer, y_mean, y_sdev, fp.device, scheduler)
        steps = dict(train_step=tr_step, eval_step=ev_step)
        if say:
            print(f"standardized targets: mean={y_mean} sdev={y_sdev}")
    if say and mode != "none":
        print(f"{'edge-partitioned' if mode == 'ep' else 'data-parallel'} "
              f"training over {S} ranks")
    trainer = TrainerFineTune(model, optimizer, target_type=task,
                              device=fp.device, scheduler=scheduler, **steps)
    ckpt_path = os.path.join(exp_dir, ft.get("chkpoint_name", "ft.ckpt"))
    es = EarlyStopping(patience=int(ft.get("es_patience", 100)),
                       path=ckpt_path if lead else None, save_fn=save_params)
    profile_dir = (os.path.join(exp_dir, "profile")
                   if ft.get("profile", False) and lead else None)
    # throughput: real message edges over all 4 levels × layers (the
    # bench.py metric), logged per epoch
    epoch_edges = fastpath.epoch_message_edges(
        train_g, num_layer=int(ft.model.get("num_layer", 4)))

    metric = "rmse" if task == "regr" else "roc_auc"
    history = {"train_loss": [], "val_score": []}
    with (ScalarLogger(exp_dir) if lead else _Silent()) as logger:
        t0 = time.time()
        for epoch in range(n_epochs):
            te0 = time.perf_counter()
            with profile_trace(profile_dir if epoch == 1 else None):
                train_loss = trainer.train_epoch(train_loader)
            edges_per_sec = epoch_edges / max(time.perf_counter() - te0, 1e-9)
            val_score = trainer.validate(val_loader)
            es(val_score, model)
            history["train_loss"].append(train_loss)
            history["val_score"].append(val_score)
            logger.log("train/loss", train_loss, epoch)
            logger.log("train/edges_per_sec", edges_per_sec, epoch)
            logger.log("val/score", val_score, epoch)
            if say and (epoch % 10 == 0 or epoch == n_epochs - 1):
                print(f"epoch {epoch:4d} train_loss {train_loss:.5f} "
                      f"val {val_score:.5f} best {-(es.best_score or 0):.5f} "
                      f"{edges_per_sec / 1e6:.2f}M edges/s "
                      f"[{time.time() - t0:.1f}s]")
            if es.early_stop:
                if say:
                    print(f"early stop at epoch {epoch}")
                break

        if es.best_params is not None:
            model.load_state_dict(es.best_params)
        score, y, p = trainer.test(test_loader)
        value = float(np.sqrt(score)) if task == "regr" else -score
        logger.log(f"test/{metric}", value, n_epochs)
    if say:
        print(f"test {metric}: {value:.5f}")
    if lead:
        with open(os.path.join(exp_dir, f"preds_seed_{seed}.pkl"), "wb") as f:
            pickle.dump({"y": y, "pred": p, metric: value}, f)
    return value, model, history


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
    run_finetune(opt, device=args.device)
    import torch.distributed as tdist

    if tdist.is_initialized():  # a torchrun rank
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
