#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card and holds every kernel of them
against its plain PyTorch version: the gat2 ESOL recipe
(configs/ft/esol.yaml, full width: 4 layers, emb 128, 4 heads, FTHead3
128/1024/1024/512, batch 16, f32, Adam lr 1e-4) on synthetic molecules
through ``run_finetune`` — first the prediction path
(``finetune.n_epochs=0``), then training (``finetune.n_epochs=3``), then
data-parallel and edge-partitioned training on torch.distributed (two
ranks sharing the card over gloo, and one rank over NCCL) — and geometric
pretraining (configs/pt/unimol.yaml, full width: 4 layers, emb
128, 4 heads, drop 0.2, Adam lr 1e-4, f32) through ``run_pretrain`` and
the packed transport — the interpreter (``FragNetInterpreter``:
attention weights and masking contributions) on the finetuned model,
the other models on the gat2 encoder (gat2_transformer,
gat2_transformer2, gat2_multitask) and the variants and ablations
(gat2_lite, gat2_edge, gcn2, gat, gcn, gcn3) through ``run_finetune``,
the DTA and CDRP tasks through ``run_task``, and the HP search, k-fold CV,
bucketed finetuning and auxiliary pretraining (``run_hp_search``,
``run_finetune_cv``, ``finetune.n_buckets``, ``pretrain.mode``), and the
esol recipe in bf16 (``finetune.dtype=bf16``: the bf16 forms of K1, K2,
K4, K5), the compact packing encodings, and the ELL neighbour-table path
(``spec_for(..., ell=True)``) with the native host runtime.
Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. featurize the esol-config dataset (host);
  4. each kernel against its plain version on the card, at every level it
     serves, with tensors captured from layer 0 of a real esol-config batch
     (the backward kernels get the forward kernel's out, m, den and a
     cotangent drawn with numpy from a fixed seed): max abs and relative
     diff of every output (limit 1e-4 of the output's scale; for a
     backward output at least max|s|, see _scale_floor), the kernel's
     and the plain version's ms (CUDA events around each wrapper call,
     median of 50 after warm-up — host dispatch included), their device
     time per call (torch.profiler's CUDA activity over 50 calls, the
     wrapper's output fills included) and the bytes/operations bound.
     The fconn level is checked a second time with seeded node features
     and edge attributes (seeded_fconn_call), each output against its own
     scale; the TCSR backward's level also times the torch ops that do the
     rest of the TPU kernel's work (k2_outside_fn);
  5. the prediction path: run_finetune on cuda with every launch count set
     to 0 just before it; each forward kernel must have launched layers ×
     batches × 2 times (two levels each per layer) and no backward kernel,
     which also shows no GAT pass took the segment path (that path raises
     on CUDA tensors); then a second pass over the test batches times
     padding, copy and forward, and the profiler gives one forward's device
     busy time and top ops;
  6. the whole forward on the CPU (plain versions) and on the card
     (kernels) with the same weights and batch: predictions within 1e-3 of
     their scale, finite, of shape (G, n_tasks);
  7. the training path: run_finetune on cuda for 3 epochs with every launch
     count set to 0 just before it; every epoch's train loss and the test
     RMSE must be finite, the dense backward kernel must have launched
     layers × 2 × train steps times and each forward kernel layers × 2 × (train
     steps + epochs × val batches + test batches), counted from the
     loaders' lengths — except the TCSR backward, which runs for the frag
     level of the last layer only, (layers + 1) × train steps (see the
     phase); prints each epoch's message-edges/s;
  8. one train step (Adam) timed on the host clock and traced by the
     profiler: device busy time and top ops;
  9. one train step's loss and gradients on the CPU (plain versions) and on
     the card (kernels), same carried weights and batch, dropout off: loss
     and every parameter's gradient within 1e-3 of its scale;
 10. the plane builder (K6) against its plain version, the host builder
     and the library call (zeros + accumulating index_put_), exactly, at
     every plane level — bond (R=1), fconn (R=6), atom and frag (R=0) — of
     one batch at the config's batch_size 512 (the 256 pretrain graphs, featurized in
     spawned processes beside phases 3-9, repeated to 512), timed as in
     phase 4, with the library call's time;
 11. the pretraining path: run_pretrain on cuda, uncached, 256 synthetic
     molecules at batch 64 (so that each epoch has >= 3 train steps), 3
     epochs validated every epoch; it must report the HBM packed tier, its
     train and val losses must be finite and each kernel's launches must
     equal the count derived from the loaders (pretrain_expect), the logit
     kernels' (csrc/gat_logits.cu) among them: the forward once a GAT
     pass, the backward and its d_vec sum once a pass whose backward runs
     (16 and 13 a train step at 4 layers; logit_expect);
 12. the process-stream tier (no packed cache fits) for one epoch: the
     spawned workers' batches drive the same counts;
 13. one pretrain train step at batch 512 from a packed buffer on the
     card: wall time, stages each ended by a synchronize (unpack without
     planes, K6 planes, forward + loss, backward, Adam), device busy time,
     top ops and K6's share; then the TCSR forward and backward (K1, K2:
     atom and frag) and the dense forward and backward (K4, K5: bond and
     fconn) against their plain versions at this step's layer-0 inputs,
     checked and timed as in phase 4 (their levels tagged "batch 512" in
     the kernels' line); then the logit kernels at the step's layer-0
     bond, atom, fconn and frag passes (check_logit_kernels): the forward
     against the f64 einsums, the backward and its d_vec sum against the
     backward written out from the formulas and against autograd of the
     einsums, for numpy cotangents, every output within one ulp of its
     type; each wrapper's and plain version's ms and device ms, and each
     kernel's bound from the bytes its rows need;
 14. one pretrain step's loss and gradients, card (packed buffer decoded
     there, K6 planes) vs CPU (host batch, host planes), same weights (the
     run's checkpoint), dropout off: within 1e-3 of each scale;
 15. run_finetune with pretrain.use on the run's checkpoint: every encoder
     tensor of the finetune model equals the checkpoint's;
 16. the dense-attr kernels (K7 forward, K8 backward with the emit K9
     computed in its launch) against their plain versions, as in phase 4, with tensors captured from layer
     0 of the esol batch under the dense-attr policy
     (``finetune.kernel.attr=true finetune.kernel.fc=attr``) at the atom
     (self-loops), fconn (the first tn rows of the R = 6 planes, a strided
     view) and frag levels, plus a seeded case per level (numpy wd, ws, nf
     and w_ea), and from layer 0 of the batch-512 pretraining batch of
     phase 13 under the same policy (K6 planes; levels tagged "batch
     512"); K8's d_wea is held to the plain emit of the plain backward's
     d_zpre planes (1e-4 of scale, exactly 0 on every edge the forward did
     not count) and K9's plain version and library call (one
     advanced-indexing gather on indices computed beforehand) are timed
     beside it;
 17. the finetune training path under the dense-attr policy: run_finetune
     on cuda for 3 epochs, every launch count set to 0 just before it;
     losses and test RMSE finite, each kernel's launches equal to the count
     derived from the loaders' batches and the planes each carries
     (expected_launches: K7 three passes per layer, K4 the bond pass, K8
     every atom and fconn pass and the last layer's frag pass, K1 and K2
     none when every batch has its planes; K9 has no launch of its own);
 18. one train step under the dense-attr policy: loss and every gradient,
     card (kernels) vs CPU (plain versions), within 1e-3 of each scale, and
     its wall time, device busy time and per-kernel device time beside the
     default policy's step of phase 8;
 19. the pretraining path under the dense-attr policy: run_pretrain on the
     HBM packed tier for one epoch, K6 once per train step for each plane
     level of the layout the policy reads (4 when dp_bond, dp_fc, dp_atom
     and dp_frag all pass dp_level_ok), K7 and K8 as derived; one train step
     at batch 512 timed and profiled as in phase 13; then one pretrain
     step's gradients, card (K6 planes) vs CPU (host planes), within 1e-3;
 20. K3 (the edge-partitioned forward and backward) against its plain
     versions, as in phase 4, on each of two shards' layer-0 inputs at the
     bond, atom, fconn and frag levels (captured in the ranks of phase 22's
     step from the smoke's first train batch under run_finetune's EP spec,
     tn 128, te 256), plus a seeded case per level (numpy wn, nf, w_ea);
     the backward gets the forward's max as m and numpy cotangents dU, dV
     (limit 1e-4 of each output's scale, at least max|dV|);
 21. the edge-partitioned finetune path: run_finetune with dist.mode=ep
     over 2 ranks spawned on the one card (gloo) for 3 epochs; in every
     rank the losses and test RMSE are finite and equal to the other's,
     and the launches equal the count derived from its loaders (ep_expect:
     K3's forward 4 × layers per forward, its backward 3 × layers + 1 per
     train step, nothing else); then, run in phase 22's ranks, the segment
     EP mode (ops/segment.py:gat_attention_pass with ``ep``, torch ops and
     all-reduces: the JAX package runs it in XLA, no Pallas kernel) for one
     epoch with dist.tcsr=false, and with tiles whose K3 pins fail (rank 0
     must print the JAX package's "ep fused kernel off: ..." and train):
     losses finite and equal across the ranks, no kernel launched;
 22. one EP train step on 2 ranks (carried weights, dropout off) against
     the single-device card step on the same batch (TCSR metadata, K1/K2):
     loss, prediction, the four attention vectors and every averaged
     gradient within 1e-3 of each scale; each rank's step wall time,
     device busy time, K3 device time and the collectives' host time
     beside phase 8's single-device step; the same for the segment mode's
     step on the batch without tile metadata, whose K3 launches must be 0
     (the fused step's > 0, neither launching any other kernel but the
     logit kernels, in both modes once a pass forward and once a pass's
     backward, with its d_vec sum);
 23. the data-parallel finetune path: dist.mode=dp over 2 ranks (gloo) for
     3 epochs, each rank run as run_finetune's launcher runs it, in the
     same start of the ranks as the DP step (one spawn fewer), as
     phase 21, each rank's K1, K2, K4, K5 launches derived
     from its micro-batches (dp_expect); one DP step's averaged gradients
     against the mean of the two micro-batches' single-device card
     gradients, within 1e-3;
 24. both modes for one epoch as one rank over NCCL (the backend checked),
     launch counts derived as in phases 21 and 23, and the segment EP mode
     (no launch);
 25. interpretability: FragNetInterpreter.interpret(s, with_contributions=
     True) of the esol model with phase 7's ft.ckpt, under the default and
     the dense-attr policy, for aspirin, benzene (one fragment, an unpaired
     self_cn connection) and [Na+].[Cl-].CCO (iso_cn3 connections): on the
     card and on the CPU (plain versions), the prediction, the four
     min-max-scaled attention-weight vectors and the four masking-
     contribution vectors within 1e-3 of each vector's scale (a
     contribution's scale is max(|prediction|, max|c|)); the K1, K4 and K7
     launches of the card's interprets equal expected_launches of the
     batches the interpreter runs (the one-molecule batch and one replica
     batch per attribution family, built again here); two entities of each
     family of aspirin against one-at-a-time masked forwards on the card
     within 1e-4 of scale; each molecule's interpret wall time and device
     busy time; then K1 and K4 (K7 under dense-attr) against their plain
     versions, as in phase 4, at layer 0 of aspirin's atom replica batch
     (levels tagged "interp");
 26. the models on the gat2 encoder: gat2_transformer (TransformerConv
     post-processing), gat2_transformer2 (a dense per-molecule
     TransformerEncoder on each level) on the esol config, and
     gat2_multitask with configs/ft/clintox.yaml's settings (2 tasks,
     clsf, batch 32) on phase 3's graphs with two seeded labels each, some
     missing: per model the prediction and one train step's loss and
     gradients, card vs CPU, within 1e-3 of each scale; run_finetune for 2
     epochs with every launch count set to 0 just before it, K1, K2, K4
     and K5 launches equal to finetune_expect's, losses finite; a timed
     train step; gat2_transformer also under the dense-attr policy (K7,
     K8 exact); then TransformerConv (atom, frag), one EncoderBlock and
     its MultiheadAttention (atom, frag) forward + backward alone on the
     card, as torch ops: device ms, kernels launched, bound;
 27. the DTA and CDRP tasks (train/tasks.py) at the model defaults (the
     drug encoder at the esol width; the 8-layer, 8-head, 128-wide protein
     transformer over 1000 positions; the 903-gene MLP) on run_task's
     synthetic sets (96 pairs each, batch 16; featurized in phase 3's
     spawned processes behind the pretraining set): per model (DTA with
     the transformer and with the CNN, CDRP, DTA under the dense-attr
     policy) the prediction and one standardized train step's loss and
     gradients, card vs CPU, same seeded weights, on a train batch with
     padding graphs (every value finite, padding rows included), within
     1e-3 of each scale; K1 and K4 against their plain versions at layer 0
     of the DTA batch (levels tagged "dta"); run_task for 2 epochs (the
     dense-attr one 1) with every launch count set to 0 just before it,
     the launches equal to finetune_expect's for run_task's loaders, the
     test RMSE finite; a timed DTA and CDRP train step with the peak of
     allocated memory; run_finetune with finetune.standardize=true on the
     esol config for 2 epochs, launches exact, the test predictions the
     model's output in raw label space; then the protein transformer and
     the CNN forward + backward alone on the card, as torch ops: device ms,
     kernels launched, bound;
 28. the model variants and ablations (model/variants.py, model/
     ablations.py) on the esol config: gat2_lite, gat2_edge, gcn2, v1 gat
     (its fixed 3 heads), gcn and gcn3: per model the prediction and one
     train step's loss and gradients, card vs CPU, within 1e-3 of each
     scale; run_finetune for 2 epochs with every launch count set to 0
     just before it, the launches equal to finetune_expect's for the
     model's GAT levels (gat_levels: none for gcn2, gcn, gcn3; K1 alone
     for v1 gat, whose bond output reaches no prediction), losses finite;
     a timed train step; gat2_lite also under the dense-attr policy; K1
     and K2 against their plain versions at layer 0 of v1 gat's bond pass
     (3 heads of 5 columns padded to 8; level tagged "v1 bond"); then the
     attention-free aggregations (the GCN atom pass, the GIN bond and atom
     aggregations, the fragment neighbour sum + frag_mlp) forward +
     backward alone on the card, as torch ops: device ms, kernels
     launched, bound, share of their model's step;
 29. the HP search, CV, bucketed finetuning and auxiliary pretraining at
     the esol config's width on phase 3's graphs: (a) run_hp_search
     (backend builtin, 3 trials, seed 0) through the port's ft objective,
     the graphs read from pickles: per trial the launches equal to
     run_expect's, its params, wall and peak memory, the memory held
     between trials flat; every trial read back from the study's sqlite
     table COMPLETE with a finite value (a trial that raised would be
     FAIL, scored 1000.0); (b) the widest trial of the space (FTHead3
     h1-h4 2048, prelu, batch 128): prediction and a train step's
     gradients card vs CPU within 1e-3 of scale, a timed train step, K1,
     K2, K4, K5 against their plain versions at its layer 0 (levels tagged
     "hp batch 128");
     (c) run_finetune_cv, 3 folds x 1 epoch, launches equal to the folds'
     run_expect, scores finite; (d) run_finetune with finetune.n_buckets=3
     for 2 epochs, default and dense-attr policies, launches equal to
     bucket_expect's (from the buckets' batches), then a timed train step
     on the smallest bucket's first batch and K1, K2, K4, K5, K7, K8
     against their plain versions at its layer 0 (levels tagged "bucket
     0"); (e) run_pretrain with pretrain.mode=
     property (mse, a CSV of the 24 smallest molecules and their labels)
     and =structure (ring counts, cel), one epoch each, launches equal to
     aux_expect's, losses finite, the structure model's logits card vs CPU
     within 1e-3 of scale;
 30. bf16 compute (finetune.dtype=bf16) on the main path (bf16_phase):
     (a) the bf16 entries of K1, K2, K4 and K5 against their plain
     versions at layer 0 of a bf16 forward of the esol batch (levels
     tagged "bf16"; every kernel output is f32, held to 1e-4 of its
     scale), timed as in phase 4, their bounds with nf at 2 bytes; (b) one
     bf16 forward and one train step card vs CPU, carried weights, dropout
     off: predictions within 2e-2 of their scale; the gradients' distance
     from the f32 twin's (each parameter's relative to its norm, root mean
     square over the parameters) within twice the CPU bf16's + 1e-3; (c)
     run_finetune in bf16 for 2 epochs, launches exact — the bf16 entries
     as finetune_expect counts the f32 ones, the f32 entries 0 — losses
     finite, the test RMSE beside its f32 twin's (same data and seed, no
     claim); (d) a timed bf16 train step (wall, busy, peak memory) beside
     phase 8's f32 step.
 31. bf16 on the rest of the bf16 paths (bf16_rest_phase): the dense-attr
     policy, DP, EP, geometric and auxiliary pretraining in bf16;
 32. the compact packing encodings (compact_phase): bytes per batch, host
     pack ms, device decode wall and busy, default vs compact, at the esol
     batch 16 and the pretraining batch 64, every decoded field equal bit
     for bit between the two layouts on the card; one epoch of packed
     pretraining from each layout, launches exact (K6 once per train step
     per plane level, K1 / K2 / K4 / K5 as derived), walls and busy side
     by side;
 33. the ELL neighbour-table path (ell_phase; ops/ell.py, torch ops on the
     card as the JAX package runs it in XLA) at the esol width on phase
     8's molecules, batches from spec_for(..., ell=True): a forward, one
     train step's gradients and 3 Adam steps card vs CPU (1e-3 of scale),
     a bf16 forward (2e-2), every GAT kernel's launches 0 and 4 ELL passes
     per layer; a batch with TCSR metadata and ELL tables runs K1 / K4 and
     no ELL pass; the ELL step's wall and busy beside phase 8's, each ELL
     level's forward + backward device ms beside its kernels' (phase 4);
     then the native host runtime (native_phase): loaded, its counters
     moved by the esol featurization and the TCSR builds, host ms per call
     of the line graph and the TCSR windows, native beside Python / numpy
     (equal outputs), on the esol set and a batch-64 pretraining batch.

Prints a ``{"kernels": [...]}`` JSON line (launches from the pretraining
path of phase 11 for K1-K6, of phase 19 for K7-K9 (K9's: K8's, whose
launches compute it) and of phase 21's rank 0 for K3, every path's — each
rank's for phases 21, 23 and 24, the interpret path's of phase 25 under
each policy, each phase-26 model's, phase-27 task's and phase-28 model's
training path, phase 29's HP trials, CV, bucketed and auxiliary runs, and
phase 30's bf16 training path, whose launches the bf16 entries' lines
carry, and phase 32's compact pretraining epoch — beside them; the logit
kernels' launches from phase 11, beside phases 19's and 31's pretraining
paths, their levels from phase 13), and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero on any failure, without a CUDA device, or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import atexit
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

REPO = os.path.dirname(os.path.abspath(__file__))

# configs/ft/esol.yaml as a dict (the card's machine may have no PyYAML);
# tests/test_torch_model.py holds it equal to load_config of the file
ESOL_CONFIG = {
    "seed": 42,
    "exp_dir": "exps/ft/esol",
    "model_version": "gat2",
    "atom_features": 167,
    "frag_features": 167,
    "edge_features": 17,
    "fedge_in": 6,
    "fbond_edge_in": 6,
    "pretrain": {"use": False, "chk": None},
    "finetune": {
        "data": {"name": "esol", "path": None, "split": "scaffold",
                 "frag_type": "brics", "n_synthetic": 512},
        "model": {"num_layer": 4, "num_heads": 4, "drop_ratio": 0.1,
                  "emb_dim": 128, "h1": 128, "h2": 1024, "h3": 1024,
                  "h4": 512, "act": "relu", "fthead": "FTHead3"},
        "target_type": "regr",
        "batch_size": 16,
        "lr": 1.0e-4,
        "n_epochs": 100,
        "es_patience": 100,
        "use_schedular": False,
        "chkpoint_name": "ft.ckpt",
    },
}

# the smoke's overrides of ESOL_CONFIG (dotted path → value): the
# prediction path, and on top of it the training path
SMOKE_OVERRIDES = {
    "finetune.n_epochs": 0,
    "finetune.data.n_synthetic": 96,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol"),
}
TRAIN_OVERRIDES = {
    "finetune.n_epochs": 3,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol_train"),
}

# configs/pt/unimol.yaml as a dict; tests/test_torch_pretrain.py holds it
# equal to load_config of the file
PT_CONFIG = {
    "seed": 42,
    "exp_dir": "exps/pt/unimol",
    "data_type": "exp1s",
    "atom_features": 167,
    "frag_features": 167,
    "edge_features": 17,
    "fedge_in": 6,
    "fbond_edge_in": 6,
    "pretrain": {
        "model_version": "gat2",
        "data_dir": None,
        "n_synthetic": 256,
        "num_conf": 1,
        "model": {"num_layer": 4, "num_heads": 4, "drop_ratio": 0.2,
                  "emb_dim": 128},
        "batch_size": 512,
        "lr": 1.0e-4,
        "n_epochs": 100,
        "es_patience": 200,
        "val_every": 5,
        "optimizer": "adam",
        "compat_loss_overwrite": False,
        "saved_checkpoint": None,
        "chkpoint_name": "pt.ckpt",
    },
}
# the pretraining path's overrides: uncached (so the packed transport runs),
# batch 64 instead of 512 so that 256 molecules give >= 3 train steps per
# epoch, 3 epochs validated every epoch
PT_OVERRIDES = {
    "pretrain.cache": "off",
    "pretrain.batch_size": 64,
    "pretrain.n_epochs": 3,
    "pretrain.val_every": 1,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt"),
}
# on top of PT_OVERRIDES: no packed cache fits, so the spawned workers pack
# every epoch (the process-stream tier), for one epoch
STREAM_OVERRIDES = {
    "pretrain.hbm_cache_gb": 0,
    "pretrain.host_cache_gb": 0,
    "pretrain.n_epochs": 1,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt_stream"),
}

# the dense-attr kernel policy: K7 and K8 (with K9 in its launch) carry the
# atom, frag and fconn passes
# (dotted keys of ESOL_CONFIG / PT_CONFIG under finetune. / pretrain.)
ATTR_KERNEL = {"kernel.attr": True, "kernel.fc": "attr"}
ATTR_TRAIN_OVERRIDES = {
    **{f"finetune.{k}": v for k, v in ATTR_KERNEL.items()},
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol_attr"),
}
# on top of PT_OVERRIDES: the pretraining path under the same policy, one
# epoch
ATTR_PT_OVERRIDES = {
    **{f"pretrain.{k}": v for k, v in ATTR_KERNEL.items()},
    "pretrain.n_epochs": 1,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt_attr"),
}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REL_LIMIT = 1e-4
FORWARD_REL_LIMIT = 1e-3
GRAD_REL_LIMIT = 1e-3


def smoke_opt(train: bool = False, attr: bool = False):
    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(ESOL_CONFIG))
    for k, v in {**SMOKE_OVERRIDES,
                 **(TRAIN_OVERRIDES if train else {}),
                 **(ATTR_TRAIN_OVERRIDES if attr else {})}.items():
        opt.set_path(k, v)
    return opt


def pt_opt(*overrides):
    from fragnet_tpu_torch.config import Config

    opt = Config(copy.deepcopy(PT_CONFIG))
    for ov in overrides:
        for k, v in ov.items():
            opt.set_path(k, v)
    return opt


def _pt_chunk(args):
    """Featurize one chunk of pretrain SMILES (a spawned pool's task)."""
    from fragnet_tpu_torch.data.datasets import PretrainData

    smiles, data_type, num_conf, seed = args
    return PretrainData(data_type=data_type, num_conf=num_conf
                        ).get_pt_dataset(smiles, seed=seed)


class PretrainGraphs:
    """``train.pretrain.load_pretrain_graphs(opt)`` for the synthetic set,
    featurized in ``workers`` spawned processes while the caller goes on
    (each molecule is featurized alone from the same seed, so the graphs
    and their order are the same); ``get()`` waits for them. ``submit``
    queues more featurizing behind them (TaskGraphs); ``close`` stops the
    processes. ``ready`` holds the host clock (time.perf_counter) at which
    each piece of work finished: "pretrain", and each submit's tag."""

    def __init__(self, opt, workers: int):
        import multiprocessing as mp

        from fragnet_tpu_torch.data.synthetic import synthetic_dataset

        seed = int(opt.seed)
        smiles = list(synthetic_dataset(n=int(opt.pretrain.n_synthetic),
                                        task="regression",
                                        seed=seed)["smiles"])
        step = (len(smiles) + workers - 1) // workers
        jobs = [(smiles[i:i + step], opt.data_type,
                 int(opt.pretrain.num_conf), seed)
                for i in range(0, len(smiles), step)]
        self.t0 = time.perf_counter()
        self.workers = len(jobs)
        self.ready = {}
        self._pool = mp.get_context("spawn").Pool(len(jobs))
        self._res = self.submit(_pt_chunk, jobs, "pretrain")

    def close(self):
        """Stop the featurizing processes."""
        self._pool.terminate()
        self._pool.join()

    def submit(self, fn, jobs, tag: str):
        """``map_async(fn, jobs)`` on the pool, after the work queued
        before; ``ready[tag]`` is set when it has finished."""
        def done(_result):
            self.ready[tag] = time.perf_counter()

        return self._pool.map_async(fn, jobs, callback=done)

    def get(self):
        try:
            parts = self._res.get(timeout=600)
        except BaseException:
            self.close()
            raise
        return [g for part in parts for g in part]


def _median_ms(fn, n: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, n: int = 50, tries: int = 5) -> float:
    """Device time per call: the summed time of the CUDA activity that
    torch.profiler (CUPTI) records over ``n`` calls, divided by ``n``; it
    leaves out the host's dispatch time that the event timing includes.
    Every timed callable launches device work, so a profile with no device
    time (CUPTI now and then delivers none) is taken again — from the
    second try on with the CPU activity too, its device-side rows summed as
    ``_busy`` sums them — and after ``tries`` such profiles this raises
    rather than report 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for i in range(tries):
        acts = [ProfilerActivity.CUDA] if i == 0 else [
            ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_ms = (_busy(prof)[0] if i else sum(
            getattr(e, "self_device_time_total", 0.0)
            for e in prof.key_averages()) / 1e3)
        if total_ms > 0:
            return total_ms / n
    raise AssertionError(f"the profiler recorded no device time in {tries} "
                         f"profiles of {n} calls")


def _diff(k, p, floor: float = 0.0):
    """(max abs diff, max abs diff / max(max|plain|, floor)) over entries
    that are not the −1e30 empty-row marker; the markers must agree
    exactly."""
    import torch

    k, p = k.float(), p.float()
    marker = p <= -1e29
    if not torch.equal(k <= -1e29, marker):
        raise AssertionError("empty-row markers (m = -1e30) disagree")
    k, p = k[~marker], p[~marker]
    if not bool(torch.isfinite(k).all()):
        raise AssertionError("kernel output is not finite")
    if k.numel() == 0:
        return 0.0, 0.0
    err = float((k - p).abs().max())
    return err, err / max(float(p.abs().max()), floor, 1e-30)


def _scale_floor(name, args) -> float:
    """The scale below which a backward output is round-off: max|s| (for
    K3's backward s = −dV). The logit-gradient outputs (d_wd, d_ws, d_vc;
    d_wn, d_w_ea) are sums of p·(d_p − s), which cancel exactly where a
    row's neighbours carry equal features — as at the fconn level of the
    smoke's batch, at every layer — leaving round-off of terms of size |s|.
    0 for a forward kernel."""
    idx = {"tcsr_gat_bwd": 10, "dense_gat_bwd": 8,
           "dense_attr_bwd": 12, "tcsr_gat_ep_bwd": 10}.get(
               KERNELS[name].wrapper or name)
    return 0.0 if idx is None else float(args[idx].abs().max())


class _Capture:
    """Records the arguments of every kernel-wrapper call of one forward
    (the wrappers are looked up through their modules at call time)."""

    def __init__(self, names):
        from fragnet_tpu_torch.ops import dense_gat, tcsr_gat

        mods = {"tcsr_gat_fwd": tcsr_gat, "dense_gat_fwd": dense_gat,
                "dense_attr_fwd": dense_gat}
        self.mods = {n: mods[n] for n in names}
        self.calls = {k: [] for k in self.mods}
        self._orig = {}

    def __enter__(self):
        for name, mod in self.mods.items():
            orig = getattr(mod, name)
            self._orig[name] = orig

            def rec(*args, _orig=orig, _name=name, **kw):
                self.calls[_name].append((args, kw))
                return _orig(*args, **kw)

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self._orig[name])


# each forward kernel's levels in the order of one layer's calls
LEVELS = {"tcsr_gat_fwd": ["atom (self-loops)", "frag"],
          "dense_gat_fwd": ["bond (R=1)", "fconn (R=6)"],
          "dense_attr_fwd": ["atom (self-loops)",
                             "fconn (rows 0..tn of the R=6 planes)", "frag"]}
# a level checked against the plain version but not timed
SEEDED = "fconn (R=6), seeded nf and attrs"


def smoke_batch(opt, datasets):
    """(spec, the test split's batch windows, the first test batch as
    numpy) — what run_finetune builds for the same datasets."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for

    train_g, val_g, test_g, n_tasks, _task = datasets
    bs = int(opt.finetune.batch_size)
    spec = spec_for(train_g + val_g + test_g, batch_size=bs, tcsr=True)
    windows = list(BatchLoader(test_g, bs, spec=spec,
                               n_tasks=n_tasks)._windows())
    return spec, windows, pad_batch(windows[0], spec, n_tasks=n_tasks)


def layer0_kernel_calls(n_layers: int, model, batch,
                        names=("tcsr_gat_fwd", "dense_gat_fwd")):
    """{kernel: [(level, args, kwargs), ...]}: the calls of each of the
    ``names`` forward wrappers in layer 0 of one forward of ``model`` (of
    ``n_layers`` layers) on ``batch``."""
    import torch

    with _Capture(names) as cap, torch.no_grad():
        model(batch)
    out = {}
    for name, calls in cap.calls.items():
        per_layer = len(LEVELS[name])
        if len(calls) != per_layer * n_layers:
            raise AssertionError(f"{name}: {len(calls)} calls in one forward")
        out[name] = [(lvl, a, kw) for lvl, (a, kw)
                     in zip(LEVELS[name], calls[:per_layer])]
    return out


def seeded_fconn_call(fconn_call, rng):
    """The fconn forward call with its node features and its attribute
    planes 1..R (at the plane-0 edges) drawn with numpy. In the smoke's
    batch each fconn row's neighbours carry equal features and only plane 1
    is nonzero, so there the backward's d_wd, d_ws and d_vc are round-off
    and the forward's rank terms r >= 1 are never read; here all of them are
    of the order of their inputs."""
    import numpy as np
    import torch

    _lvl, args, kw = fconn_call
    planes, wd, ws, nf, vc = args[:5]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    pl = planes.view(T, R + 1, tn, tn)
    attrs = torch.from_numpy(rng.standard_normal((T, R, tn, tn)).astype(
        np.float32)).to(planes.device)
    attrs = torch.where(pl[:, :1] > 0, attrs, torch.zeros_like(attrs))
    planes_s = torch.cat([pl[:, :1], attrs], dim=1).reshape(T, rows, tn)
    nf_s = torch.from_numpy(rng.standard_normal(tuple(nf.shape)).astype(
        np.float32)).to(nf.device)
    return (SEEDED, (planes_s.contiguous(), wd, ws, nf_s, vc) + tuple(args[5:]),
            kw)


def seeded_attr_call(call, rng):
    """A captured dense-attr forward call with its logit terms wd, ws, the
    node features and w_ea drawn with numpy (the adjacency, the edges and
    the windows kept): every output of K7-K9 is then of the order of its
    inputs, whatever the smoke's features make cancel."""
    import numpy as np
    import torch

    lvl, args, kw = call
    drawn = tuple(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)).to(t.device, t.dtype) for t in args[1:5])
    return (f"{lvl}, seeded", (args[0],) + drawn + tuple(args[5:]), kw)


def k2_outside_fn(args, rng):
    """A callable that runs, at the shapes of one TCSR backward call, the
    part of the TPU backward kernel's work (pallas_gat.py:290-309: d_a_src
    and the a_src term of d_nf) that the port leaves to autograd: the
    transpose of the prologue's w_src = nf·a_src (ops/tcsr_gat.py:
    prologue), given d_w_src = d_wn[:, H:]. Values are drawn with numpy;
    the work does not depend on them."""
    import numpy as np
    import torch

    wn, nf = args[:2]
    N, HD = nf.shape
    H = wn.shape[1] // 2

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(nf.device)

    nf3 = nf.detach().view(N, H, HD // H).clone().requires_grad_()
    a_src = draw(H, HD // H).requires_grad_()
    w_src = torch.einsum("nhd,hd->nh", nf3, a_src)
    d_w_src = draw(N, H)
    return lambda: torch.autograd.grad(w_src, (nf3, a_src), d_w_src,
                                       retain_graph=True)


def _tcsr_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, self_loops = args[:8]
    N, HD = nf.shape
    H = wn.shape[1] // 2
    D = HD // H
    n_edges = int((emask > 0).sum())
    n_tiles = meta.ew_blk.shape[0]
    # inputs read once (node arrays — nf at its own width, 2 bytes in bf16
    # — the real edges' scalars, tile windows) + outputs written once
    nbytes = 4 * (N * 2 * H + n_edges * (H + 3) + 2 * n_tiles
                  + N * (HD + 2 * H)) + nf.element_size() * N * HD
    flops = n_edges * H * (2 * D + 6) + N * HD
    return nbytes, flops


def _dense_cost(args):
    planes, wd, ws, nf, vc = args[:5]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    nnz = int((planes.view(T, R + 1, tn, tn)[:, 0] > 0).sum())
    # inputs read once: the adjacency planes, the nonzeros' R attribute
    # values (the attribute planes hold nothing else), wd, ws, nf (at its
    # own width), vc; outputs written once: out, m, den. Work at the
    # nonzeros only
    nbytes = 4 * (T * tn * tn + nnz * R + 2 * N * H + vc.numel()
                  + N * (HD + 2 * H)) + nf.element_size() * N * HD
    flops = nnz * H * (2 * R + 4) + 2 * nnz * HD
    return nbytes, flops


def _tcsr_bwd_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, m, den, g, s, self_loops = args[:12]
    N, HD = nf.shape
    H = wn.shape[1] // 2
    D = HD // H
    E = src.shape[0]
    n_edges = int((emask > 0).sum())
    n_tiles = meta.ew_blk.shape[0]
    # inputs read once (node arrays — nf at its own width — m/den/s, g,
    # the real edges' scalars, tile windows) + outputs written once (d_wn,
    # d_nf, d_w_ea)
    nbytes = 4 * (N * 2 * H + 3 * N * H + N * HD + n_edges * (H + 3)
                  + 2 * n_tiles + N * (2 * H + HD) + E * H) \
        + nf.element_size() * N * HD
    items = n_edges + (N if self_loops else 0)
    flops = items * H * (4 * D + 10)
    return nbytes, flops


def _ep_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, rank = args[:8]
    HD = nf.shape[1]
    H = wn.shape[1] // 2
    D = HD // H
    Tg = meta.n_tiles_grid
    Ng = Tg * meta.tn
    n_edges = int((emask > 0).sum())
    # as _tcsr_cost over the shard's kept edges and its Ng grid rows: the
    # grid's node arrays (nf at its own width), the edges' scalars and the
    # windows read once, the grid's out, m, den written once
    nbytes = 4 * (Ng * 2 * H + n_edges * (H + 3) + 2 * Tg
                  + Ng * (HD + 2 * H)) + nf.element_size() * Ng * HD
    flops = n_edges * H * (2 * D + 6) + Ng * HD
    return nbytes, flops


def _ep_bwd_cost(args):
    wn, nf, w_ea, src, dst, emask, meta, rank, m, dU, dV = args[:11]
    HD = nf.shape[1]
    H = wn.shape[1] // 2
    D = HD // H
    Es = src.shape[0]
    Tg = meta.n_tiles_grid
    Ng = Tg * meta.tn
    n_edges = int((emask > 0).sum())
    # as _tcsr_bwd_cost over the shard's kept edges and its grid rows (nf
    # at its own width)
    nbytes = 4 * (Ng * 2 * H + 3 * Ng * H + Ng * HD + n_edges * (H + 3)
                  + 2 * Tg + Ng * (2 * H + HD) + Es * H) \
        + nf.element_size() * Ng * HD
    flops = n_edges * H * (4 * D + 10)
    return nbytes, flops


def _dense_bwd_cost(args):
    planes, wd, ws, nf, vc, m, den, g, s = args[:9]
    T, rows, tn = planes.shape
    R = rows // tn - 1
    N, H = wd.shape
    HD = nf.shape[1]
    D = HD // H
    nnz = int((planes.view(T, R + 1, tn, tn)[:, 0] > 0).sum())
    # inputs read once: the adjacency planes, the nonzeros' R attribute
    # values, wd, ws, m, den, s, nf (at its own width), g, vc; outputs
    # written once: d_wd, d_ws, d_nf, d_vc. Work at the nonzeros only
    nbytes = 4 * (T * tn * tn + nnz * R + 5 * N * H + N * HD
                  + vc.numel() + 2 * N * H + N * HD + vc.numel()) \
        + nf.element_size() * N * HD
    flops = nnz * H * (4 * D + 2 * R + 6)
    return nbytes, flops


def _attr_cost(args):
    adj, wd, ws, nf, w_ea, src, dst, emask, meta, self_loops = args[:10]
    T, tn, _ = adj.shape
    N, H = wd.shape
    HD = nf.shape[1]
    nnz = int((adj > 0).sum())
    n_edges = int((emask > 0).sum())
    # the adjacency planes, wd, ws, nf (at its own width), the real edges'
    # w_ea and scalars and the tile windows read once; out, m, den written
    # once
    nbytes = 4 * (T * tn * tn + 2 * N * H + n_edges * (H + 3) + 2 * T
                  + N * (HD + 2 * H)) + nf.element_size() * N * HD
    flops = (T * tn * tn * H * 5 + 2 * nnz * HD
             + (2 * N * HD if self_loops else 0))
    return nbytes, flops


def _attr_bwd_cost(args):
    (adj, wd, ws, nf, w_ea, src, dst, emask, meta, m, den, g, s,
     self_loops) = args[:14]
    T, tn, _ = adj.shape
    N, H = wd.shape
    HD = nf.shape[1]
    D = HD // H
    nnz = int((adj > 0).sum())
    n_edges = int((emask > 0).sum())
    E = src.shape[0]
    # inputs read once (adjacency, wd, ws, m, den, s, nf at its own width,
    # g, the real edges' w_ea and scalars, windows) + outputs written once
    # (d_wd, d_ws, d_wself, d_nf, d_wea for every edge)
    nbytes = 4 * (T * tn * tn + 5 * N * H + N * HD + n_edges * (H + 3)
                  + 2 * T + 3 * N * H + N * HD + E * H) \
        + nf.element_size() * N * HD
    flops = (T * tn * tn * H * 6 + nnz * H * (4 * D + 6)
             + (N * H * (4 * D + 10) if self_loops else 0))
    return nbytes, flops


def _emit_cost(args):
    """K9's share of K8's launch, on the emit's arguments (d_zpre planes,
    src, dst, emask, meta): (E, H) written, every edge's src, dst and mask
    and the windows read; the d_zpre values at the counted edges' slots
    are K8's registers, no longer read from memory. One product per
    counted value."""
    dz, src, dst, emask, meta = args[:5]
    T, Htn, tn = dz.shape
    H = Htn // tn
    E = src.shape[0]
    n_kept = int(_emit_index(args)[0].shape[0])
    nbytes = 4 * (3 * E + 2 * T + E * H)
    return nbytes, n_kept * H


def _emit_index(args):
    from fragnet_tpu_torch.ops.dense_gat import _plane_edges

    dz, src, dst, emask, meta = args[:5]
    return _plane_edges(src, dst, emask, dz.shape[0] * dz.shape[2], meta)


def emit_library_fn(args):
    """K9's yardstick: one advanced-indexing gather of the d_zpre planes at
    the counted edges' slots, on indices computed beforehand (used nowhere
    in the port). Returns (callable, edge ids) — the gather's rows are
    d_wea[ids] / emask[ids]."""
    dz = args[0]
    T, Htn, tn = dz.shape
    k, t, di, sj = _emit_index(args)
    planes = dz.view(T, Htn // tn, tn, tn)
    return (lambda: planes[t, :, di, sj]), k


def _planes_cost(args):
    src, dst, emask, ea, n_nodes, meta = args[:6]
    R = 0 if ea is None else ea.shape[1]
    n_edges = int((emask > 0).sum())
    # the planes written once + the kept edges' src, dst, mask and attrs
    # read once + the tile windows; one add per plane value
    nbytes = 4 * (n_nodes * (R + 1) * meta.tn + n_edges * (3 + R)
                  + 2 * meta.ew_blk.shape[0])
    return nbytes, n_edges * (R + 1)


def _bound_ms(nbytes, flops, flops_per_s=F32_FLOPS):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flops_per_s * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


class Kernel(NamedTuple):
    module: str              # fragnet_tpu_torch.ops module of the wrapper
    counter: str             # its CudaKernel attribute (launch counter)
    plain: str               # the plain version's name in that module
    cost: Callable           # args -> (bytes, flops)
    fwd: Optional[str]       # the forward kernel this is the backward of
    source: str
    replaces: str            # the TPU kernel, file:line
    wrapper: Optional[str] = None  # its wrapper, where not named as it is:
                                   # a dtype form of the wrapper's kernel


# every kernel of the path, by wrapper name
KERNELS = {
    "tcsr_gat_fwd": Kernel("tcsr_gat", "KERNEL", "tcsr_gat_fwd_plain",
                           _tcsr_cost, None,
                           "fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                           "fragnet_tpu/ops/pallas_gat.py:105"),
    "tcsr_gat_bwd": Kernel("tcsr_gat", "KERNEL_BWD", "tcsr_gat_bwd_plain",
                           _tcsr_bwd_cost, "tcsr_gat_fwd",
                           "fragnet_tpu_torch/csrc/tcsr_gat_bwd.cu",
                           "fragnet_tpu/ops/pallas_gat.py:199"),
    "dense_gat_fwd": Kernel("dense_gat", "KERNEL", "dense_gat_fwd_plain",
                            _dense_cost, None,
                            "fragnet_tpu_torch/csrc/dense_gat_fwd.cu",
                            "fragnet_tpu/ops/dense_gat.py:387"),
    "dense_gat_bwd": Kernel("dense_gat", "KERNEL_BWD", "dense_gat_bwd_plain",
                            _dense_bwd_cost, "dense_gat_fwd",
                            "fragnet_tpu_torch/csrc/dense_gat_bwd.cu",
                            "fragnet_tpu/ops/dense_gat.py:419"),
    "build_dense_planes_device": Kernel(
        "dense_gat", "KERNEL_PLANES", "build_dense_planes_device_plain",
        _planes_cost, None, "fragnet_tpu_torch/csrc/dense_planes.cu",
        "fragnet_tpu/ops/dense_gat.py:105"),
    "dense_attr_fwd": Kernel("dense_gat", "KERNEL_ATTR",
                             "dense_attr_fwd_plain", _attr_cost, None,
                             "fragnet_tpu_torch/csrc/dense_attr_fwd.cu",
                             "fragnet_tpu/ops/dense_gat.py:216"),
    "dense_attr_bwd": Kernel("dense_gat", "KERNEL_ATTR_BWD",
                             "dense_attr_bwd_emit_plain", _attr_bwd_cost,
                             "dense_attr_fwd",
                             "fragnet_tpu_torch/csrc/dense_attr_bwd.cu",
                             "fragnet_tpu/ops/dense_gat.py:276"),
    "tcsr_gat_ep_fwd": Kernel("tcsr_gat", "KERNEL_EP",
                              "tcsr_gat_ep_fwd_plain", _ep_cost, None,
                              "fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                              "fragnet_tpu/ops/pallas_gat.py:635"),
    "tcsr_gat_ep_bwd": Kernel("tcsr_gat", "KERNEL_EP_BWD",
                              "tcsr_gat_ep_bwd_plain", _ep_bwd_cost,
                              "tcsr_gat_ep_fwd",
                              "fragnet_tpu_torch/csrc/tcsr_gat_bwd.cu",
                              "fragnet_tpu/ops/pallas_gat.py:635"),
    # the bf16 forms of K1, K2, K4 and K5: the same wrappers with bf16 nf
    # launch these entries (the JAX package's dt_name = bfloat16 builds,
    # pallas_gat.py:361 / dense_gat.py:704)
    "tcsr_gat_fwd_bf16": Kernel("tcsr_gat", "KERNEL_BF16",
                                "tcsr_gat_fwd_plain", _tcsr_cost, None,
                                "fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                                "fragnet_tpu/ops/pallas_gat.py:105",
                                "tcsr_gat_fwd"),
    "tcsr_gat_bwd_bf16": Kernel("tcsr_gat", "KERNEL_BWD_BF16",
                                "tcsr_gat_bwd_plain", _tcsr_bwd_cost,
                                "tcsr_gat_fwd_bf16",
                                "fragnet_tpu_torch/csrc/tcsr_gat_bwd.cu",
                                "fragnet_tpu/ops/pallas_gat.py:199",
                                "tcsr_gat_bwd"),
    "dense_gat_fwd_bf16": Kernel("dense_gat", "KERNEL_BF16",
                                 "dense_gat_fwd_plain", _dense_cost, None,
                                 "fragnet_tpu_torch/csrc/dense_gat_fwd.cu",
                                 "fragnet_tpu/ops/dense_gat.py:387",
                                 "dense_gat_fwd"),
    "dense_gat_bwd_bf16": Kernel("dense_gat", "KERNEL_BWD_BF16",
                                 "dense_gat_bwd_plain", _dense_bwd_cost,
                                 "dense_gat_fwd_bf16",
                                 "fragnet_tpu_torch/csrc/dense_gat_bwd.cu",
                                 "fragnet_tpu/ops/dense_gat.py:419",
                                 "dense_gat_bwd"),
    # the bf16 forms of K7, K8 (with K9 in its launch) and K3 (the JAX
    # package's _build_attr / _make_ep_op dt_name = bfloat16 builds,
    # dense_gat.py:476 / pallas_gat.py:786)
    "dense_attr_fwd_bf16": Kernel("dense_gat", "KERNEL_ATTR_BF16",
                                  "dense_attr_fwd_plain", _attr_cost, None,
                                  "fragnet_tpu_torch/csrc/dense_attr_fwd.cu",
                                  "fragnet_tpu/ops/dense_gat.py:216",
                                  "dense_attr_fwd"),
    "dense_attr_bwd_bf16": Kernel("dense_gat", "KERNEL_ATTR_BWD_BF16",
                                  "dense_attr_bwd_emit_plain",
                                  _attr_bwd_cost, "dense_attr_fwd_bf16",
                                  "fragnet_tpu_torch/csrc/dense_attr_bwd.cu",
                                  "fragnet_tpu/ops/dense_gat.py:276",
                                  "dense_attr_bwd"),
    "tcsr_gat_ep_fwd_bf16": Kernel("tcsr_gat", "KERNEL_EP_BF16",
                                   "tcsr_gat_ep_fwd_plain", _ep_cost, None,
                                   "fragnet_tpu_torch/csrc/tcsr_gat_fwd.cu",
                                   "fragnet_tpu/ops/pallas_gat.py:635",
                                   "tcsr_gat_ep_fwd"),
    "tcsr_gat_ep_bwd_bf16": Kernel("tcsr_gat", "KERNEL_EP_BWD_BF16",
                                   "tcsr_gat_ep_bwd_plain", _ep_bwd_cost,
                                   "tcsr_gat_ep_fwd_bf16",
                                   "fragnet_tpu_torch/csrc/tcsr_gat_bwd.cu",
                                   "fragnet_tpu/ops/pallas_gat.py:635",
                                   "tcsr_gat_ep_bwd"),
}
# the GAT kernels of the default policy, which phase 4 captures from a
# finetune forward, and the dense-attr kernels, which phase 16 captures
GAT_KERNELS = ("tcsr_gat_fwd", "tcsr_gat_bwd", "dense_gat_fwd",
               "dense_gat_bwd")
ATTR_KERNELS = ("dense_attr_fwd", "dense_attr_bwd")
EP_KERNELS = ("tcsr_gat_ep_fwd", "tcsr_gat_ep_bwd")
# the bf16 form of every GAT kernel, by its f32 form: phase 30 captures
# those of the default policy from a bf16 finetune forward (GAT_BF16),
# phase 31 the dense-attr and edge-partitioned ones (ATTR_BF16, EP_BF16)
BF16_OF = {n: f"{n}_bf16" for n in GAT_KERNELS + ATTR_KERNELS + EP_KERNELS}
BF16_KERNELS = tuple(BF16_OF.values())
GAT_BF16 = tuple(BF16_OF[n] for n in GAT_KERNELS)
ATTR_BF16 = tuple(BF16_OF[n] for n in ATTR_KERNELS)
EP_BF16 = tuple(BF16_OF[n] for n in EP_KERNELS)
# layer 0's edge-partitioned passes, in call order
EP_LEVELS = ["bond", "atom (self-loops in the combine)", "fconn", "frag"]
# K9, the TPU emit kernel, has no launch of its own: K8 computes d_wea in
# its launch. It stands in the kernels' line with K8's source and launches
EMIT = "dense_attr_emit"
EMIT_IN = "dense_attr_bwd"
EMIT_REPLACES = "fragnet_tpu/ops/dense_gat.py:359"
PLANES = "build_dense_planes_device"
PLANE_LEVELS = {"dp_bond": "bond (R=1)", "dp_fc": "fconn (R=6)",
                "dp_atom": "atom (R=0)", "dp_frag": "frag (R=0)"}
# the plane levels that the default policy's pretraining step builds
PLANES_ON_PATH = ("bond (R=1)", "fconn (R=6)")
# the GAT logit terms' kernels (csrc/gat_logits.cu) by name, with the
# CudaKernel entries of ops/gat_logits.py whose launches each sums (its f32
# and bf16 forms). Every GAT pass launches them, whatever kernel runs the
# pass, so they stand apart from KERNELS, whose counts the paths' expected
# launches name; the pretraining paths and the EP step check them
LOGIT_KERNELS = {"gat_logits_fwd": ("KERNEL", "KERNEL_BF16"),
                 "gat_logits_bwd": ("KERNEL_BWD", "KERNEL_BWD_BF16"),
                 "gat_logits_dvec": ("KERNEL_DVEC",)}
LOGIT_SOURCE = "fragnet_tpu_torch/csrc/gat_logits.cu"
# no TPU kernel: the JAX package forms the terms with XLA einsums
LOGIT_REPLACES = "none (XLA einsums, fragnet_tpu/ops/pallas_gat.py:471)"
# one layer's GAT passes in call order (model/layers.py:FragNetLayer)
LOGIT_LEVELS = ("bond", "atom", "fconn", "frag")
# H100 SXM f64 (non-tensor) flop/s (NVIDIA data sheet): the logit kernels
# multiply and sum in f64
F64_FLOPS = 34e12


def _counter(name):
    """(the wrapper's module, its CudaKernel with the launch count)."""
    from fragnet_tpu_torch.ops import dense_gat, tcsr_gat

    k = KERNELS[name]
    mod = {"tcsr_gat": tcsr_gat, "dense_gat": dense_gat}[k.module]
    return mod, getattr(mod, k.counter)


def _wrapper(name):
    """The wrapper that launches kernel ``name`` (for a bf16 form: the f32
    form's wrapper, given bf16 node features)."""
    return getattr(_counter(name)[0], KERNELS[name].wrapper or name)


def as_bf16(expect):
    """Launch counts of the f32 GAT kernels moved to their bf16 forms: a
    path in bf16 launches the bf16 entries where f32 launches the f32
    ones, and no f32 GAT entry."""
    out = dict(expect)
    for n32, n16 in BF16_OF.items():
        out[n16], out[n32] = out[n32], 0
    return out


def _reset_launches():
    from fragnet_tpu_torch.ops import gat_logits

    for name in KERNELS:
        _counter(name)[1].launches = 0
    for entries in LOGIT_KERNELS.values():
        for e in entries:
            getattr(gat_logits, e).launches = 0


def _logit_launches():
    """Each logit kernel's launches, its f32 and bf16 entries summed."""
    from fragnet_tpu_torch.ops import gat_logits

    return {n: sum(getattr(gat_logits, e).launches for e in entries)
            for n, entries in LOGIT_KERNELS.items()}


def _logit_symbols():
    """{launcher symbol: its LOGIT_KERNELS name}."""
    from fragnet_tpu_torch.ops import gat_logits

    return {getattr(gat_logits, e).symbol: n
            for n, entries in LOGIT_KERNELS.items() for e in entries}


def logit_expect(expect):
    """The logit kernels' launches on a path whose GAT passes all run
    KERNELS' kernels, whose counts are ``expect``: every pass launches the
    forward once, and every pass whose backward runs launches the backward
    and the d_vec sum once (ops/gat_logits.py:GatLogitsFn)."""
    fwd = sum(expect[n] for n, k in KERNELS.items()
              if k.fwd is None and n != PLANES)
    bwd = sum(expect[n] for n, k in KERNELS.items() if k.fwd is not None)
    return {"gat_logits_fwd": fwd, "gat_logits_bwd": bwd,
            "gat_logits_dvec": bwd}


def _launches():
    return {name: _counter(name)[1].launches for name in KERNELS}


def bwd_kernel_args(fwd_name, args, kw, rng):
    """The backward wrapper's arguments for one captured forward call: the
    forward kernel's (out, m, den), a cotangent g of out drawn with numpy
    and s = Σ_d g·out, spliced in before the flags as the wrappers take
    them."""
    import numpy as np
    import torch

    out, m, den = _wrapper(fwd_name)(*args, **kw)
    N, HD = out.shape
    H = m.shape[1]
    g = torch.from_numpy(rng.standard_normal((N, HD)).astype(np.float32)
                         ).to(out.device)
    s = (g.view(N, H, -1) * out.view(N, H, -1)).sum(-1)
    k = {"tcsr_gat_fwd": 7, "dense_gat_fwd": 5,
         "dense_attr_fwd": 9}[KERNELS[fwd_name].wrapper or fwd_name]
    return tuple(args[:k]) + (m, den, g, s) + tuple(args[k:])


def _planes_of(batch):
    """The dense-plane levels a (host or device) batch carries."""
    return {lvl for lvl in ("dp_bond", "dp_fc", "dp_atom", "dp_frag")
            if getattr(batch, lvl) is not None}


def gat_levels(model_version: str, n_layers: int):
    """({plane level: backward passes per train step} of each GAT level a
    forward of ``model_version`` runs in every layer, {level: the kernel
    route it takes whatever the policy says}). gat2 and the models on its
    encoder run the bond, fconn, atom and frag passes; the backward runs
    for every layer's bond, fconn and atom pass and for the last layer's
    frag pass (each layer recomputes fragment features from atoms, so the
    earlier frag outputs are off the loss's path). gat2_lite runs the bond
    and atom passes, gat2_edge also the frag pass (over the connection
    attributes). v1 gat runs the bond pass on the TCSR kernel, and its
    output reaches no prediction (only the unused edge_embed), so no
    backward runs; gcn2, gcn and gcn3 run no GAT pass."""
    L = n_layers
    if model_version == "gat2_lite":
        return {"dp_bond": L, "dp_atom": L}, {}
    if model_version == "gat2_edge":
        return {"dp_bond": L, "dp_atom": L, "dp_frag": 1}, {}
    if model_version == "gat":
        return {"dp_bond": 0}, {"dp_bond": "tcsr"}
    if model_version in ("gcn2", "gcn", "gcn3"):
        return {}, {}
    return {"dp_bond": L, "dp_fc": L, "dp_atom": L, "dp_frag": 1}, {}


def expected_launches(policy, n_layers: int, batches,
                      model_version: str = "gat2"):
    """Each GAT kernel's launches for ``batches`` = [(plane levels the
    batch carries, forwards, train steps)] under a KernelPolicy: per
    forward each layer runs the GAT levels of ``model_version``
    (gat_levels), each through the dense kernel its policy names when the
    batch has that level's planes, else through the TCSR kernel
    (model/layers.py:_gat_dispatch); per train step the backward passes
    gat_levels counts. The plane builder is counted by the caller."""
    mode = {"dp_bond": policy.bond, "dp_fc": policy.fc,
            "dp_atom": "attr" if policy.attr else "tcsr",
            "dp_frag": "attr" if policy.attr else "tcsr"}
    bwd_passes, fixed = gat_levels(model_version, n_layers)
    mode.update(fixed)
    kernels = {"planes": ("dense_gat_fwd", ("dense_gat_bwd",)),
               "attr": ("dense_attr_fwd", ("dense_attr_bwd",)),
               "tcsr": ("tcsr_gat_fwd", ("tcsr_gat_bwd",))}
    out = {n: 0 for n in KERNELS}
    for have, n_fwd, n_steps in batches:
        for lvl, n_bwd in bwd_passes.items():
            fwd, bwds = kernels[mode[lvl] if lvl in have else "tcsr"]
            out[fwd] += n_layers * n_fwd
            for b in bwds:
                out[b] += n_bwd * n_steps
    return out


def _outputs(r):
    return r if isinstance(r, tuple) else (r,)


def check_kernels(names, calls, rng, check_scales=None):
    """Phases 4 and 16: each kernel in ``names`` against its plain version
    on the card at every captured level of ``calls`` ({kernel: [(level,
    args, kwargs)]}): max abs and relative diff of every output (limit 1e-4
    of the output's scale, for a backward output at least max|s|), and for
    a level that is not a seeded case the wrapper's and the plain version's
    ms and device ms, the bound, and the torch ops around K2. A seeded
    level holds each output to its own scale and is not timed. K8's d_wea
    (the emit K9, computed in K8's launch) also gets a report of its own
    under EMIT (emit_levels). ``check_scales`` (name, level, args, kernel
    outputs, plain outputs), where given, vets every case's data. Returns
    {kernel: (per-level report, worst seeded max abs err)}."""
    import torch

    report = {}
    for name in names:
        k = KERNELS[name]
        mod, _ = _counter(name)
        wrapper, plain = _wrapper(name), getattr(mod, k.plain)
        per_level, seeded_err = [], 0.0
        emit, emit_seeded_err = [], 0.0
        for lvl, args, kw in calls[name]:
            got = _outputs(wrapper(*args, **kw))
            want = _outputs(plain(*args, **kw))
            torch.cuda.synchronize()
            if check_scales is not None:
                check_scales(name, lvl, args, got, want)
            seeded = "seeded" in lvl
            floor = 0.0 if seeded else _scale_floor(name, args)
            errs = [_diff(k_, p, floor) for k_, p in zip(got, want)]
            err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            scales = ", ".join(f"{float(p.abs().max()):.2e}" for p in want)
            if seeded:
                print(f"{name} [{lvl}]: max_abs_err={err:.3e} rel={rel:.3e} "
                      f"(worst of {len(errs)} outputs; output scales "
                      f"{scales}; limit {REL_LIMIT})")
                if rel > REL_LIMIT:
                    raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                         f"plain version: rel {rel:.3e}")
                seeded_err = max(seeded_err, err)
                if name == EMIT_IN:
                    emit_levels(args, got[4], want[4], errs[4])
                    emit_seeded_err = max(emit_seeded_err, errs[4][0])
                continue
            ms = _median_ms(lambda: wrapper(*args, **kw))
            plain_ms = _median_ms(lambda: plain(*args, **kw))
            dev_ms = _device_ms(lambda: wrapper(*args, **kw))
            plain_dev_ms = _device_ms(lambda: plain(*args, **kw))
            nbytes, flops = k.cost(args)
            bound, by = _bound_ms(nbytes, flops)
            extra = {}
            if name == "tcsr_gat_bwd":
                extra["outside_device_ms"] = _device_ms(
                    k2_outside_fn(args, rng))
            shape = "x".join(str(s) for s in args[0].shape)
            print(f"{name} [{lvl}] in0={shape}: max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (worst of {len(errs)} outputs; output "
                  f"scales {scales}; limit {REL_LIMIT}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} device_ms={dev_ms:.4f} "
                  f"plain_device_ms={plain_dev_ms:.4f} "
                  f"bound_ms={bound:.5f} ({by}: {nbytes} B, {flops} flop)"
                  + "".join(f" {k_}={v:.4f}" for k_, v in extra.items()))
            if rel > REL_LIMIT:
                raise AssertionError(f"{name} [{lvl}] disagrees with its "
                                     f"plain version: rel {rel:.3e}")
            per_level.append(dict(level=lvl, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                  plain_device_ms=plain_dev_ms,
                                  bound_ms=bound, bound_by=by, bytes=nbytes,
                                  flops=flops, **extra))
            if name == EMIT_IN:
                emit.append(emit_levels(args, got[4], want[4], errs[4],
                                        per_level[-1]))
        report[name] = (per_level, seeded_err)
        if name == EMIT_IN:
            report[EMIT] = (emit, emit_seeded_err)
    return report


def emit_levels(args, d_wea, want, err, k8=None):
    """K9's check and report at one level of K8's calls ``args``: K8's
    d_wea against the plain emit of the plain backward's d_zpre planes
    (``want``; ``err`` its (max abs, relative) diff, limit 1e-4 of scale)
    and exactly 0 on every edge the forward did not count; at a timed
    level (``k8``, K8's report there) also the emit's plain version and
    the library gather, each timed on those planes, and the bound of the
    emit's share of the launch. The fused launch's own times are K8's."""
    import torch

    from fragnet_tpu_torch.ops import dense_gat

    lvl = "seeded" if k8 is None else k8["level"]
    src, dst, emask, meta = args[5:9]
    dz = dense_gat.dense_attr_bwd_plain(*args)[4]
    eargs = (dz, src, dst, emask, meta)
    ids = _emit_index(eargs)[0]
    counted = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    counted[ids] = True
    zeros_ok = not bool(d_wea[~counted].any())
    if err[1] > REL_LIMIT or not zeros_ok:
        raise AssertionError(f"{EMIT} [{lvl}] (K8's d_wea) disagrees with "
                             f"the plain pair: rel {err[1]:.3e}, zero off "
                             f"the counted edges: {zeros_ok}")
    if k8 is None:
        return None
    plain = dense_gat.dense_attr_emit_plain
    lib, lib_ids = emit_library_fn(eargs)
    if not torch.equal(lib() * emask[lib_ids, None], want[lib_ids]):
        raise AssertionError(f"{EMIT} [{lvl}]: the library gather "
                             f"disagrees with the plain emit")
    nbytes, flops = _emit_cost(eargs)
    bound, by = _bound_ms(nbytes, flops)
    rec = dict(level=lvl, max_abs_err=err[0], rel_err=err[1],
               ms=k8["ms"], device_ms=k8["device_ms"],
               plain_ms=_median_ms(lambda: plain(*eargs)),
               plain_device_ms=_device_ms(lambda: plain(*eargs)),
               library_ms=_median_ms(lib), library_device_ms=_device_ms(lib),
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    print(f"{EMIT} [{lvl}] in K8's launch: max_abs_err={err[0]:.3e} "
          f"rel={err[1]:.3e} (limit {REL_LIMIT}; 0 on the "
          f"{int((~counted).sum())} uncounted edges) ms={rec['ms']:.4f} "
          f"device_ms={rec['device_ms']:.4f} (the fused launch's) "
          f"plain_ms={rec['plain_ms']:.4f} "
          f"plain_device_ms={rec['plain_device_ms']:.4f} "
          f"library_ms={rec['library_ms']:.4f} "
          f"library_device_ms={rec['library_device_ms']:.4f} "
          f"bound_ms={bound:.6f} ({by}: {nbytes} B, {flops} flop)")
    return rec


def _busy(prof):
    """(device busy ms, [(kernel, ms), ...] by device time) of a profile:
    the device-side kernel and copy rows only. A CPU op's self device time
    repeats the time of the kernels it launched (a ctypes launch inside an
    autograd Function, a GEMM under addmm), and a user annotation's device
    range (``Optimizer.step``) spans kernels listed on their own, so
    summing every row counts them twice."""
    from torch.autograd import DeviceType

    busy = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    busy.sort(key=lambda kv: -kv[1])
    return sum(ms for _, ms in busy), busy


# the name of each wrapper's CUDA kernel in a profile's rows (csrc/*.cu;
# K3's entry points launch K1's and K2's kernels, the bf16 entries the
# same kernels' bf16 instances)
_KEYS32 = {PLANES: "dense_planes_kernel",
           "tcsr_gat_ep_fwd": "tcsr_gat_fwd_kernel",
           "tcsr_gat_ep_bwd": "tcsr_gat_bwd_kernel"}
KERNEL_KEYS = {**_KEYS32, **{n16: _KEYS32.get(n32, f"{n32}_kernel")
                             for n32, n16 in BF16_OF.items()}}
# a bf16 instance's row names its nf type (csrc: bf16_bits)
BF16_ROW = "unsigned short"


def _row_of(name, key) -> bool:
    """Whether a profile row ``key`` is kernel ``name``'s: its CUDA kernel,
    in the instance of its nf type."""
    return (KERNEL_KEYS.get(name, f"{name}_kernel") in key
            and (BF16_ROW in key) == (name in BF16_KERNELS))


def kernel_device_ms(busy, launched):
    """Each port kernel's device ms in a profile's rows ``busy`` (_busy),
    by its CUDA kernel's name, for the kernels that ``launched`` (the
    launch counts of the profiled window; 0.0 for the others, whose
    kernel a sibling entry point may share); raises where a launched
    kernel reads 0 ms, as a renamed kernel would."""
    out = {n: sum(ms for key, ms in busy if _row_of(n, key))
           if launched[n] else 0.0 for n in KERNELS}
    silent = [n for n, c in launched.items() if c and not out[n] > 0]
    if silent:
        raise AssertionError(f"{silent} launched but no profile row of "
                             f"their kernels holds device time")
    return out


def timed_train_step(model, train_np, dev, label: str, loss="mse"):
    """Phases 8, 18, 26 and 27: one finetune train step (batch copy,
    forward, backward, Adam; ``loss`` "mse", "bce" or a callable (out, y,
    mask) -> loss, as make_train_step takes it) of a copy of ``model`` on
    ``train_np``: wall time
    (median of 5 after a warm-up) and the peak of allocated device memory
    over those steps, one step's device busy time and each port kernel's
    device time under the profiler, and the step in stages each ended by a
    synchronize. Returns {wall, busy, kernels, peak_mib}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import _loss_fn, make_train_step
    from fragnet_tpu_torch.train.optim import make_optimizer

    step_model = copy.deepcopy(model)
    step_opt, _ = make_optimizer(step_model.parameters(), "adam", lr=1e-4)
    loss_fn = _loss_fn(loss)
    step = make_train_step(step_model, step_opt, loss_fn, dev)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(train_np)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(train_np)
        torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    dev_busy, busy = _busy(prof)
    wall = statistics.median(walls[1:])
    ours = kernel_device_ms(busy, launched)
    print(f"train step [{label}] (batch copy, forward, backward, "
          f"Adam): wall {wall:.2f} ms (median of 5 after warm-up), peak "
          f"allocated {peak_mib:.1f} MiB, device "
          f"busy {dev_busy:.3f} ms ({100 * dev_busy / wall:.1f}%) in "
          f"{len(busy)} kernel kinds; the port's kernels: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in ours.items())
          + "; top: " + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:10]))
    # the same step in stages, each ended by a synchronize (host clock)
    stages = {"copy": [], "forward+loss": [], "backward": [], "adam": []}
    step_model.train()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = to_device(train_np, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        value = loss_fn(step_model(b), b.y, b.graph_mask)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        value.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step_opt.step()
        step_opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(dt * 1e3)
    print(f"train step stages [{label}] (host clock to a "
          f"synchronize, median of 5): "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms"
                      for k, v in stages.items()))
    return {"wall": wall, "busy": dev_busy, "kernels": ours,
            "peak_mib": peak_mib}


def train_grads_card_vs_cpu(model, train_np, dev, loss: str = "mse"):
    """Phases 9, 18 and 26: one train step's loss (``loss`` "mse" or
    "bce") and every parameter's gradient of ``model`` on ``train_np``, on
    the card (kernels) and on the CPU (plain versions), dropout off.
    Returns (loss cpu, loss card, worst relative diff, its name, number of
    parameters)."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import LOSSES

    def loss_and_grads(d):
        m_d = copy.deepcopy(model).to(d).eval()  # dropout off
        b_d = to_device(train_np, d)
        value = LOSSES[loss](m_d(b_d), b_d.y, b_d.graph_mask)
        value.backward()
        return float(value.detach()), {
            n: (None if p.grad is None else p.grad.detach().cpu())
            for n, p in m_d.named_parameters()}

    l_gpu, g_gpu = loss_and_grads(dev)
    l_cpu, g_cpu = loss_and_grads(torch.device("cpu"))
    worst, worst_name = _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu)
    return l_cpu, l_gpu, worst, worst_name, len(g_cpu)


def plane_calls(graphs, batch_size: int, dev):
    """The plane builder's calls on one packed batch of ``batch_size``
    molecules (``graphs`` repeated as needed), decoded on the card: [(level,
    args, host planes)] for the bond (R=1), fconn (R=6) and atom (R=0)
    levels, with the host builder's planes of the same batch (pad_batch)."""
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import _DP_TM, unpack_batch
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for

    rep = graphs * (-(-batch_size // len(graphs)))
    spec = spec_for(rep, batch_size=batch_size, tcsr=True)
    loader = BatchLoader(rep, batch_size, spec=spec, with_targets=True,
                         pack=True)
    buf = next(iter(loader))
    host = pad_batch(next(loader._windows()), spec, with_targets=True)
    fields = unpack_batch(torch.from_numpy(buf).to(dev), loader.layout,
                          planes=())
    out = []
    for lvl, src_f, dst_f, mask_f, ea_f, n_nodes, _tn in loader.layout.dp_specs:
        if lvl in PLANE_LEVELS:
            args = (getattr(fields, src_f), getattr(fields, dst_f),
                    getattr(fields, mask_f),
                    getattr(fields, ea_f) if ea_f else None, n_nodes,
                    getattr(fields, _DP_TM[lvl]))
            out.append((PLANE_LEVELS[lvl], args, getattr(host, lvl)))
    if sorted(o[0] for o in out) != sorted(PLANE_LEVELS.values()):
        raise AssertionError(f"batch {batch_size}: device planes for "
                             f"{[o[0] for o in out]} only")
    return out, int(host.graph_mask.sum())


def planes_library_fn(args):
    """One PyTorch call's worth of the same function (zeros, then one
    accumulating index_put_ on indices computed beforehand) — the
    yardstick, used nowhere in the port."""
    import torch

    from fragnet_tpu_torch.ops.dense_gat import _plane_edges

    src, dst, emask, ea, n_nodes, meta = args
    tn = meta.tn
    R = 0 if ea is None else ea.shape[1]
    k, t, di, sj = _plane_edges(src, dst, emask, n_nodes, meta)
    vals = torch.ones((k.shape[0], R + 1), device=src.device)
    if R:
        vals[:, 1:] = ea[k]
    r = torch.arange(R + 1, device=src.device)[None, :]
    idx = (t[:, None], r, di[:, None], sj[:, None])
    shape = (n_nodes // tn, R + 1, tn, tn)
    return lambda: torch.zeros(shape, device=src.device).index_put_(
        idx, vals, accumulate=True).view(shape[0], (R + 1) * tn, tn)


def check_planes(calls):
    """Phase 10: the plane builder against its plain version and the host
    builder (exact), timed as phase 4 times the GAT kernels, with the
    library call's time. Returns the per-level report."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.ops import dense_gat

    k6 = dense_gat.build_dense_planes_device
    plain = dense_gat.build_dense_planes_device_plain
    per_level = []
    for lvl, args, host in calls:
        got, want = k6(*args), plain(*args)
        lib = planes_library_fn(args)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()),
                  float(np.abs(got.cpu().numpy() - host).max()),
                  float((lib() - got).abs().max()))
        ms = _median_ms(lambda: k6(*args))
        plain_ms = _median_ms(lambda: plain(*args))
        lib_ms = _median_ms(lib)
        dev_ms = _device_ms(lambda: k6(*args))
        plain_dev_ms = _device_ms(lambda: plain(*args))
        lib_dev_ms = _device_ms(lib)
        nbytes, flops = _planes_cost(args)
        bound, by = _bound_ms(nbytes, flops)
        print(f"{PLANES} [{lvl}] planes={'x'.join(map(str, got.shape))} "
              f"kept edges={int((args[2] > 0).sum())}: max_abs_err={err:.3e} "
              f"(vs plain, host builder and library call; limit 0) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"device_ms={dev_ms:.4f} plain_device_ms={plain_dev_ms:.4f} "
              f"library_device_ms={lib_dev_ms:.4f} bound_ms={bound:.5f} "
              f"({by}: {nbytes} B, {flops} flop)")
        if err != 0.0:
            raise AssertionError(f"{PLANES} [{lvl}] is not exact: {err}")
        per_level.append(dict(level=lvl, max_abs_err=err, rel_err=0.0, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                              library_device_ms=lib_dev_ms, bound_ms=bound,
                              bound_by=by, bytes=nbytes, flops=flops,
                              on_path=lvl in PLANES_ON_PATH))
    return per_level


def pretrain_expect(popt, pgraphs, n_epochs: int, n_validations: int):
    """Each kernel's launches on ``run_pretrain``'s packed path under the
    run's kernel policy, derived from the loaders: the train steps are the
    first (shuffled) epoch's windows, replayed each epoch by the packed
    caches, and the process stream's epochs have the same count here (one
    epoch, from epoch 0's shuffle). A decoded train batch carries device
    planes for the levels of the layout's dp_specs that the policy reads,
    a validation batch its host planes (both checked here); every batch
    runs its passes as ``expected_launches`` counts them (the pretrain head
    reads x_atoms, the pooled x_frags of the last layer and the bond
    features e_edge, so the backward is that of finetuning). K6 runs only
    in train steps, once per plane level of the decoded batch: the
    validation batches come with host planes. Returns (counts, train steps
    per epoch, validation batches, the decoded batches' plane levels)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import plane_levels
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.model.layers import KernelPolicy
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import split_graphs

    seed, bs = int(popt.seed), int(popt.pretrain.batch_size)
    L = int(popt.pretrain.model.num_layer)
    policy = resolve_kernel_policy(popt.pretrain)
    train_g, val_g = split_graphs(pgraphs, seed)
    spec = spec_for(pgraphs, batch_size=bs, tcsr=True)
    probe = BatchLoader(train_g, bs, spec=spec, with_targets=True, pack=True)
    next(iter(probe))
    levels = [d[0] for d in probe.layout.dp_specs
              if d[0] in plane_levels(policy)]
    if policy == KernelPolicy() and levels != ["dp_bond", "dp_fc"]:
        raise AssertionError(f"device planes for {levels} only")
    n_train = len(list(BatchLoader(train_g, bs, spec=spec, shuffle=True,
                                   seed=seed)._windows()))
    val_w = list(BatchLoader(val_g, bs, spec=spec)._windows())
    val_have = []
    for w in val_w:
        have = _planes_of(pad_batch(w, spec, with_targets=True))
        if not {"dp_bond", "dp_fc"} <= have:
            raise AssertionError("a validation batch has no host planes")
        val_have.append(have)
    steps = n_epochs * n_train
    expect = expected_launches(
        policy, L, [(set(levels), steps, steps)]
        + [(h, n_validations, 0) for h in val_have])
    expect[PLANES] = len(levels) * steps
    expect.update(logit_expect(expect))
    return expect, n_train, len(val_w), levels


def drive_pretrain(popt, pgraphs, expect, tier: str):
    """Run run_pretrain on the card with every launch count set to 0 just
    before it; its printed tier, finite losses and each kernel's launches,
    the logit kernels' among them, against ``expect``. Returns (launches,
    checkpoint path)."""
    import contextlib
    import io

    import numpy as np

    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.pretrain import run_pretrain

    n_epochs = int(popt.pretrain.n_epochs)
    text = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        best, ckpt = run_pretrain(popt, device="cuda", graphs=pgraphs)
    run_s = time.perf_counter() - t0
    launches = {**_launches(), **_logit_launches()}
    print(text.getvalue().rstrip())
    scal = read_scalars(popt.exp_dir)
    losses = [r["value"] for r in scal if r["tag"] == "train/loss"][-n_epochs:]
    vals = [r["value"] for r in scal if r["tag"] == "val/loss"][-n_epochs:]
    eps = [r["value"] for r in scal
           if r["tag"] == "train/edges_per_sec"][-n_epochs:]
    print(f"pretraining path [{tier}]: {n_epochs} epochs, run {run_s:.2f} s, "
          f"train losses {[round(x, 5) for x in losses]}, val losses "
          f"{[round(x, 5) for x in vals]}, best {best:.5f}")
    print("train message-edges/s per epoch: "
          + ", ".join(f"{x / 1e6:.4f}M" for x in eps))
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches.items()))
    if f"packed {tier}" not in text.getvalue():
        raise AssertionError(f"run_pretrain did not report the {tier} tier")
    if len(losses) != n_epochs or len(vals) != n_epochs \
            or not np.isfinite(losses + vals).all():
        raise AssertionError(f"pretraining is not finite: train {losses}, "
                             f"val {vals}")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the pretraining "
                                 f"path [{tier}], expected {expect[n]}")
    return launches, ckpt


def pretrain_big_batch(pgraphs, dev):
    """(packed buffer on ``dev``, its layout): one batch at the pretrain
    config's batch_size 512 of the pretrain graphs, repeated to fill it."""
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    big_bs = int(PT_CONFIG["pretrain"]["batch_size"])
    rep = pgraphs * (-(-big_bs // len(pgraphs)))
    big = BatchLoader(rep, big_bs, spec=spec_for(rep, big_bs, tcsr=True),
                      with_targets=True, pack=True)
    return torch.from_numpy(next(iter(big))).to(dev), big.layout


# the kernels phase 13 also holds against their plain versions and times
# at the batch-512 pretraining shapes
BIG_KERNELS = ("tcsr_gat_fwd", "tcsr_gat_bwd", "dense_gat_fwd",
               "dense_gat_bwd")


def pretrain_kernel_calls(popt, model, buf, layout, rng):
    """K1's, K2's, K4's and K5's inputs at the batch-512 pretraining
    shapes: {kernel: [(level, args, kwargs)]} from layer 0 of one forward of
    the pretrain ``model`` on the packed ``buf`` decoded on its device (K6
    planes) — the TCSR forward's atom and frag calls and the dense
    forward's bond and fconn calls, and the backward kernels' arguments
    built from them as phase 4 builds them. Levels are tagged "batch
    512"."""
    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)

    batch = add_planes(unpack_batch(buf, layout, planes=()), layout,
                       plane_levels(model.policy))
    was = model.training
    model.eval()
    calls = layer0_kernel_calls(int(popt.pretrain.model.num_layer), model,
                                batch)
    model.train(was)
    out = {}
    for name in BIG_KERNELS:
        fwd = KERNELS[name].fwd
        out[name] = [(f"{lvl}, batch 512",
                      a if fwd is None else bwd_kernel_args(fwd, a, kw, rng),
                      kw if fwd is None else {})
                     for lvl, a, kw in calls[fwd or name]]
    return out


def pretrain_logit_calls(popt, model, buf, layout):
    """[(level, (nf, ea, a, Da))]: the logit forward kernel's calls in layer
    0 of one forward of the pretrain ``model`` on the packed ``buf``
    decoded on its device (K6 planes), one a GAT pass (LOGIT_LEVELS),
    tagged "batch 512"."""
    import torch

    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)
    from fragnet_tpu_torch.ops import gat_logits

    batch = add_planes(unpack_batch(buf, layout, planes=()), layout,
                       plane_levels(model.policy))
    seen, orig = [], gat_logits.gat_logits_fwd

    def rec(nf, ea, a, Da):
        seen.append((nf, ea, a, Da))
        return orig(nf, ea, a, Da)

    was = model.training
    model.eval()
    gat_logits.gat_logits_fwd = rec
    try:
        with torch.no_grad():
            model(batch)
    finally:
        gat_logits.gat_logits_fwd = orig
        model.train(was)
    n = len(LOGIT_LEVELS)
    if len(seen) != n * int(popt.pretrain.model.num_layer):
        raise AssertionError(f"gat_logits_fwd: {len(seen)} calls in one "
                             f"forward")
    return [(f"{lvl}, batch 512", c) for lvl, c in zip(LOGIT_LEVELS,
                                                       seen[:n])]


def _ulps(got, want):
    """The largest |got - want| in ulps of ``want`` in its type (f32: 24
    bits, bf16: 8)."""
    import torch

    if want.numel() == 0:
        return 0.0
    bits = 24 if want.dtype == torch.float32 else 8
    w = want.double()
    _, e = torch.frexp(w)
    return float(((got.double() - w).abs()
                  / torch.ldexp(torch.ones_like(w), e - bits)).max())


def _rows_ms(fn, n: int = 50, tries: int = 5):
    """{profile row: device ms a call} of ``n`` calls of ``fn`` (_busy's
    rows), a profile with no device time taken again, as _device_ms
    does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total, rows = _busy(prof)
        if total > 0:
            return {k: ms / n for k, ms in rows}
    raise AssertionError(f"the profiler recorded no device time in {tries} "
                         f"profiles of {n} calls")


def check_logit_kernels(calls, rng):
    """Phase 13: the logit kernels at each level of ``calls``
    (pretrain_logit_calls). The forward against gat_logits_plain (the f64
    einsums, on the card), the backward (with its d_vec sum) against
    gat_logits_bwd_plain and against autograd of gat_logits_plain, for
    cotangents drawn with numpy: every output within one ulp of its type.
    Each wrapper's and its plain version's ms and device ms, the backward's
    device ms split between its two kernels, and each kernel's bound from
    the bytes the rows need (f64 operations at F64_FLOPS). Returns
    {kernel: (per-level report, 0.0)} for LOGIT_KERNELS."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.ops import gat_logits as gl

    report = {n: [] for n in LOGIT_KERNELS}
    for lvl, call in calls:
        nf, ea, a, Da = (t.detach() if isinstance(t, torch.Tensor) else t
                         for t in call)
        H = a.shape[0]
        dev = a.device

        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)

        d_wn = None if nf is None else draw(nf.shape[0], 2 * H)
        d_wea = None if ea is None else draw(ea.shape[0], H)
        sets = [(x, dw) for x, dw in ((nf, d_wn), (ea, d_wea))
                if x is not None]
        # the row sets' bytes, their terms' bytes, their multiply-adds (a
        # node row's element meets 2 vectors, an edge row's H)
        x_b = sum(x.numel() * x.element_size() for x, _ in sets)
        w_b = sum(4 * dw.numel() for _, dw in sets)
        macs = sum(x.numel() * (2 if x is nf else H) for x, _ in sets)
        n_part = gl._sets(nf, ea, a, Da)[2]

        got = [t for t in gl.gat_logits_fwd(nf, ea, a, Da) if t is not None]
        want = [t for t in gl.gat_logits_plain(nf, ea, a, Da)
                if t is not None]
        d_got = [t for t in gl.gat_logits_bwd(nf, ea, a, Da, d_wn, d_wea)
                 if t is not None]
        d_plain = [t for t in gl.gat_logits_bwd_plain(nf, ea, a, Da, d_wn,
                                                      d_wea)
                   if t is not None]
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (a, nf, ea) if t is not None]
        it = iter(leaves)
        a_l = next(it)
        nf_l = next(it) if nf is not None else None
        ea_l = next(it) if ea is not None else None
        outs = [t for t in gl.gat_logits_plain(nf_l, ea_l, a_l, Da)
                if t is not None]
        cots = [dw for _, dw in sets]
        d_auto = list(torch.autograd.grad(outs, leaves, cots,
                                          retain_graph=True))
        torch.cuda.synchronize()
        # d_vec's output is d_a, the first of the backward's; the row
        # gradients are the backward kernel's own
        pairs = {"fwd": list(zip(got, want)),
                 "bwd": list(zip(d_got[1:], d_plain[1:]))
                 + list(zip(d_got[1:], d_auto[1:])),
                 "dvec": [(d_got[0], d_plain[0]), (d_got[0], d_auto[0])]}
        ulps = {k: max(_ulps(g, w) for g, w in p) for k, p in pairs.items()}
        errs = {k: max(float((g.float() - w.float()).abs().max())
                       if w.numel() else 0.0 for g, w in p)
                for k, p in pairs.items()}

        fwd = lambda: gl.gat_logits_fwd(nf, ea, a, Da)
        bwd = lambda: gl.gat_logits_bwd(nf, ea, a, Da, d_wn, d_wea)
        fwd_plain = lambda: gl.gat_logits_plain(nf, ea, a, Da)
        bwd_plain = lambda: torch.autograd.grad(outs, leaves, cots,
                                                retain_graph=True)
        rows = _rows_ms(bwd)
        split = {n: sum(ms for k, ms in rows.items() if f"{n}_kernel" in k)
                 for n in ("gat_logits_bwd", "gat_logits_dvec")}
        if not all(v > 0 for v in split.values()):
            raise AssertionError(f"gat_logits_bwd [{lvl}]: a kernel of the "
                                 f"backward holds no device time: {rows}")
        ms, plain_ms = {}, {}
        ms["fwd"], plain_ms["fwd"] = (_median_ms(fwd),
                                      _median_ms(fwd_plain))
        ms["bwd"], plain_ms["bwd"] = (_median_ms(bwd),
                                      _median_ms(bwd_plain))
        dev_ms = {"fwd": _device_ms(fwd), "bwd": split["gat_logits_bwd"],
                  "dvec": split["gat_logits_dvec"]}
        plain_dev = {"fwd": _device_ms(fwd_plain),
                     "bwd": _device_ms(bwd_plain)}
        a_b = 4 * a.numel()
        cost = {"fwd": (x_b + w_b + a_b, 2 * macs),
                # rows read and their gradient written, the cotangents
                # read, the per-block partials of d_vec written
                "bwd": (2 * x_b + w_b + a_b + 8 * n_part, 4 * macs),
                "dvec": (8 * n_part + a_b, n_part)}
        shape = " + ".join("x".join(str(s) for s in x.shape) for x, _ in sets)
        for key, name in (("fwd", "gat_logits_fwd"),
                          ("bwd", "gat_logits_bwd"),
                          ("dvec", "gat_logits_dvec")):
            nbytes, flops = cost[key]
            bound, by = _bound_ms(nbytes, flops, F64_FLOPS)
            rec = dict(level=lvl, rows=shape, max_abs_err=errs[key],
                       max_ulps=ulps[key], device_ms=dev_ms[key],
                       bound_ms=bound, bound_by=by, bytes=nbytes,
                       flops=flops,
                       # the backward wrapper launches the d_vec sum too:
                       # its host-clock ms and its plain version are the
                       # backward's
                       ms=ms.get(key), plain_ms=plain_ms.get(key),
                       plain_device_ms=plain_dev.get(key))
            report[name].append(rec)
            print(f"{name} [{lvl}] rows {shape} (Da {Da}): max_abs_err="
                  f"{errs[key]:.3e} max_ulps={ulps[key]:.2f} (limit 1) "
                  + (f"ms={ms[key]:.4f} plain_ms={plain_ms[key]:.4f} "
                     f"plain_device_ms={plain_dev[key]:.4f} "
                     if key in ms else "")
                  + f"device_ms={dev_ms[key]:.4f} bound_ms={bound:.5f} "
                  f"({by}: {nbytes} B, {flops} flop)")
        if max(ulps.values()) > 1.0:
            raise AssertionError(f"gat_logits [{lvl}] differs from the f64 "
                                 f"einsums by more than one ulp: {ulps}")
    return {n: (levels, 0.0) for n, levels in report.items()}


def pretrain_step_profile(popt, calls_buf, dev, names, label: str):
    """One pretrain train step at batch 512 from the packed buffer
    ``calls_buf`` on the card under ``popt``'s kernel policy: wall time
    (median of 5 after a warm-up) and one step's device busy time, top ops,
    the plane builder's share and the device time of the kernels ``names``,
    printed. Returns (model, optimizer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.optim import make_optimizer
    from fragnet_tpu_torch.train.pretrain import (build_pretrain_model,
                                                  make_pretrain_step)

    buf, layout = calls_buf
    model = build_pretrain_model(
        popt, policy=resolve_kernel_policy(popt.pretrain),
        generator=torch.Generator().manual_seed(0)).to(dev)
    opt, _ = make_optimizer(model.parameters(), "adam", lr=1e-4)
    step = make_pretrain_step(model, opt, layout=layout, device=dev)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(buf)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[1:])
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(buf)
        torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    dev_busy, busy = _busy(prof)
    all_ms = kernel_device_ms(busy, launched)
    k6_ms = all_ms[PLANES]
    ours = {n: all_ms[n] for n in names}
    print(f"pretrain step at batch 512 [{label} policy] (packed buffer on "
          f"the card: unpack, planes, forward, backward, Adam): wall "
          f"{wall:.2f} ms (median of 5 after warm-up), device busy "
          f"{dev_busy:.3f} ms ({100 * dev_busy / wall:.1f}%) in {len(busy)} "
          f"kernel kinds; plane builder {k6_ms:.3f} ms "
          f"({100 * k6_ms / max(dev_busy, 1e-9):.1f}% of "
          f"busy); " + ", ".join(f"{n} {ms:.3f}" for n, ms in ours.items())
          + "; top: " + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:10]))
    return model, opt


def timed_pretrain_step(popt, calls_buf, dev):
    """Phase 13: one pretrain train step at batch 512 from a packed buffer
    on the card — pretrain_step_profile, then the step in stages each
    ended by a synchronize; then K1, K2, K4 and K5 against their plain
    versions at this step's layer-0 inputs, timed as in phase 4, and the
    logit kernels at its four passes (check_logit_kernels). Returns their
    per-level reports ({kernel: (levels, 0.0)}: K1, K2, K4 and K5's, the
    logit kernels')."""
    import torch

    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)
    from fragnet_tpu_torch.train.pretrain import pretrain_loss

    buf, layout = calls_buf
    model, opt = pretrain_step_profile(popt, calls_buf, dev, GAT_KERNELS,
                                       "default")
    levels = plane_levels(model.policy)
    stages = {"unpack (no planes)": [], "K6 planes": [], "forward+loss": [],
              "backward": [], "adam": []}
    model.train()
    for _ in range(5):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        b = unpack_batch(buf, layout, planes=())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        b = add_planes(b, layout, levels)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss = pretrain_loss(model(b), b)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, z in zip(stages, t, t[1:]):
            stages[k].append((z - a) * 1e3)
    print("pretrain step stages (host clock to a synchronize, median of 5): "
          + ", ".join(f"{k} {statistics.median(v):.2f} ms"
                      for k, v in stages.items()))
    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    calls = pretrain_kernel_calls(popt, model, buf, layout, rng)
    report = check_kernels(BIG_KERNELS, calls, rng)
    print(f"K1, K2, K4 and K5 at batch 512 (capture, check against plain, "
          f"timing): "
          f"{time.perf_counter() - t0:.1f} s of phase 13")
    t0 = time.perf_counter()
    logit_report = check_logit_kernels(
        pretrain_logit_calls(popt, model, buf, layout), rng)
    print(f"the logit kernels at batch 512 (capture, check against plain, "
          f"timing): {time.perf_counter() - t0:.1f} s of phase 13")
    return report, logit_report


def pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev):
    """Phases 14 and 19: one pretrain step's loss and gradients under the
    run's kernel policy — on the card from the packed buffer (decoded
    there, K6 planes), on the CPU from the unpacked host batch with host
    planes; the same weights (the pretraining run's checkpoint), dropout
    off."""
    import copy as _copy

    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import plane_levels, unpack_batch
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.train.checkpoint import load_params
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import (build_pretrain_model,
                                                  pretrain_loss, split_graphs)

    bs = int(popt.pretrain.batch_size)
    train_g, _ = split_graphs(pgraphs, int(popt.seed))
    spec = spec_for(pgraphs, batch_size=bs, tcsr=True)
    loader = BatchLoader(train_g, bs, spec=spec, with_targets=True, pack=True)
    buf = next(iter(loader))
    host = pad_batch(next(loader._windows()), spec, with_targets=True)
    model = load_params(build_pretrain_model(
        popt, policy=resolve_kernel_policy(popt.pretrain)), ckpt).eval()

    def loss_and_grads(d, packed):
        m = _copy.deepcopy(model).to(d)
        if packed:
            b = unpack_batch(torch.from_numpy(buf).to(d), loader.layout,
                             plane_levels(m.policy))
        else:
            b = to_device(host, d)
        loss = pretrain_loss(m(b), b)
        loss.backward()
        return float(loss.detach()), {
            n: (None if p.grad is None else p.grad.detach().cpu())
            for n, p in m.named_parameters()}

    l_gpu, g_gpu = loss_and_grads(dev, packed=True)
    l_cpu, g_cpu = loss_and_grads(torch.device("cpu"), packed=False)
    return _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu)


def _grad_diff(l_cpu, l_gpu, g_cpu, g_gpu):
    """(worst relative diff, its name): the loss against its own value,
    each gradient against its own scale — a gradient at round-off level (≤
    1e-6 of the model's largest) against that level."""
    scale = max(float(g.abs().max()) for g in g_cpu.values() if g is not None)
    worst, worst_name = abs(l_gpu - l_cpu) / abs(l_cpu), "loss"
    for n, gc in g_cpu.items():
        gg = g_gpu[n]
        if (gc is None) != (gg is None):
            raise AssertionError(f"{n}: gradient on one device only")
        if gc is None:
            continue
        rel = float((gg - gc).abs().max()) / max(float(gc.abs().max()),
                                                 1e-6 * scale)
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


def pretrain_phases(dev, pending, datasets):
    """Phases 10-15: the pretraining path. ``pending`` is the PretrainGraphs
    featurizing the config's synthetic set. Returns (the plane builder's
    per-level report, each kernel's launches on the pretraining path, the
    graphs, the BIG_KERNELS' per-level reports at batch 512, the logit
    kernels' at batch 512)."""
    import torch

    from fragnet_tpu_torch.train.finetune import run_finetune

    popt = pt_opt(PT_OVERRIDES)
    pgraphs = pending.get()
    print(f"pretrain featurization: ready {time.perf_counter() - pending.t0:.2f}"
          f" s after its start, beside phases 3-9 ({len(pgraphs)} graphs, "
          f"{pending.workers} processes)")

    # ---- 10. the plane builder at batch 512 -------------------------------
    t0 = time.perf_counter()
    big_bs = int(PT_CONFIG["pretrain"]["batch_size"])
    calls, n_mols = plane_calls(pgraphs, big_bs, dev)
    print(f"plane builder check at batch {big_bs} ({n_mols} molecules):")
    k6_report = check_planes(calls)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # ---- 11. the pretraining path: HBM packed tier ------------------------
    t0 = time.perf_counter()
    n_epochs = int(popt.pretrain.n_epochs)
    expect, n_train, n_val, _ = pretrain_expect(popt, pgraphs, n_epochs,
                                                n_epochs)
    print(f"pretraining path: {n_train} train steps/epoch, {n_val} val "
          f"batches/epoch at batch {popt.pretrain.batch_size}")
    launches, ckpt = drive_pretrain(popt, pgraphs, expect, "HBM")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- 12. the process-stream tier, one epoch ---------------------------
    t0 = time.perf_counter()
    sopt = pt_opt(PT_OVERRIDES, STREAM_OVERRIDES)
    s_expect = pretrain_expect(sopt, pgraphs, 1, 1)[0]
    drive_pretrain(sopt, pgraphs, s_expect, "process stream")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # ---- 13. one train step at batch 512 from a packed buffer -------------
    t0 = time.perf_counter()
    big_report, logit_report = timed_pretrain_step(
        popt, pretrain_big_batch(pgraphs, dev), dev)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # ---- 14. one pretrain step's gradients: card vs CPU -------------------
    t0 = time.perf_counter()
    worst, worst_name = pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev)
    print(f"pretrain step cpu vs gpu (packed + K6 planes on the card, host "
          f"planes on the CPU): worst relative diff {worst:.3e} "
          f"({worst_name}) (limit {GRAD_REL_LIMIT}); phase 14: "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU pretrain gradients disagree")

    # ---- 15. the encoder transfer into finetuning -------------------------
    t0 = time.perf_counter()
    fopt = smoke_opt()
    for k, v in {"pretrain.use": True, "pretrain.chk": ckpt,
                 "exp_dir": os.path.join(REPO, "exps",
                                         "chip_smoke_transfer")}.items():
        fopt.set_path(k, v)
    _rmse, ft_model = run_finetune(fopt, quiet=True, datasets=datasets,
                                   device="cuda")
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    enc = {k: v for k, v in ft_model.state_dict().items()
           if k.startswith("pretrain.")}
    bad = [k for k, v in enc.items() if not torch.equal(v.cpu(), sd[k])]
    print(f"transfer: {len(enc)} encoder tensors of the finetune model equal "
          f"the pretrain checkpoint's: {not bad}; phase 15: "
          f"{time.perf_counter() - t0:.1f} s")
    if bad or not enc:
        raise AssertionError(f"encoder transfer differs at {bad[:5]}")
    return k6_report, launches, pgraphs, big_report, logit_report


def _attr_calls(fwd, rng):
    """{kernel: [(level, args, kwargs)]} for K7 and K8 (with K9 in its
    launch) from K7's calls ``fwd``: the backward's arguments as phase 4
    builds them (the forward kernel's out, m, den and a seeded
    cotangent)."""
    if fwd[1][1][0].is_contiguous():
        raise AssertionError("the fconn adjacency is not the strided view "
                             "of the R=6 planes")
    bwd = [(lvl, bwd_kernel_args("dense_attr_fwd", a, kw, rng), {})
           for lvl, a, kw in fwd]
    return {"dense_attr_fwd": fwd, "dense_attr_bwd": bwd}


def attr_kernel_calls(n_tasks, batch, rng):
    """Phase 16's inputs at the finetune batch: {kernel: [(level, args,
    kwargs)]} for K7 and K8 — layer 0's dense-attr calls of one forward
    of the esol-config model under the dense-attr policy on ``batch``
    (atom, fconn, frag) and a seeded case per level (_attr_calls)."""
    import torch

    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model

    aopt = smoke_opt(attr=True)
    model = build_model(aopt, n_classes=n_tasks,
                        policy=resolve_kernel_policy(aopt.finetune),
                        generator=torch.Generator().manual_seed(0))
    model = model.to(batch.x_atoms.device).eval()
    fwd = layer0_kernel_calls(int(aopt.finetune.model.num_layer), model,
                              batch,
                              names=("dense_attr_fwd",))["dense_attr_fwd"]
    return _attr_calls(fwd + [seeded_attr_call(c, rng) for c in fwd], rng)


def pretrain_attr_kernel_calls(calls_buf, dev, rng):
    """Phase 16's inputs at the batch-512 pretraining shapes: K7's and K8's
    arguments (_attr_calls) from layer 0's dense-attr calls (atom,
    fconn, frag) of one forward of the pretrain model under the dense-attr
    policy (phase 19's config) on the batch-512 packed buffer ``calls_buf``
    (pretrain_big_batch) decoded on the card with K6 planes at every level
    the policy reads. Levels are tagged "batch 512"."""
    import torch

    from fragnet_tpu_torch.data.packing import (add_planes, plane_levels,
                                                unpack_batch)
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import build_pretrain_model

    popt = pt_opt(PT_OVERRIDES, ATTR_PT_OVERRIDES)
    model = build_pretrain_model(
        popt, policy=resolve_kernel_policy(popt.pretrain),
        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    buf, layout = calls_buf
    batch = add_planes(unpack_batch(buf, layout, planes=()), layout,
                       plane_levels(model.policy))
    fwd = layer0_kernel_calls(int(popt.pretrain.model.num_layer), model,
                              batch,
                              names=("dense_attr_fwd",))["dense_attr_fwd"]
    return _attr_calls([(f"{lvl}, batch 512", a, kw) for lvl, a, kw in fwd],
                       rng)


def finetune_expect(fopt, datasets, spec, test_windows):
    """Each kernel's launches on ``run_finetune``'s path for ``fopt`` (its
    model_version, kernel policy and epochs; 0 epochs is the prediction
    path), derived
    from the loaders: under finetune.cache=auto the loaders are cached on
    the device, so every epoch runs the train batches of the first
    (shuffled) pass and the val batches, and the test batches run once;
    each batch's passes are counted by ``expected_launches`` from the host
    planes it carries (no plane builder). Returns (counts, train batches,
    val batches, batches without atom, frag or fconn planes)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    ft = fopt.finetune
    n_epochs, seed = int(ft.n_epochs), int(fopt.seed)
    bs, L = int(ft.batch_size), int(ft.model.num_layer)
    train_g, val_g, _test_g, n_tasks, _task = datasets
    first = list(BatchLoader(train_g, bs, spec=spec, shuffle=True, seed=seed,
                             n_tasks=n_tasks)._windows())
    val_w = list(BatchLoader(val_g, bs, spec=spec, n_tasks=n_tasks)._windows())
    batches = []
    for ws, n_fwd, n_steps in ((first, n_epochs, n_epochs),
                               (val_w, n_epochs, 0), (test_windows, 1, 0)):
        for w in ws:
            batches.append((_planes_of(pad_batch(w, spec, n_tasks=n_tasks)),
                            n_fwd, n_steps))
    lacking = sum(1 for have, _, _ in batches
                  if not {"dp_atom", "dp_frag", "dp_fc"} <= have)
    return (expected_launches(resolve_kernel_policy(ft), L, batches,
                              fopt.get("model_version", "gat2")),
            len(first), len(val_w), lacking)


def finetune_attr_path(datasets, spec, test_windows):
    """Phase 17: run_finetune on cuda for 3 epochs under the dense-attr
    policy, every launch count set to 0 just before it; each kernel's
    launches against the count derived from the loaders' batches (the
    cached train batches of the first pass, replayed each epoch, the val
    batches each epoch, the test batches once) and the planes each batch
    carries (finetune_expect). Returns (launches, the trained model)."""
    import numpy as np

    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import run_finetune

    aopt = smoke_opt(train=True, attr=True)
    n_epochs = int(aopt.finetune.n_epochs)
    expect, n_train, n_val, lacking = finetune_expect(aopt, datasets, spec,
                                                      test_windows)
    print(f"dense-attr finetune path: "
          f"{resolve_kernel_policy(aopt.finetune)}; {n_train} train, "
          f"{n_val} val, {len(test_windows)} test batches, {lacking} "
          f"without atom, frag or fconn planes")
    if any(expect[n] == 0 for n in ATTR_KERNELS):
        raise AssertionError(f"no dense-attr launch expected: {expect}")
    _reset_launches()
    t0 = time.perf_counter()
    rmse, model = run_finetune(aopt, datasets=datasets, device="cuda")
    run_s = time.perf_counter() - t0
    launches = _launches()
    scal = read_scalars(aopt.exp_dir)
    losses = [r["value"] for r in scal if r["tag"] == "train/loss"][-n_epochs:]
    eps = [r["value"] for r in scal
           if r["tag"] == "train/edges_per_sec"][-n_epochs:]
    print(f"dense-attr training path: test rmse {rmse:.5f}, train losses "
          f"{[round(x, 5) for x in losses]}, run {run_s:.2f} s; train "
          f"message-edges/s per epoch: "
          + ", ".join(f"{x / 1e6:.4f}M" for x in eps))
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches.items()))
    if len(losses) != n_epochs or not np.isfinite(losses).all() \
            or not np.isfinite(rmse):
        raise AssertionError(f"dense-attr training is not finite: losses "
                             f"{losses}, test rmse {rmse}")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the dense-attr "
                                 f"training path, expected {expect[n]}")
    return launches, model


def attr_phases(dev, datasets, spec, windows, batch, train_np, step_default,
                pgraphs, rng):
    """Phases 16-19: the dense-attr kernel policy. Returns (K7-K9's kernel
    report (K9's from K8's launch), with the batch-512 levels marked off the kernels' line sums,
    launches on the finetune path, launches on the pretraining path, phase
    18's timed train step)."""
    # ---- 16. K7, K8 (and K9 in it) against their plain versions ----------
    t0 = time.perf_counter()
    calls = attr_kernel_calls(datasets[3], batch, rng)
    big_buf = pretrain_big_batch(pgraphs, dev)
    big = pretrain_attr_kernel_calls(big_buf, dev, rng)
    for name in ATTR_KERNELS:
        calls[name] += big[name]
    report = check_kernels(ATTR_KERNELS, calls, rng)
    if EMIT not in report:
        raise AssertionError("no report of K8's d_wea")
    for per_level, _err in report.values():
        for p in per_level:
            # the batch-512 levels stand beside the finetune layer's in the
            # kernel's line; its ms and bound stay the finetune layer's
            p["on_path"] = "batch 512" not in p["level"]
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # ---- 17. the finetune training path under the dense-attr policy -------
    t0 = time.perf_counter()
    launches_ft, model = finetune_attr_path(datasets, spec, windows)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # ---- 18. one dense-attr train step: time, and gradients card vs CPU ---
    t0 = time.perf_counter()
    step_attr = timed_train_step(model, train_np, dev, "dense-attr policy")
    print(f"train step, dense-attr vs default policy: wall "
          f"{step_attr['wall']:.2f} / {step_default['wall']:.2f} ms, device "
          f"busy {step_attr['busy']:.3f} / {step_default['busy']:.3f} ms; "
          "per kernel (ms, dense-attr / default): "
          + ", ".join(f"{n} {step_attr['kernels'][n]:.3f} / "
                      f"{step_default['kernels'][n]:.3f}" for n in KERNELS))
    l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
        model, train_np, dev)
    print(f"dense-attr train step cpu vs gpu: loss {l_cpu:.6f} / "
          f"{l_gpu:.6f}; worst relative diff {worst:.3e} ({worst_name}) "
          f"over {n_par} parameters (limit {GRAD_REL_LIMIT}); phase 18: "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU dense-attr gradients disagree")

    # ---- 19. the pretraining path under the dense-attr policy -------------
    t0 = time.perf_counter()
    popt = pt_opt(PT_OVERRIDES, ATTR_PT_OVERRIDES)
    expect, n_train, n_val, levels = pretrain_expect(popt, pgraphs, 1, 1)
    print(f"dense-attr pretraining path: {n_train} train steps, {n_val} val "
          f"batches at batch {popt.pretrain.batch_size}; device planes per "
          f"train step: {levels} (K6 {len(levels)} launches per step)")
    if any(expect[n] == 0 for n in ATTR_KERNELS):
        raise AssertionError(f"no dense-attr launch expected: {expect}")
    launches_pt, ckpt = drive_pretrain(popt, pgraphs, expect, "HBM")
    pretrain_step_profile(popt, big_buf, dev, GAT_KERNELS + ATTR_KERNELS,
                          "dense-attr")
    worst, worst_name = pretrain_grads_card_vs_cpu(popt, pgraphs, ckpt, dev)
    print(f"dense-attr pretrain step cpu vs gpu (packed + K6 planes on the "
          f"card, host planes on the CPU): worst relative diff {worst:.3e} "
          f"({worst_name}) (limit {GRAD_REL_LIMIT}); phase 19: "
          f"{time.perf_counter() - t0:.1f} s")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU dense-attr pretrain gradients "
                             "disagree")
    return report, launches_ft, launches_pt, step_attr


EP_SHARDS = 2
DIST_TIMEOUTS = {"dist.timeout_s": 120, "dist.join_timeout_s": 600}


def dist_opt(mode: str, n_ranks: int, n_epochs: int):
    """The smoke's training config under ``dist.mode=mode`` over
    ``n_ranks`` ranks for ``n_epochs`` epochs, in its own exp_dir."""
    opt = smoke_opt(train=True)
    for k, v in {"dist.mode": mode, "dist.n_devices": n_ranks,
                 "finetune.n_epochs": n_epochs, **DIST_TIMEOUTS,
                 "exp_dir": os.path.join(REPO, "exps",
                                         f"chip_smoke_{mode}{n_ranks}")
                 }.items():
        opt.set_path(k, v)
    return opt


def ep_spec(datasets, bs: int, n_ranks: int, tn: int = 128, te: int = 256):
    """run_finetune's spec under dist.mode=ep on the card."""
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    train_g, val_g, test_g, _, _ = datasets
    return spec_for(train_g + val_g + test_g, batch_size=bs,
                    multiple=max(tn, te) * n_ranks)


def ep_expect(opt, datasets, n_ranks: int):
    """Each kernel's launches in every rank of run_finetune under
    dist.mode=ep, derived from its loaders: the train loader's shuffle
    advances two epochs in the width probe (pin_ep_widths) and one for the
    init batch, so training runs epochs 3.. of it; every rank runs every
    batch. K3's forward runs all four levels of every layer per forward,
    its backward every layer's bond, atom and fconn pass and the last
    layer's frag pass per train step (the earlier frag outputs are off the
    loss's path); nothing else launches."""
    from fragnet_tpu_torch.data.batcher import BatchLoader

    ft = opt.finetune
    bs, L, seed = int(ft.batch_size), int(ft.model.num_layer), int(opt.seed)
    train_g, val_g, test_g, n_tasks, _ = datasets
    spec = ep_spec(datasets, bs, n_ranks)
    tl = BatchLoader(train_g, bs, spec=spec, shuffle=True, seed=seed)
    for _ in range(3):
        list(tl._windows())
    steps = sum(len(list(tl._windows())) for _ in range(int(ft.n_epochs)))
    fwds = (steps + int(ft.n_epochs) * len(list(BatchLoader(
        val_g, bs, spec=spec)._windows()))
        + len(list(BatchLoader(test_g, bs, spec=spec)._windows())))
    out = {n: 0 for n in KERNELS}
    out["tcsr_gat_ep_fwd"] = 4 * L * fwds
    out["tcsr_gat_ep_bwd"] = (3 * L + 1) * steps
    return out, steps


def dp_expect(opt, datasets, spec, n_ranks: int):
    """Each rank's kernel launches in run_finetune under dist.mode=dp,
    derived from its DPBatchLoaders (the init batch takes the train
    loader's first shuffle; no cache, so every epoch re-windows): every
    micro-batch counted by ``expected_launches`` from the planes it
    carries. Returns ([counts per rank], train steps)."""
    from fragnet_tpu_torch.dist.data_parallel import (DPBatchLoader,
                                                      stack_for_dp)

    ft = opt.finetune
    bs, L, seed = int(ft.batch_size), int(ft.model.num_layer), int(opt.seed)
    n_epochs = int(ft.n_epochs)
    train_g, val_g, test_g, n_tasks, _ = datasets
    tl = DPBatchLoader(train_g, bs, n_ranks, spec, shuffle=True, seed=seed)
    tl.windows()
    train_w = [w for _ in range(n_epochs) for w in tl.windows()]
    val_w = DPBatchLoader(val_g, bs, n_ranks, spec).windows()
    test_w = DPBatchLoader(test_g, bs, n_ranks, spec).windows()
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    policy = resolve_kernel_policy(ft)
    out = []
    for r in range(n_ranks):
        def planes(w):
            return _planes_of(stack_for_dp(w, n_ranks, spec, r,
                                           n_tasks=n_tasks))
        batches = ([(planes(w), 1, 1) for w in train_w]
                   + [(planes(w), n_epochs, 0) for w in val_w]
                   + [(planes(w), 1, 0) for w in test_w])
        out.append(expected_launches(policy, L, batches))
    return out, len(train_w)


def _rank_launches(report):
    """A rank report's launches (by launcher symbol) by KERNELS name."""
    return {n: report["launches"].get(_counter(n)[1].symbol, 0)
            for n in KERNELS}


def drive_dist(opt, datasets, expects, label: str, backend: str):
    """run_finetune under opt's dist.mode on the card, every count in this
    process set to 0 just before it: each rank's losses and test RMSE
    finite and equal across the ranks, its launches equal to ``expects``
    [rank], its backend ``backend``. Several ranks run in spawned
    processes, so this one launches nothing; one runs here. Returns [each
    rank's launches]."""
    import numpy as np

    from fragnet_tpu_torch.train.finetune import run_finetune

    reports = []
    _reset_launches()
    t0 = time.perf_counter()
    rmse, _model = run_finetune(opt, datasets=datasets, device="cuda",
                                rank_reports=reports)
    run_s = time.perf_counter() - t0
    out = check_rank_reports(opt, reports, expects, label)
    first = reports[0]
    if rmse != first["value"] or first["backend"] != backend or (
            len(reports) > 1 and any(_launches().values())):
        raise AssertionError(f"{label}: backend {first['backend']}, or the "
                             f"launching process ran kernels or returned "
                             f"another value")
    print(f"{label}: {len(reports)} ranks over {first['backend']}, run "
          f"{run_s:.2f} s (spawn and rank start-up included)")
    return out


def check_rank_reports(opt, reports, expects, label: str):
    """Each rank's report of a run_finetune under opt's dist.mode: its
    losses and test metric finite and equal across the ranks, its
    launches equal to ``expects[rank]``. Returns [each rank's launches]."""
    import numpy as np

    out = []
    for r in reports:
        got = _rank_launches(r)
        exp = expects[r["rank"]]
        print(f"{label} rank {r['rank']} ({r['backend']}, {r['device']}): "
              f"test rmse {r['value']:.6f}, train losses "
              f"{[round(x, 6) for x in r['train_loss']]}, val "
              f"{[round(x, 6) for x in r['val_score']]}; kernels: "
              + " ".join(f"{n}={c} (expected {exp[n]})"
                         for n, c in got.items() if c or exp[n]))
        vals = r["train_loss"] + r["val_score"] + [r["value"]]
        if not np.isfinite(vals).all() or len(r["train_loss"]) != int(
                opt.finetune.n_epochs):
            raise AssertionError(f"{label} rank {r['rank']} is not finite: "
                                 f"{vals}")
        for n, c in got.items():
            if c != exp[n]:
                raise AssertionError(f"{label} rank {r['rank']}: {n} launched "
                                     f"{c} times, expected {exp[n]}")
        out.append(got)
    first = reports[0]
    for r in reports[1:]:
        if (r["value"], r["train_loss"], r["val_score"]) != (
                first["value"], first["train_loss"], first["val_score"]):
            raise AssertionError(f"{label}: ranks disagree")
    return out


def seeded_ep_graph(rng, n_nodes: int, n_edges: int, tn: int, te: int):
    """A seeded graph at one level's EP shapes (the caller's node and edge
    slots) whose kept edges reach both shards: 3/4 of the slots real edges
    sorted by destination over every tile, sources within half a tile of
    their destination, a tenth of them masked; the rest padding. Shard 1
    then starts about two thirds into the nodes, so its grid offset t0 is
    above 0 and K3's offset arithmetic carries real edges. Returns src,
    dst and mask as numpy arrays, and the EPTileMeta."""
    import numpy as np

    from fragnet_tpu_torch.ops.tcsr import build_ep_tile_meta

    n_real = 3 * n_edges // 4
    src = np.zeros(n_edges, np.int32)
    dst = np.zeros(n_edges, np.int32)
    mask = np.zeros(n_edges, np.float32)
    dst[:n_real] = np.sort(rng.integers(0, n_nodes, n_real))
    src[:n_real] = np.clip(dst[:n_real] + rng.integers(-tn // 2, tn // 2 + 1,
                                                        n_real),
                           0, n_nodes - 1)
    mask[:n_real] = rng.random(n_real) > 0.1
    meta = build_ep_tile_meta(src, dst, mask, n_nodes, EP_SHARDS, tn=tn,
                              te=te)
    es = n_edges // EP_SHARDS
    if meta is None or not all(mask[r * es:(r + 1) * es].any()
                               for r in range(EP_SHARDS)) or not (
            meta.t0[1:] > 0).all():
        raise AssertionError(f"the seeded EP graph ({n_nodes} nodes, "
                             f"{n_edges} edges) does not reach every shard "
                             f"at a grid offset above 0")
    return src, dst, mask, meta


def ep_kernel_calls(captured, rng):
    """Phase 20's inputs: {kernel: [(level, args, kwargs)]} — each rank's
    layer-0 K3 forward calls (bond, atom, fconn, frag) captured in phase
    22's ranks (the smoke's batch packs real edges first, so shard 1 holds
    only padding there); per level, a seeded case for each shard at the
    level's shapes on a seeded graph whose kept edges reach both shards,
    with shard 1's grid at t0 > 0 (seeded_ep_graph); and the backward's
    arguments: the forward's max (0 on empty rows) as m, numpy cotangents
    dU, dV."""
    import dataclasses

    import numpy as np
    import torch

    from fragnet_tpu_torch.ops import tcsr_gat

    def draw(*shape, dev):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    fwd = []
    for rank, calls in enumerate(captured):
        for lvl, (args, kw) in zip(EP_LEVELS, calls):
            pad = "" if bool((args[5] > 0).any()) else ", padding only"
            fwd.append((f"{lvl}, shard {rank}{pad}", tuple(args), kw))
    for lvl, (args, kw) in zip(EP_LEVELS, captured[0]):
        wn, nf, w_ea, src_c, _d, _m, meta_c = args[:7]
        dev = nf.device
        src, dst, mask, meta = seeded_ep_graph(
            rng, nf.shape[0], EP_SHARDS * src_c.shape[0], meta_c.tn,
            meta_c.te)
        meta = dataclasses.replace(meta, **{
            f: torch.from_numpy(getattr(meta, f)).to(dev)
            for f in ("t0", "ew_blk", "sw_tile", "flat_slot", "cw")})
        wn_s = draw(*wn.shape, dev=dev)
        nf_s = draw(*nf.shape, dev=dev).to(nf.dtype)
        es = src_c.shape[0]
        for r in range(EP_SHARDS):
            sl = slice(r * es, (r + 1) * es)
            fwd.append((
                f"{lvl}, seeded, shard {r} (t0 {int(meta.t0[r, 0])}, grid "
                f"{meta.n_tiles_grid} tiles)",
                (wn_s, nf_s, draw(es, w_ea.shape[1], dev=dev),
                 *(torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
                   for a in (src, dst, mask)), meta, r) + tuple(args[8:]),
                kw))
    bwd = []
    for lvl, a, kw in fwd:
        out, m, _den = tcsr_gat.tcsr_gat_ep_fwd(*a, **kw)
        m = torch.where(m <= -1e29, torch.zeros_like(m), m)
        bwd.append((lvl, tuple(a[:8]) + (m, draw(*out.shape, dev=out.device),
                                         draw(*m.shape, dev=m.device))
                    + tuple(a[8:]), kw))
    return {"tcsr_gat_ep_fwd": fwd, "tcsr_gat_ep_bwd": bwd}


def check_ep_scales(name, lvl, args, got, want):
    """Phase 20's hold on its cases' data: a shard that keeps no edge must
    give the empty result exactly, and every output of every other case
    must have a nonzero scale (beside the m = −1e30 empty-row marker), so
    that no comparison there is 0 against 0."""
    import torch

    if not bool((args[5] > 0).any()):
        if not all(torch.equal(k_, p) for k_, p in zip(got, want)):
            raise AssertionError(f"{name} [{lvl}]: a shard with no kept edge "
                                 f"does not give the empty result")
        return
    for i, p in enumerate(want):
        live = p[p > -1e29]
        if live.numel() == 0 or float(live.abs().max()) == 0.0:
            raise AssertionError(f"{name} [{lvl}]: output {i} is all zero, so "
                                 f"its comparison shows nothing")


def bf16_dist_opt(mode: str, n_ranks: int):
    """dist_opt(mode, n_ranks, ...) in bf16 for BF16_REST_EPOCHS epochs, in
    its own exp_dir (phase 31 (e))."""
    opt = dist_opt(mode, n_ranks, BF16_REST_EPOCHS)
    opt.set_path("finetune.dtype", "bf16")
    opt.set_path("exp_dir", os.path.join(REPO, "exps",
                                         f"chip_smoke_{mode}{n_ranks}_bf16"))
    return opt


def segment_ep_opts(n_ranks: int):
    """The segment EP mode's two run_finetune configs, one epoch each, in
    their own exp_dirs: dist.tcsr=false, and the K3 mode with tiles whose
    pins fail (tn 24 does not divide the node counts, multiples of
    max(tn, te)·S = 512), which falls back to the segment mode."""
    segopt = dist_opt("ep", n_ranks, 1)
    segopt.set_path("dist.tcsr", False)
    pinopt = dist_opt("ep", n_ranks, 1)
    pinopt.set_path("dist.tile_tn", 24)
    for opt, name in ((segopt, "segment"), (pinopt, "pins_fail")):
        opt.set_path("exp_dir", os.path.join(
            REPO, "exps", f"chip_smoke_ep{n_ranks}_{name}"))
    return segopt, pinopt


def dist_ranks(calls):
    """``calls`` [(fn, args)] in one start of EP_SHARDS ranks on the card
    (dist/checks.py:timed_calls_rank): for each call, ([each rank's
    result], the slowest rank's seconds)."""
    from fragnet_tpu_torch.dist import checks
    from fragnet_tpu_torch.dist.launch import run_ranks

    res = run_ranks(checks.timed_calls_rank, EP_SHARDS, (calls,),
                    device="cuda", timeout_s=120, join_timeout_s=600,
                    workdir=os.path.join(REPO, "exps"))
    return [([r[i][0] for r in res], max(r[i][1] for r in res))
            for i in range(len(calls))]


def ep_dp_phases(dev, datasets, spec, train_np, step_default, rng):
    """Phases 20-24: edge-partitioned and data-parallel finetuning on
    torch.distributed. Returns (K3's kernel report, {path: [launches per
    rank]}, phase 31 (e)'s bf16 results from the same ranks)."""
    import dataclasses

    import torch

    from fragnet_tpu_torch.dist import checks
    from fragnet_tpu_torch.dist.data_parallel import (DPBatchLoader,
                                                      stack_for_dp)
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.ops.tcsr import build_tile_meta
    from fragnet_tpu_torch.train.finetune import _finetune_rank
    from fragnet_tpu_torch.train.loop import mse_loss

    topt = smoke_opt(train=True)
    train_g, _val_g, _test_g, n_tasks, _ = datasets
    bs = int(topt.finetune.batch_size)
    S = EP_SHARDS
    kw, sd = smoke_weights(datasets)
    plain_np, ep_np, espec = ep_train_batch(datasets)
    runs = {}

    # ---- 20 + 22. one EP train step on 2 ranks (layer 0's K3 inputs) ------
    # the same ranks then run phase 31 (e)'s bf16 EP step and bf16 EP
    # finetune path, and the segment mode's step and finetune paths
    # (dist.tcsr=false; tiles whose K3 pins fail) — a new start of the
    # ranks costs seconds
    t0 = time.perf_counter()
    eopt16 = bf16_dist_opt("ep", S)
    segopt, pinopt = segment_ep_opts(S)
    ((res, _), (res16, step16_s), (ep16, run16_s), (seg, seg_step_s),
     (seg_run, seg_run_s), (pin_run, pin_run_s)) = dist_ranks([
        (checks.ep_card_step_rank, (kw, sd, ep_np)),
        (checks.ep_card_step_rank, (dict(kw, dtype=torch.bfloat16), sd,
                                    ep_np)),
        (_finetune_rank, (eopt16.to_dict(), True, datasets, "cuda")),
        (checks.ep_card_step_rank, (kw, sd, plain_np, False)),
        (checks.ep_finetune_rank, (segopt.to_dict(), datasets, "cuda")),
        (checks.ep_finetune_rank, (pinopt.to_dict(), datasets, "cuda"))])
    step_s = time.perf_counter() - t0
    seg_s = seg_step_s + seg_run_s + pin_run_s
    bf16 = {"ep_steps": res16, "ep_run": (eopt16, ep16),
            "ep_s": step16_s + run16_s}
    print(f"phase 22's EP step on {S} ranks (spawn included), which captures "
          f"phase 20's inputs: {step_s - bf16['ep_s'] - seg_s:.1f} s (and "
          f"phase 31 (e)'s bf16 EP step {step16_s:.1f} s and bf16 EP "
          f"finetune path {run16_s:.1f} s, the segment mode's step "
          f"{seg_step_s:.1f} s and finetune paths {seg_run_s:.1f} s "
          f"(dist.tcsr=false) and {pin_run_s:.1f} s (failed pins) in the "
          f"same ranks)")
    t0 = time.perf_counter()
    report = check_kernels(EP_KERNELS, ep_kernel_calls(
        [r["calls"] for r in res], rng), rng, check_scales=check_ep_scales)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # ---- 21. the EP finetune path, 2 ranks on one card over gloo ---------
    t0 = time.perf_counter()
    eopt = dist_opt("ep", S, int(topt.finetune.n_epochs))
    expect, steps = ep_expect(eopt, datasets, S)
    print(f"EP finetune path: {S} ranks, {steps} train steps, "
          f"spec {espec.n_atoms}/{espec.n_edges}/{espec.n_bg_edges} atom/"
          f"bond/bond-graph edge slots")
    runs["finetune_ep"] = drive_dist(eopt, datasets, [expect] * S,
                                     "EP finetune", "gloo")
    # the segment mode (run in phase 22's ranks): no kernel launches
    none = {n: 0 for n in KERNELS}
    for key, opt_, reports, reason in (
            ("finetune_ep_segment", segopt, seg_run, "dist.tcsr=false"),
            ("finetune_ep_pins_fail", pinopt, pin_run,
             "EP tile-meta probe failed")):
        label = f"EP segment finetune ({reason})"
        runs[key] = check_rank_reports(opt_, reports, [none] * S, label)
        printed = reports[0]["printed"]
        if f"ep fused kernel off: {reason}" not in printed \
                or "ep fused kernel active" in printed \
                or not reports[0]["finite"]:
            raise AssertionError(f"{label}: rank 0 printed {printed!r}")
        print(f"{label}: rank 0 printed "
              f"{[ln for ln in printed.splitlines() if 'ep fused' in ln]}")
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")

    # ---- 22. EP gradients vs the single-device card step -------------------
    t0 = time.perf_counter()
    ref_np = dataclasses.replace(plain_np, **{
        lvl: build_tile_meta(s_, d_, m_, n_, tn=128, te=256) for lvl, (
            s_, d_, m_, n_) in {
            "tm_atom": (plain_np.edge_src, plain_np.edge_dst,
                        plain_np.edge_mask, espec.n_atoms),
            "tm_bond": (plain_np.bg_src, plain_np.bg_dst, plain_np.bg_mask,
                        espec.n_edges),
            "tm_frag": (plain_np.frag_src, plain_np.frag_dst,
                        plain_np.fconn_mask, espec.n_frags),
            "tm_fc": (plain_np.fc_src, plain_np.fc_dst, plain_np.fc_mask,
                      espec.n_fconn)}.items()})
    model = build_model_cpu(topt, n_tasks).to(dev).eval()
    b = to_device(ref_np, dev)
    pred, attn = model(b, return_attentions=True)
    loss_t = mse_loss(pred, b.y, b.graph_mask)
    loss_t.backward()
    loss = float(loss_t.detach())
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for n, p in model.named_parameters()}
    k3 = [_counter(n)[1].symbol for n in EP_KERNELS]
    # the logit kernels: once a pass forward, once a pass's backward (and
    # its d_vec sum), in both modes
    logit_sym = _logit_symbols()
    L = int(topt.finetune.model.num_layer)
    n_bwd = sum(gat_levels(topt.model_version, L)[0].values())
    logit_want = {"gat_logits_fwd": L * len(EP_LEVELS),
                  "gat_logits_bwd": n_bwd, "gat_logits_dvec": n_bwd}
    for mode, steps in (("fused (K3)", res), ("segment", seg)):
        worst, worst_name = 0.0, ""
        for r in steps:
            pairs = [("pred", r["pred"], pred.detach().cpu())] + [
                (f"attn {k}", r["attn"][k], getattr(attn, k).cpu())
                for k in r["attn"]] + [
                (n, torch.zeros_like(g) if r["grads"][n] is None
                 else r["grads"][n], g) for n, g in grads.items()]
            for name, got, want in pairs:
                rel = float((got - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                if rel > worst:
                    worst, worst_name = rel, name
            if abs(r["loss"] - loss) > GRAD_REL_LIMIT * loss:
                raise AssertionError(f"EP {mode} loss {r['loss']} vs {loss}")
            n_k3 = sum(r["launches"].get(sym, 0) for sym in k3)
            logits = {n: 0 for n in logit_want}
            for sym, c in r["launches"].items():
                if sym in logit_sym:
                    logits[logit_sym[sym]] += c
            others = sum(c for sym, c in r["launches"].items()
                         if sym not in k3 and sym not in logit_sym)
            if (n_k3 == 0) == (steps is res) or others:
                raise AssertionError(f"EP {mode} step launched {n_k3} K3 and "
                                     f"{others} other kernels")
            if logits != logit_want:
                raise AssertionError(f"EP {mode} step launched the logit "
                                     f"kernels {logits}, expected "
                                     f"{logit_want}")
        print(f"EP {mode} step vs single-device card step (same batch and "
              f"weights, dropout off): loss {steps[0]['loss']:.6f} / "
              f"{loss:.6f}; worst relative diff {worst:.3e} ({worst_name}) "
              f"over the prediction, 4 attention vectors and {len(grads)} "
              f"gradients (limit {GRAD_REL_LIMIT}); K3 launches "
              f"{sum(steps[0]['launches'].get(sym, 0) for sym in k3)}, "
              f"logit kernels {logit_want} a rank's step (forward once a "
              f"pass, {L} layers x {len(EP_LEVELS)} passes)")
        if worst > GRAD_REL_LIMIT:
            raise AssertionError(f"EP {mode} and single-device gradients "
                                 f"disagree")
        for r in steps:
            print(f"EP {mode} train step rank (2 ranks, gloo, one card): "
                  f"wall {r['wall_ms']:.2f} ms (median of 5), device busy "
                  f"{r['busy_ms']:.3f} ms, K3 device "
                  f"{r['k3_device_ms']:.3f} ms, collectives (host) "
                  f"{r['collectives_ms']:.2f} ms; single-device step "
                  f"(phase 8): wall {step_default['wall']:.2f} ms, device "
                  f"busy {step_default['busy']:.3f} ms")
    bf16.update(ep_ref=ref_np, ep_steps32=res)
    print(f"phase 22: {step_s - bf16['ep_s'] + time.perf_counter() - t0:.1f}"
          f" s (the segment mode's runs included)")

    # ---- 23. the DP finetune path, 2 ranks over gloo, and its gradients ----
    t0 = time.perf_counter()
    dopt = dist_opt("dp", S, int(topt.finetune.n_epochs))
    expects, steps = dp_expect(dopt, datasets, spec, S)
    print(f"DP finetune path: {S} ranks, {steps} train steps")
    kw0 = dict(kw, drop_ratio=0.0)
    # one start of the ranks runs the DP finetune path (each rank as the
    # launcher runs it, train/finetune.py:_finetune_rank; phase 24 drives
    # run_finetune's own launch), the DP step and phase 31 (e)'s bf16 DP
    # finetune path
    dopt16 = bf16_dist_opt("dp", S)
    (dp_run, dp_run_s), (dres, _), (dp16, dp16_s) = dist_ranks([
        (_finetune_rank, (dopt.to_dict(), True, datasets, "cuda")),
        (checks.dp_step_rank, (kw0, sd, train_g, spec, bs, 1e-4, "cuda")),
        (_finetune_rank, (dopt16.to_dict(), True, datasets, "cuda"))])
    runs["finetune_dp"] = check_rank_reports(dopt, dp_run, expects,
                                             "DP finetune")
    if [r["backend"] for r in dp_run] != ["gloo"] * S:
        raise AssertionError("DP finetune: not every rank ran over gloo")
    print(f"DP finetune: {S} ranks over gloo, run {dp_run_s:.2f} s in the "
          f"ranks")
    bf16.update(dp_run=(dopt16, dp16), dp_s=dp16_s)
    win = DPBatchLoader(train_g, bs, S, spec).windows()[0]
    mean = {}
    for r in range(S):
        m_r = build_model_cpu(topt, n_tasks).to(dev)
        m_r.load_state_dict(sd)
        m_r.eval()
        b_r = to_device(stack_for_dp(win, S, spec, r, n_tasks=n_tasks), dev)
        mse_loss(m_r(b_r), b_r.y, b_r.graph_mask).backward()
        for n, p in m_r.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            mean[n] = mean.get(n, 0) + g.cpu() / S
    worst, worst_name = 0.0, ""
    for r in dres:
        for n, want in mean.items():
            got = r["grads"][n]
            got = torch.zeros_like(want) if got is None else got
            rel = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, n
    print(f"DP step's averaged gradients vs the mean of the micro-batches' "
          f"single-device card gradients: worst relative diff {worst:.3e} "
          f"({worst_name}) over {len(mean)} parameters (limit "
          f"{GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("DP gradients disagree with the mean")
    print(f"phase 23: {time.perf_counter() - t0 - dp16_s:.1f} s (and phase "
          f"31 (e)'s bf16 DP finetune path {dp16_s:.1f} s in the same ranks)")

    # ---- 24. NCCL at world size 1 ------------------------------------------
    t0 = time.perf_counter()
    e1 = dist_opt("ep", 1, 1)
    runs["finetune_ep_nccl"] = drive_dist(e1, datasets,
                                          [ep_expect(e1, datasets, 1)[0]],
                                          "EP finetune, 1 rank", "nccl")
    e1seg = dist_opt("ep", 1, 1)
    e1seg.set_path("dist.tcsr", False)
    e1seg.set_path("exp_dir", os.path.join(REPO, "exps",
                                           "chip_smoke_ep1_segment"))
    runs["finetune_ep_segment_nccl"] = drive_dist(
        e1seg, datasets, [{n: 0 for n in KERNELS}],
        "EP segment finetune, 1 rank", "nccl")
    d1 = dist_opt("dp", 1, 1)
    runs["finetune_dp_nccl"] = drive_dist(
        d1, datasets, dp_expect(d1, datasets, spec, 1)[0],
        "DP finetune, 1 rank", "nccl")
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return report, runs, bf16


# phase 25: the molecules the interpreter explains — aspirin; benzene (one
# fragment: its one self_cn connection row is unpaired); an ionic mixture
# (its fragments connect through iso_cn3, with no real bond)
INTERP_SMILES = ("CC(=O)Oc1ccccc1C(=O)O", "c1ccccc1", "[Na+].[Cl-].CCO")
INTERP_WEIGHTS = ("atom_weights", "bond_weights", "frag_weights",
                  "fconn_weights")
# each attribution family's result field
INTERP_CONTRIBS = {"atom": "atom_contrib", "bond": "bond_contrib",
                   "fconn": "fconn_contrib", "fragment": "frag_contrib"}


def interp_batches(interp, smiles):
    """(MolGraph, the host batches of ``interp.interpret(smiles)``'s
    forwards: the one-molecule batch, then each family's replica batch)."""
    from fragnet_tpu_torch.interp import attribution

    g = interp.featurize(smiles)[0]
    out = [attribution.pad_graphs([g])]
    for fam, n in attribution.family_sizes(g).items():
        if n > 0:
            out.append(attribution.replica_batch(g, fam, n)[0])
    return g, out


def interp_diffs(got, want):
    """[(vector, max abs diff / scale)] of two InterpResults: the prediction
    against |prediction|, each min-max-scaled weight vector against its
    range (1), each contribution vector against max(|prediction|, max|c|)
    — a contribution is the difference of two near-equal predictions."""
    import numpy as np

    pred = abs(want.prediction)
    out = [("prediction", abs(got.prediction - want.prediction)
            / max(pred, 1e-30))]
    for f in INTERP_WEIGHTS + tuple(INTERP_CONTRIBS.values()):
        g, w = getattr(got, f), getattr(want, f)
        if g.shape != w.shape:
            raise AssertionError(f"{f}: shape {g.shape} vs {w.shape}")
        scale = 1.0 if f in INTERP_WEIGHTS else max(
            pred, float(np.abs(w).max(initial=0.0)), 1e-30)
        out.append((f, float(np.abs(g - w).max(initial=0.0)) / scale))
    return out


def one_at_a_time(interp, g, family, i):
    """(base − prediction with entity i of ``family`` masked in every layer,
    base) on the one-molecule batch, through the reference's hook
    conventions (bond i: rows 2i, 2i+1; connection i: fconn rows 2i,
    2i+1; fragment i: its atoms' zero vector)."""
    import torch

    from fragnet_tpu_torch.interp import attribution
    from fragnet_tpu_torch.model.layers import LayerHooks

    b = attribution.pad_graphs([g])
    if family == "atom":
        h = LayerHooks(atom_mask=i)
    elif family == "bond":
        h = LayerHooks(bond_mask=2 * i)
    elif family == "fconn":
        h = LayerHooks(frag_bond_mask=i)
    else:
        vec = (b.atom_to_frag == i) * b.atom_mask
        h = LayerHooks(atom_zero_vec=torch.as_tensor(
            vec, dtype=torch.float32, device=interp.device))
    base = float(interp.predict(b)[0, 0])
    return base - float(interp.predict(b, h)[0, 0]), base


def interp_phase(ckpt, n_tasks, rng):
    """Phase 25: ``FragNetInterpreter.interpret(s, with_contributions=True)``
    of the esol model with the weights ``ckpt`` (phase 7's ft.ckpt), under
    the default and the dense-attr policy, on the card and on the CPU, for
    each of INTERP_SMILES. Returns (the interp levels of K1 and K4, or K7,
    {path: launches})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.interp.attention import FragNetInterpreter
    from fragnet_tpu_torch.train.checkpoint import load_params
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model

    report, paths = {}, {}
    for attr in (False, True):
        opt = smoke_opt(train=True, attr=attr)
        policy = resolve_kernel_policy(opt.finetune)
        label = "dense-attr" if attr else "default"
        n_layers = int(opt.finetune.model.num_layer)

        def interpreter(device):
            model = build_model(opt, n_classes=n_tasks, policy=policy)
            return FragNetInterpreter(load_params(model, ckpt),
                                      device=device)

        gpu, cpu = interpreter("cuda"), interpreter("cpu")
        graphs, host = {}, {}
        for s in INTERP_SMILES:
            graphs[s], host[s] = interp_batches(gpu, s)
        batches = [b for s in INTERP_SMILES for b in host[s]]
        expect = expected_launches(policy, n_layers,
                                   [(_planes_of(b), 1, 0) for b in batches])
        gpu.interpret(INTERP_SMILES[0])  # warm-up, not counted or timed
        torch.cuda.synchronize()
        _reset_launches()
        results, walls = {}, {}
        for s in INTERP_SMILES:
            t0 = time.perf_counter()
            results[s] = gpu.interpret(s, with_contributions=True)
            torch.cuda.synchronize()
            walls[s] = time.perf_counter() - t0
        launches = _launches()
        paths["interp_attr" if attr else "interp"] = launches
        print(f"interp [{label}] kernels ({len(batches)} forwards): "
              + " ".join(f"{n}={c} (expected {expect[n]})"
                         for n, c in launches.items() if c or expect[n]))
        for n, c in launches.items():
            if c != expect[n]:
                raise AssertionError(f"{n} launched {c} times on the "
                                     f"interpret path, expected {expect[n]}")

        for s in INTERP_SMILES:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                gpu.interpret(s, with_contributions=True)
                torch.cuda.synchronize()
            busy, rows = _busy(prof)
            t0 = time.perf_counter()
            want = cpu.interpret(s, with_contributions=True)
            cpu_s = time.perf_counter() - t0
            name, worst = max(interp_diffs(results[s], want),
                              key=lambda d: d[1])
            g = graphs[s]
            print(f"interp [{label}] {s} ({g.n_atoms} atoms, {g.n_frags} "
                  f"fragments, {g.n_fconn} fconn rows): prediction "
                  f"{results[s].prediction:.6f} (CPU {want.prediction:.6f}); "
                  f"wall {walls[s] * 1e3:.2f} ms (SMILES to result), device "
                  f"busy {busy:.3f} ms in {len(rows)} kernel kinds, CPU "
                  f"{cpu_s * 1e3:.1f} ms; card vs CPU worst {worst:.3e} of "
                  f"scale ({name}; limit {FORWARD_REL_LIMIT})")
            if not worst <= FORWARD_REL_LIMIT:
                raise AssertionError(f"interpret({s!r}) [{label}]: card and "
                                     f"CPU disagree ({name}: {worst:.3e})")

        # two entities of each family against one-at-a-time masked forwards
        s = INTERP_SMILES[0]
        g, res = graphs[s], results[s]
        worst = 0.0
        for fam, field in INTERP_CONTRIBS.items():
            c = getattr(res, field)
            for i in sorted({0, len(c) - 1}):
                want, base = one_at_a_time(gpu, g, fam, i)
                err = abs(float(c[i]) - want) / max(
                    abs(base), float(abs(c).max()), 1e-30)
                worst = max(worst, err)
                if not err <= REL_LIMIT:
                    raise AssertionError(
                        f"{fam} {i} of {s} [{label}]: replica batch "
                        f"{c[i]:.6e} vs one at a time {want:.6e}")
        print(f"interp [{label}] replica batches vs one-at-a-time masked "
              f"forwards on the card ({s}, 2 entities of each family): "
              f"worst {worst:.3e} of scale (limit {REL_LIMIT})")

        # the path's forward kernels at its largest batch: layer 0 of the
        # atom family's replicas of the first molecule
        names = ("dense_attr_fwd",) if attr else ("tcsr_gat_fwd",
                                                  "dense_gat_fwd")
        rb = to_device(host[s][1], gpu.device)
        calls = layer0_kernel_calls(n_layers, gpu.model, rb, names=names)
        tag = f"interp, {g.n_atoms + 1} replicas"
        calls = {n: [(f"{lvl}, {tag}", a, kw) for lvl, a, kw in c]
                 for n, c in calls.items()}
        for name, (levels, _err) in check_kernels(names, calls, rng).items():
            report[name] = levels
    return report, paths


# phase 26: the models on the gat2 encoder (model/transformer.py) at the
# esol config's width; gat2_multitask with configs/ft/clintox.yaml's
# settings, as dotted keys of ESOL_CONFIG (tests/test_torch_transformer.py
# holds them to the file)
FAMILY_VERSIONS = ("gat2_transformer", "gat2_transformer2", "gat2_multitask")
CLINTOX_OVERRIDES = {"finetune.data.name": "clintox",
                     "finetune.target_type": "clsf",
                     "finetune.batch_size": 32}
FAMILY_EPOCHS = 2


def family_opt(mv: str, attr: bool = False):
    """The training path's config (smoke_opt(train=True)) for model_version
    ``mv``: 2 epochs, its own exp_dir, clintox's settings for the
    multi-task model; ``attr``: the dense-attr policy."""
    opt = smoke_opt(train=True, attr=attr)
    tag = "_attr" if attr else ""
    for k, v in {"model_version": mv, "finetune.n_epochs": FAMILY_EPOCHS,
                 **(CLINTOX_OVERRIDES if mv == "gat2_multitask" else {}),
                 "exp_dir": os.path.join(REPO, "exps",
                                         f"chip_smoke_{mv}{tag}")}.items():
        opt.set_path(k, v)
    return opt


def multitask_datasets(datasets, seed: int = 0):
    """Phase 3's graphs with two binary labels each, as a 2-task
    classification set: per split and task a seeded permutation of
    alternating 0 / 1, a fifth of them then set to −1 (missing), so every
    split keeps both classes of every task."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(seed)

    def relabel(graphs):
        n = len(graphs)
        y = np.stack([rng.permutation(np.arange(n) % 2) for _ in range(2)],
                     axis=1).astype(np.float32)
        for t in range(2):
            y[rng.choice(n, n // 5, replace=False), t] = -1.0
        return [dataclasses.replace(g, y=y[i]) for i, g in enumerate(graphs)]

    return (*(relabel(g) for g in datasets[:3]), 2, "clsf")


def _postproc_cost(kind, n_real, e_real, sizes, dims):
    """(bytes, flops) of one forward + backward of a post-processing module
    on this batch's real rows (``n_real`` nodes, ``e_real`` edges,
    ``sizes`` nodes per graph): each input (features, indices, masks,
    weights, the cotangent) read once, each output (features, the input's
    and the weights' gradients) written once; the operations of the
    matmuls (×3: the forward and the backward's two products) and, for
    TransformerConv, of the per-edge dot and weighted sum; elementwise
    work (softmax, LayerNorm, masks) left out. ``dims``: (in width, out
    width) for "conv", (emb, feed-forward width) for "block", (emb, emb)
    for "attn"."""
    d_in, d_out = dims
    attn = 4 * d_in * sum(n * n for n in sizes)  # QK^T and AV per graph
    if kind == "conv":
        w = 4 * (d_in * d_out + d_out)  # lin_query, key, value, skip
        io = n_real * (2 * d_in + 2 * d_out + 1) + 3 * e_real
        return 4 * (io + 2 * w), 3 * (8 * n_real * d_in * d_out
                                      + 4 * e_real * d_out)
    w = 4 * d_in * d_in + 4 * d_in  # qkv_proj, o_proj
    if kind == "block":  # + linear_net, norm1, norm2
        w += 2 * d_in * d_out + d_out + d_in + 4 * d_in
    mm = 2 * n_real * (w - 4 * d_in)  # ≈ 2 · rows · weight count
    return 4 * (n_real * (4 * d_in + 2) + 2 * w), 3 * (mm + attn)


def postproc_ops(tr_model, tr2_model, train_np, dev, rng):
    """The post-processing ops, run as torch ops on the card (no TPU kernel
    exists for them): TransformerConv (gat2_transformer's, shared by both
    levels) at the atom and fragment levels, and one EncoderBlock and its
    MultiheadAttention (gat2_transformer2's first of each level), each
    forward + backward with a numpy cotangent on the encoder's output for
    ``train_np``: device ms per call (profiler), the device kernels it
    launches, event ms (host dispatch included) and the bound. Returns
    [{op, level, calls per step, device_ms, kernels, ms, bound_ms,
    bound_by}]."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.graphs.batch import to_device

    b = to_device(train_np, dev)
    G = b.y.shape[0]
    with torch.no_grad():
        xa, xf, _, _ = tr_model.eval().pretrain(b)
        xa2, xf2, _, _ = tr2_model.eval().pretrain(b)
    n_layers2 = len(tr2_model.transformer.layers)
    conv = tr_model.atom_transformer
    block_a, block_f = (tr2_model.transformer.layers[0],
                        tr2_model.transformer2.layers[0])
    E = xa.shape[1]
    F = block_a.linear_net[0].out_features
    HD = conv.heads * conv.out_channels

    def sizes(batch_ids, mask):
        ids = batch_ids[mask > 0].cpu().numpy()
        return [int(c) for c in np.bincount(ids, minlength=G)]

    atoms = sizes(b.atom_batch, b.atom_mask)
    frags = sizes(b.frag_batch, b.frag_mask)
    cases = [  # (op, level, calls per step, module, args, cost kind,
               #  node mask, edge mask, nodes per graph, dims)
        ("TransformerConv", "atom", 1, conv,
         (xa, b.edge_src, b.edge_dst, b.edge_mask, b.atom_mask), "conv",
         b.atom_mask, b.edge_mask, [], (E, HD)),
        ("TransformerConv", "frag", 1, conv,
         (xf, b.frag_src, b.frag_dst, b.fconn_mask, b.frag_mask), "conv",
         b.frag_mask, b.fconn_mask, [], (E, HD)),
        ("EncoderBlock", "atom", n_layers2, block_a,
         (xa2, b.atom_batch, b.atom_mask, G), "block", b.atom_mask, None,
         atoms, (E, F)),
        ("EncoderBlock", "frag", n_layers2, block_f,
         (xf2, b.frag_batch, b.frag_mask, G), "block", b.frag_mask, None,
         frags, (E, F)),
        ("MultiheadAttention", "atom", n_layers2, block_a.self_attn,
         (xa2, b.atom_batch, b.atom_mask, G), "attn", b.atom_mask, None,
         atoms, (E, E)),
        ("MultiheadAttention", "frag", n_layers2, block_f.self_attn,
         (xf2, b.frag_batch, b.frag_mask, G), "attn", b.frag_mask, None,
         frags, (E, E)),
    ]
    out = []
    for op, level, per_step, mod, args, kind, nmask, emask, seq, dims in \
            cases:
        x = args[0].detach().clone().requires_grad_(True)
        width = mod(x, *args[1:]).shape[1]
        g = torch.from_numpy(rng.standard_normal(
            (x.shape[0], width)).astype(np.float32)).to(dev)

        def call():
            mod(x, *args[1:]).backward(g)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        n = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        busy, _rows = _busy(prof)
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0)
        if not busy > 0:
            raise AssertionError(f"{op} {level}: no device time profiled")
        n_real = int((nmask > 0).sum())
        e_real = int((emask > 0).sum()) if emask is not None else 0
        nbytes, flops = _postproc_cost(kind, n_real, e_real, seq, dims)
        bound, by = _bound_ms(nbytes, flops)
        row = {"op": op, "level": level, "calls_per_step": per_step,
               "device_ms": busy / n, "kernels": launched / n,
               "ms": _median_ms(call, n=20), "bound_ms": bound,
               "bound_by": by, "rows": n_real, "edges": e_real}
        out.append(row)
        print(f"post-processing {op} [{level}] forward + backward "
              f"({n_real} rows{f', {e_real} edges' if e_real else ''}): "
              f"device {row['device_ms']:.4f} ms in {row['kernels']:.0f} "
              f"kernels, events {row['ms']:.4f} ms, bound {bound:.5f} ms "
              f"({by}); {per_step} per train step")
    return out


def family_phase(dev, datasets, spec, windows, batch_np, train_np, rng):
    """Phase 26: gat2_transformer, gat2_transformer2 and gat2_multitask
    through the port's entry points at the esol config's width (the
    multi-task model with clintox's settings on phase 3's graphs
    relabelled by multitask_datasets): per model the prediction and one
    train step's loss and gradients, card (kernels) vs CPU (plain
    versions), same seeded weights and batch; run_finetune for
    FAMILY_EPOCHS epochs with every launch count set to 0 just before it,
    each kernel's launches equal to finetune_expect's and every loss
    finite; a timed train step. gat2_transformer also trains under the
    dense-attr policy (launches exact). Then postproc_ops. Returns
    ({path: launches}, {model: step}, post-processing rows)."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.finetune import run_finetune

    paths, steps, trained = {}, {}, {}
    runs = [(mv, False) for mv in FAMILY_VERSIONS] + [(FAMILY_VERSIONS[0],
                                                       True)]
    for mv, attr in runs:
        t0 = time.perf_counter()
        fopt = family_opt(mv, attr=attr)
        label = mv + (" [dense-attr policy]" if attr else "")
        if mv == "gat2_multitask":
            data = multitask_datasets(datasets)
            fspec, fwin, fbatch_np = smoke_batch(fopt, data)
            loader = BatchLoader(data[0], int(fopt.finetune.batch_size),
                                 spec=fspec, shuffle=True,
                                 seed=int(fopt.seed), n_tasks=data[3])
            ftrain_np = pad_batch(next(iter(loader._windows())), fspec,
                                  n_tasks=data[3])
        else:
            data, fspec, fwin, fbatch_np, ftrain_np = (
                datasets, spec, windows, batch_np, train_np)
        n_tasks, task = data[3], data[4]
        loss = "mse" if task == "regr" else "bce"
        if not attr:
            model = build_model_cpu(fopt, n_tasks).eval()
            card = copy.deepcopy(model).to(dev).eval()
            with torch.no_grad():
                pred_gpu = card(to_device(fbatch_np, dev)).cpu()
                pred_cpu = model(to_device(fbatch_np, "cpu"))
            G = int(fopt.finetune.batch_size)
            if tuple(pred_gpu.shape) != (G, n_tasks):
                raise AssertionError(f"{mv}: prediction shape "
                                     f"{tuple(pred_gpu.shape)}")
            fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
            l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
                model, ftrain_np, dev, loss)
            print(f"{label}: forward cpu vs gpu max_abs_err={fwd_err:.3e} "
                  f"rel={fwd_rel:.3e} (limit {FORWARD_REL_LIMIT}); train "
                  f"step ({loss}) loss {l_cpu:.6f} / {l_gpu:.6f}, worst "
                  f"relative diff {worst:.3e} ({worst_name}) over {n_par} "
                  f"parameters (limit {GRAD_REL_LIMIT})")
            if not fwd_rel <= FORWARD_REL_LIMIT:
                raise AssertionError(f"{mv}: card and CPU predictions "
                                     f"disagree")
            if not worst <= GRAD_REL_LIMIT:
                raise AssertionError(f"{mv}: card and CPU gradients "
                                     f"disagree")
        expect, n_train, n_val, _ = finetune_expect(fopt, data, fspec, fwin)
        _reset_launches()
        t1 = time.perf_counter()
        value, tr_model = run_finetune(fopt, datasets=data, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = _launches()
        paths[f"{mv}{'_attr' if attr else ''}_train"] = launches
        losses = [r["value"] for r in read_scalars(fopt.exp_dir)
                  if r["tag"] == "train/loss"][-FAMILY_EPOCHS:]
        metric = "rmse" if task == "regr" else "roc_auc"
        print(f"{label} training path: {FAMILY_EPOCHS} epochs x {n_train} "
              f"train batches, {n_val} val, {len(fwin)} test; test {metric} "
              f"{value:.5f}, train losses {[round(x, 5) for x in losses]}, "
              f"run {run_s:.2f} s; kernels: "
              + " ".join(f"{n}={c} (expected {expect[n]})"
                         for n, c in launches.items() if c or expect[n]))
        if len(losses) != FAMILY_EPOCHS or not np.isfinite(losses).all() \
                or not np.isfinite(value):
            raise AssertionError(f"{label}: training is not finite: losses "
                                 f"{losses}, test {metric} {value}")
        for n, c in launches.items():
            if c != expect[n]:
                raise AssertionError(f"{label}: {n} launched {c} times on "
                                     f"the training path, expected "
                                     f"{expect[n]}")
        if not attr:
            steps[mv] = timed_train_step(tr_model, ftrain_np, dev, mv, loss)
            trained[mv] = tr_model
        print(f"phase 26, {label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    post = postproc_ops(trained["gat2_transformer"],
                        trained["gat2_transformer2"], train_np, dev, rng)
    for mv, ops in (("gat2_transformer", ("TransformerConv",)),
                    ("gat2_transformer2", ("EncoderBlock",))):
        per_step = sum(r["device_ms"] * r["calls_per_step"] for r in post
                       if r["op"] in ops)
        print(f"{mv} train step: device busy {steps[mv]['busy']:.3f} ms, of "
              f"which its post-processing ({'/'.join(ops)} forward + "
              f"backward, measured alone) {per_step:.3f} ms "
              f"({100 * per_step / steps[mv]['busy']:.1f}%)")
    print(f"phase 26, post-processing: {time.perf_counter() - t0:.1f} s")
    return paths, steps, post


# phase 27: the DTA and CDRP tasks (train/tasks.py:run_task) at the model
# defaults (drug encoder 4 layers, emb 128, 4 heads; the 8-layer, 8-head,
# 128-wide, 512-FFN protein transformer over 1000 positions; gene_dim
# 903), run_task's synthetic sets (n_synthetic 96) at batch 16
TASK_N = 96
TASK_EPOCHS = 2
# gradients that are 0 in exact arithmetic (task_card_vs_cpu), and the
# round-off they may show, of the model's largest gradient (the H100 read
# up to 9.5e-7 over the 8 layers at batch 16, 1000 positions)
ZERO_GRADS = ("attention.self.key.bias",)
ZERO_GRAD_LIMIT = 1e-5


def task_opt(task: str, encoder: str = "transformer", attr: bool = False):
    """run_task's config for ``task``: the model defaults, TASK_EPOCHS
    epochs (1 under the dense-attr policy), its own exp_dir."""
    from fragnet_tpu_torch.config import Config

    tag = ("_cnn" if encoder == "cnn" else "") + ("_attr" if attr else "")
    ft = {"model": {"num_layer": 4, "num_heads": 4, "emb_dim": 128,
                    "drop_ratio": 0.15, "protein_encoder": encoder},
          "batch_size": 16, "lr": 1e-4,
          "n_epochs": 1 if attr else TASK_EPOCHS, "es_patience": 50,
          "data": {"n_synthetic": TASK_N}}
    if attr:
        ft["kernel"] = {"attr": True, "fc": "attr"}
    return Config({"seed": 42, "finetune": ft,
                   "exp_dir": os.path.join(REPO, "exps",
                                           f"chip_smoke_{task}{tag}")})


def _task_chunk(args):
    """Featurize one chunk of a task's rows (a spawned pool's task)."""
    from fragnet_tpu_torch.data.cdrp import build_cdrp_graphs
    from fragnet_tpu_torch.data.dta import build_dta_graphs

    task, rows, genes, seed = args
    if task == "dta":
        return build_dta_graphs(rows, seed=seed)
    return build_cdrp_graphs(rows, genes, seed=seed)


def _row_chunks(rows, n_chunks: int):
    """A column dict cut into ``n_chunks`` column dicts of consecutive
    rows, in order."""
    n = len(rows["y"])
    step = (n + n_chunks - 1) // n_chunks
    return [{k: v[i:i + step] for k, v in rows.items()}
            for i in range(0, n, step)]


class TaskGraphs:
    """``train.tasks.load_task_graphs`` for run_task's synthetic DTA and
    CDRP sets, featurized in ``pending``'s processes behind its own work
    (each molecule alone from the same seed, so the graphs and their order
    are the same); ``get()`` waits for them."""

    def __init__(self, pending, seed: int = 42, n: int = TASK_N):
        from fragnet_tpu_torch.data.cdrp import synthetic_cdrp_dataset
        from fragnet_tpu_torch.data.dta import synthetic_dta_dataset

        dta = synthetic_dta_dataset(n=n, seed=seed)
        cdrp, genes = synthetic_cdrp_dataset(n=n, seed=seed)
        w = pending.workers
        self.t0 = time.perf_counter()
        self._res = {
            "dta": pending.submit(_task_chunk, [
                ("dta", c, None, seed) for c in _row_chunks(dta, w)], "dta"),
            "cdrp": pending.submit(_task_chunk, [
                ("cdrp", c, genes, seed) for c in _row_chunks(cdrp, w)],
                "cdrp")}

    def get(self):
        return {t: [g for part in r.get(timeout=600) for g in part]
                for t, r in self._res.items()}


def task_split(graphs, seed: int = 42):
    """run_task's (train, val, test) graphs."""
    from fragnet_tpu_torch.data.splitters import random_split

    return tuple([graphs[i] for i in idx]
                 for idx in random_split(len(graphs), seed=seed))


def task_batches(opt, graphs):
    """(spec, test windows, a padded train window with padding graphs,
    label mean, label sdev) as run_task makes them."""
    import numpy as np

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for

    bs, seed = int(opt.finetune.batch_size), int(opt.seed)
    train_g, _val_g, test_g = task_split(graphs, seed)
    spec = spec_for(graphs, batch_size=bs, tcsr=True)
    test_w = list(BatchLoader(test_g, bs, spec=spec)._windows())
    train_w = list(BatchLoader(train_g, bs, spec=spec, shuffle=True,
                               seed=seed)._windows())
    window = min(train_w, key=len)
    if len(window) >= bs:
        raise AssertionError("no train batch of the task has a padding "
                             "graph")
    ys = np.array([g.y[0] for g in train_g])
    return (spec, test_w, pad_batch(window, spec), float(ys.mean()),
            float(ys.std()))


def task_card_vs_cpu(model, batch_np, dev, stats, label: str):
    """The prediction and one standardized train step's loss and
    gradients of ``model`` (dropout off) on ``batch_np``, card (kernels)
    vs CPU (plain versions): every value finite, the padding graphs' rows
    included; predictions within 1e-3 of their scale, gradients within
    1e-3 of each one's scale (_grad_diff), except the protein attention's
    key biases: their exact gradient is 0 (a softmax ignores a shift
    common to its row, and the bias shifts every logit of a row by q·b),
    so both devices' values are round-off of sums over B·H·L² terms, and
    each is held to ZERO_GRAD_LIMIT of the largest gradient instead."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.tasks import _label_stats, standardized_loss

    def run(d):
        m_d = copy.deepcopy(model).to(d).eval()
        b_d = to_device(batch_np, d)
        pred = m_d(b_d)
        loss = standardized_loss(pred, b_d.y, b_d.graph_mask,
                                 *_label_stats(*stats, d))
        loss.backward()
        grads = {n: p.grad.detach().cpu()
                 for n, p in m_d.named_parameters() if p.grad is not None}
        return pred.detach().cpu(), float(loss.detach()), grads

    p_gpu, l_gpu, g_gpu = run(dev)
    p_cpu, l_cpu, g_cpu = run(torch.device("cpu"))
    bad = [n for n, g in {"prediction (card)": p_gpu,
                          "prediction (cpu)": p_cpu, **g_gpu,
                          **{f"{n} (cpu)": g for n, g in g_cpu.items()}
                          }.items() if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"{label}: not finite: {bad[:5]}")
    G = batch_np.y.shape[0]
    if tuple(p_gpu.shape) != (G, 1):
        raise AssertionError(f"{label}: prediction shape "
                             f"{tuple(p_gpu.shape)}")
    fwd_err, fwd_rel = _diff(p_gpu, p_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    zero = {n for n in g_cpu if n.endswith(ZERO_GRADS)}
    zero_max = max([float(g[n].abs().max()) / scale for n in zero
                    for g in (g_cpu, g_gpu)] + [0.0])
    worst, worst_name = _grad_diff(
        l_cpu, l_gpu, {n: g for n, g in g_cpu.items() if n not in zero},
        {n: g for n, g in g_gpu.items() if n not in zero})
    n_pad = int((batch_np.graph_mask == 0).sum())
    print(f"{label}: forward cpu vs gpu max_abs_err={fwd_err:.3e} "
          f"rel={fwd_rel:.3e} (limit {FORWARD_REL_LIMIT}; {n_pad} padding "
          f"graphs, every row finite); standardized train step loss "
          f"{l_cpu:.6f} / {l_gpu:.6f}, worst relative diff {worst:.3e} "
          f"({worst_name}) over {len(g_cpu) - len(zero)} parameters (limit "
          f"{GRAD_REL_LIMIT}); the {len(zero)} key-bias gradients (0 in "
          f"exact arithmetic) at most {zero_max:.3e} of the largest on "
          f"either device (limit {ZERO_GRAD_LIMIT})")
    if not fwd_rel <= FORWARD_REL_LIMIT:
        raise AssertionError(f"{label}: card and CPU predictions disagree")
    if not (worst <= GRAD_REL_LIMIT and zero_max <= ZERO_GRAD_LIMIT):
        raise AssertionError(f"{label}: card and CPU gradients disagree")


def _protein_cost(kind, B, L, dims, lengths=None):
    """(bytes, flops) of one forward + backward of a protein encoder on
    (B, L) tokens: the tokens, the weights, the cotangent read once, the
    output and the weights' gradients written once; the operations of the
    matmuls and convolutions (×3: the forward and the backward's two
    products) over all L positions, as the dense masked attention computes
    them, or with ``lengths`` (each row's real residues) over the real
    positions alone: a padded query row never reaches the readout x[:, 0]
    and a masked key adds nothing to it, so a transformer that skipped the
    padding would do Σ L_i of the row-wise work and Σ L_i² of the
    attention's. Elementwise work (softmax, LayerNorm, dropout) left out.
    ``dims``: (layers, emb, heads, feed-forward width, weights) for
    "transformer", (emb, in channels, filters, kernel, out, weights) for
    "cnn", whose padding positions carry token 0's embedding into the
    convolution's input channels, so ``lengths`` does not change it."""
    if kind == "transformer":
        n_layers, E, _H, F, n_w = dims
        rows, pairs = ((B * L, B * L * L) if lengths is None else
                       (sum(lengths), sum(n * n for n in lengths)))
        per_layer = (4 * 2 * rows * E * E         # q, k, v, out projections
                     + 2 * 2 * pairs * E          # QK^T and PV over heads
                     + 2 * 2 * rows * E * F)      # the feed-forward
        flops, out = 3 * n_layers * per_layer, B * E
    else:
        E, c_in, c_out, k, d_out, n_w = dims
        width = E - k + 1
        flops = 3 * (2 * B * c_out * width * c_in * k
                     + 2 * B * c_out * width * d_out)
        out = B * d_out
    return 4 * (B * L + 2 * n_w + 2 * out), flops


def protein_ops(models, batch_np, dev, rng):
    """The protein encoders alone, as torch ops on the card (no TPU kernel
    exists for them), in train mode as in the step: forward + backward of
    ``models`` = {name: (DTAModel, encoder kind)} on the protein tokens of
    ``batch_np`` with a numpy cotangent: device ms per call (profiler),
    device kernels per call, event ms (host dispatch included), the bound
    over all 1000 positions and the bound over each row's real residues
    (_protein_cost). Returns [{op, device_ms, kernels, ms, bound_ms,
    bound_by, real_bound_ms, ...}]."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(batch_np.protein).to(dev)
    B, L = tokens.shape
    # the residues run from position 0 (encode_protein); a padding graph's
    # row has none
    lengths = [int(n) for n in (batch_np.protein != 0).sum(axis=1)]
    out = []
    for name, (model, kind) in models.items():
        m = copy.deepcopy(model).to(dev).train()
        enc = m.encode_target
        width = enc(tokens).shape[1]
        g = torch.from_numpy(rng.standard_normal((B, width)).astype(
            np.float32)).to(dev)
        if kind == "transformer":
            t = m.target_model
            lay = t.encoder.layer[0]
            dims = (len(t.encoder.layer), width, lay.n_heads,
                    lay.intermediate.dense.out_features,
                    sum(p.numel() for p in t.parameters()))
        else:
            dims = (m.embedding_xt.embedding_dim, m.conv_xt_1.in_channels,
                    m.conv_xt_1.out_channels, m.conv_xt_1.kernel_size[0],
                    width, sum(p.numel() for n, p in m.named_parameters()
                               if n.split(".")[0] in ("embedding_xt",
                                                      "conv_xt_1",
                                                      "fc1_xt")))

        def call():
            enc(tokens).backward(g)

        for _ in range(2):
            call()
        torch.cuda.synchronize()
        n = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        busy, rows = _busy(prof)
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0)
        if not busy > 0:
            raise AssertionError(f"{name}: no device time profiled")
        nbytes, flops = _protein_cost(kind, B, L, dims)
        bound, by = _bound_ms(nbytes, flops)
        r_bytes, r_flops = _protein_cost(kind, B, L, dims, lengths)
        r_bound, r_by = _bound_ms(r_bytes, r_flops)
        row = {"op": name, "device_ms": busy / n, "kernels": launched / n,
               "ms": _median_ms(call, n=5, warmup=1), "bound_ms": bound,
               "bound_by": by, "flops": flops, "bytes": nbytes,
               "real_bound_ms": r_bound, "real_bound_by": r_by,
               "real_flops": r_flops}
        out.append(row)
        print(f"protein encoder {name} forward + backward (tokens "
              f"{B}x{L}, train mode): device {row['device_ms']:.3f} ms in "
              f"{row['kernels']:.0f} kernels, events {row['ms']:.3f} ms, "
              f"bound {bound:.4f} ms over all {L} positions ({by}: {flops} "
              f"flop, {nbytes} B; device/bound "
              f"{row['device_ms'] / bound:.1f}x), bound over the real "
              f"residues {r_bound:.4f} ms ({r_by}: {r_flops} flop; "
              f"{sum(lengths)} of {B * L} positions real, lengths "
              f"{min(lengths)}-{max(lengths)}; device/bound "
              f"{row['device_ms'] / r_bound:.1f}x); top: "
              + ", ".join(f"{k[:48]} {ms / n:.3f}" for k, ms in rows[:6]))
    return out


def task_phase(dev, task_graphs, datasets, spec, windows, rng):
    """Phase 27: the DTA and CDRP tasks through run_task on the card
    (TASK_EPOCHS epochs each, DTA also one epoch under the dense-attr
    policy), each kernel's launches equal to finetune_expect's for
    run_task's loaders and every loss and the test RMSE finite; card vs CPU
    for DTA (transformer, and under dense-attr), DTA (CNN) and CDRP on a
    train batch with padding graphs (task_card_vs_cpu); K1 and K4 against
    their plain versions at layer 0 of the DTA batch; run_finetune with
    finetune.standardize=true on the esol config (metric in raw label
    space, launches exact); timed DTA and CDRP train steps with their
    peak memory; the protein encoders alone (protein_ops). Returns
    ({path: launches}, {kernel: report levels} of K1, K2, K4, K5 at the DTA
    batch and K7, K8 (K9) at the DTA batch under dense-attr, {task: step},
    encoder rows)."""
    import pickle

    import numpy as np
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import run_finetune
    from fragnet_tpu_torch.train.tasks import (_label_stats,
                                               build_task_model, run_task,
                                               standardized_loss)

    def std_loss(mean, sdev):
        stats = _label_stats(mean, sdev, dev)
        return lambda out, y, m: standardized_loss(out, y, m, *stats)

    t0 = time.perf_counter()
    graphs = task_graphs.get()
    print(f"task featurization: ready {time.perf_counter() - task_graphs.t0:.2f}"
          f" s after its start, behind the pretrain set's "
          + ", ".join(f"{t} {len(g)} graphs" for t, g in graphs.items()))
    paths, steps, models = {}, {}, {}
    report = {}
    for task, enc, attr in (("dta", "transformer", False),
                            ("dta", "cnn", False), ("cdrp", "", False),
                            ("dta", "transformer", True)):
        t1 = time.perf_counter()
        opt = task_opt(task, enc or "transformer", attr)
        label = (f"{task}{f' ({enc})' if enc else ''}"
                 f"{' [dense-attr policy]' if attr else ''}")
        g = graphs[task]
        tspec, test_w, batch_np, mean, sdev = task_batches(opt, g)
        model = build_task_model(task, opt, g,
                                 policy=resolve_kernel_policy(opt.finetune),
                                 generator=torch.Generator().manual_seed(0))
        task_card_vs_cpu(model, batch_np, dev, (mean, sdev), label)
        if enc == "cnn":  # card vs CPU and a timed step, no run_task
            models["ProteinCNN"] = (model, "cnn")
            steps["dta_cnn"] = timed_train_step(
                model.to(dev), batch_np, dev, label, std_loss(mean, sdev))
            print(f"phase 27, {label}: {time.perf_counter() - t1:.1f} s")
            continue
        if task == "dta":
            # each kernel of the path against its plain version at layer 0
            # of the DTA batch, the backward's arguments as phase 4 makes
            # them
            if not attr:
                models["ProteinTransformer"] = (model, "transformer")
            card = copy.deepcopy(model).to(dev).eval()
            n_layers = int(opt.finetune.model.num_layer)
            b_dev = to_device(batch_np, dev)
            if attr:
                names = ATTR_KERNELS
                calls = _attr_calls(layer0_kernel_calls(
                    n_layers, card, b_dev,
                    names=("dense_attr_fwd",))["dense_attr_fwd"], rng)
            else:
                names = GAT_KERNELS
                calls = layer0_kernel_calls(n_layers, card, b_dev)
                for name in GAT_KERNELS:
                    k = KERNELS[name]
                    if k.fwd is not None:
                        calls[name] = [
                            (lvl, bwd_kernel_args(k.fwd, a, kw, rng), {})
                            for lvl, a, kw in calls[k.fwd]]
            checked = check_kernels(
                names, {n: [(f"{lvl}, dta", a, kw) for lvl, a, kw in c]
                        for n, c in calls.items()}, rng)
            report.update({n: lv for n, (lv, _err) in checked.items()})
        split = task_split(g, int(opt.seed))
        expect, n_train, n_val, lacking = finetune_expect(
            opt, (*split, 1, "regr"), tspec, test_w)
        _reset_launches()
        t2 = time.perf_counter()
        rmse, trained = run_task(task, opt, device="cuda", graphs=g)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t2
        launches = _launches()
        n_epochs = int(opt.finetune.n_epochs)
        print(f"{label} training path: {n_epochs} epochs x {n_train} train "
              f"batches, {n_val} val, {len(test_w)} test ({lacking} without "
              f"atom, frag or fconn planes); test rmse {rmse:.5f}, run "
              f"{run_s:.2f} s; kernels: "
              + " ".join(f"{n}={c} (expected {expect[n]})"
                         for n, c in launches.items() if c or expect[n]))
        if not np.isfinite(rmse):
            raise AssertionError(f"{label}: test rmse {rmse}")
        for n, c in launches.items():
            if c != expect[n]:
                raise AssertionError(f"{label}: {n} launched {c} times on "
                                     f"the training path, expected "
                                     f"{expect[n]}")
        paths[f"{task}{'_attr' if attr else ''}_train"] = launches
        if not attr:
            steps[task] = timed_train_step(trained, batch_np, dev, label,
                                           std_loss(mean, sdev))
        print(f"phase 27, {label}: {time.perf_counter() - t1:.1f} s")

    # run_finetune with finetune.standardize=true (the esol config)
    t1 = time.perf_counter()
    sopt = smoke_opt(train=True)
    for k, v in {"finetune.standardize": True,
                 "finetune.n_epochs": TASK_EPOCHS,
                 "exp_dir": os.path.join(REPO, "exps",
                                         "chip_smoke_esol_std")}.items():
        sopt.set_path(k, v)
    expect = finetune_expect(sopt, datasets, spec, windows)[0]
    _reset_launches()
    value, smodel = run_finetune(sopt, datasets=datasets, device="cuda")
    launches = _launches()
    paths["finetune_standardized_train"] = launches
    with open(os.path.join(sopt.exp_dir, f"preds_seed_{sopt.seed}.pkl"),
              "rb") as f:
        preds = pickle.load(f)
    ys = np.stack([np.asarray(g_.y, np.float32).reshape(-1)[:1]
                   for g_ in datasets[0]])
    mean, sdev = ys.mean(axis=0), ys.std(axis=0) + np.float32(1e-5)
    raw = []
    with torch.no_grad():
        for w in windows:
            out = smodel.eval()(to_device(pad_batch(w, spec,
                                                    n_tasks=datasets[3]),
                                          dev)).cpu().numpy()
            raw.append(out[:len(w)] * sdev + mean)
    # the cached test loader yields its batches in a shuffled order
    raw = np.sort(np.concatenate(raw), axis=0)
    if raw.shape != preds["pred"].shape:
        raise AssertionError(f"standardized finetune: {raw.shape} test "
                             f"predictions, {preds['pred'].shape} written")
    rerr = float(np.abs(raw - np.sort(preds["pred"], axis=0)).max())
    rmse = float(np.sqrt(np.mean((preds["y"] - preds["pred"]) ** 2)))
    print(f"standardized finetune (esol config, {TASK_EPOCHS} epochs): test "
          f"rmse {value:.5f} (from the written predictions {rmse:.5f}); "
          f"the test predictions vs the model's output x "
          f"(sdev + 1e-5) + mean (train labels' mean {float(mean[0]):.4f}, "
          f"sdev {float(sdev[0]):.4f}): max abs diff {rerr:.3e}; kernels: "
          + " ".join(f"{n}={c} (expected {expect[n]})"
                     for n, c in launches.items() if c or expect[n]))
    if not (np.isfinite(value) and abs(rmse - value) <= 1e-5 * max(value, 1)
            and rerr <= 1e-4 * max(float(np.abs(raw).max()), 1.0)):
        raise AssertionError("the standardized finetune's metric is not "
                             "finite or not in raw label space")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"standardized finetune: {n} launched {c} "
                                 f"times, expected {expect[n]}")
    print(f"phase 27, standardized finetune: "
          f"{time.perf_counter() - t1:.1f} s")

    # the protein encoders alone, and their share of the DTA step's busy
    t1 = time.perf_counter()
    dta_np = task_batches(task_opt("dta"), graphs["dta"])[2]
    enc_rows = protein_ops(models, dta_np, dev, rng)
    for row, step in zip(enc_rows, ("dta", "dta_cnn")):
        st = steps[step]
        print(f"{step} train step: wall {st['wall']:.2f} ms, device busy "
              f"{st['busy']:.3f} ms, of which {row['op']} (forward + "
              f"backward, measured alone) {row['device_ms']:.3f} ms "
              f"({100 * row['device_ms'] / st['busy']:.1f}%); peak "
              f"allocated {st['peak_mib']:.1f} MiB")
    print(f"cdrp train step: wall {steps['cdrp']['wall']:.2f} ms, busy "
          f"{steps['cdrp']['busy']:.3f} ms, peak allocated "
          f"{steps['cdrp']['peak_mib']:.1f} MiB")
    print(f"phase 27, protein encoders: {time.perf_counter() - t1:.1f} s; "
          f"phase 27: {time.perf_counter() - t0:.1f} s")
    return paths, report, steps, enc_rows


# phase 28: the model variants (model/variants.py) and ablations
# (model/ablations.py) at the esol config's width (v1 gat with its fixed 3
# heads of 5 columns, padded to 8 on the TCSR kernel); gat2_lite also under
# the dense-attr policy
VARIANT_VERSIONS = ("gat2_lite", "gat2_edge", "gcn2", "gat", "gcn", "gcn3")
VARIANT_RUNS = [(mv, False) for mv in VARIANT_VERSIONS] + [("gat2_lite",
                                                            True)]
V1_LEVEL = "v1 bond (H=3, D=8)"


def _agg_cost(kind, rows, edges, width):
    """(bytes, flops) of one forward + backward of an attention-free
    aggregation on this batch's real rows: ``rows`` {name: count} of the
    ``width``-wide tensors it reads or writes once each (inputs, the
    cotangent, outputs, the inputs' gradients), ``edges`` the real edges
    whose index pair and mask it reads; for "mlp" the two frag_mlp
    matmuls (×3: the forward and the backward's two products) over
    rows["frag"] fragments, and its weights read and their gradients
    written once. Elementwise work is left out."""
    nbytes = 4 * (width * sum(rows.values()) + 3 * edges)
    flops = 0
    if kind == "mlp":
        w = 4 * width * width + 3 * width  # 2·w² weights each way + biases
        nbytes += 4 * 2 * w
        flops = 3 * 2 * rows["frag"] * 4 * width * width
    return nbytes, flops


def aggregation_ops(models, train_np, dev, rng):
    """The attention-free aggregations of phase 28's models, run as torch
    ops on the card (no TPU kernel exists for them): the GCN atom pass
    (gcn2, gat, gcn), the GIN bond and atom aggregations (gcn3) and the
    fragment neighbour sum + frag_mlp (all four), each forward + backward
    alone with a numpy cotangent, on numpy inputs at the shapes of
    ``train_np`` (the work does not depend on the values; layer 1's
    weights of ``models``, {model_version: its trained model}, and the
    batch's own cos-angles): device ms per call
    (profiler), the device kernels it launches, event ms (host dispatch
    included) and the bound over the real rows and edges. Returns [{op,
    model, calls per step, device_ms, kernels, ms, bound_ms, bound_by}]."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.model import ablations

    b = to_device(train_np, dev)
    A, E = b.x_atoms.shape[0], b.nf_bonds.shape[0]
    n_atoms = int((b.atom_mask > 0).sum())
    n_bonds = int((b.edge_mask > 0).sum())
    n_bg = int((b.bg_mask > 0).sum())
    n_frags = int((b.frag_mask > 0).sum())
    n_fconn = int((b.fconn_mask > 0).sum())

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    gcn = models["gcn"].eval().pretrain.layers[1]
    gin = models["gcn3"].eval().pretrain.layers[1]
    W = gcn.atom_embed.out_features
    L = len(models["gcn"].pretrain.layers)
    src, dst, e_mask = ablations._atom_self_loops(b, A)
    ea = torch.cat([b.ea_bonds, b.ea_bonds.new_full((E, 1), 1.5)])
    with torch.no_grad():
        ea_emb = gin.edge_attr_bond_embed(ea)
        nf_b = gin.edge_embed(draw(E, b.nf_bonds.shape[1]))
        bonds = ablations.gin_bond_pass(ea_emb, nf_b, b)
    cases = [  # (op, models, inputs, fn, cost kind, rows, edges)
        ("GCN atom pass", "gcn2 / gat / gcn", (draw(A, W),),
         lambda x: ablations.gcn_atom_pass(x, src, dst, e_mask,
                                           b.atom_mask),
         "agg", {"x": n_atoms, "g": n_atoms, "out": n_atoms,
                 "dx": n_atoms}, n_bonds + n_atoms),
        ("GIN bond aggregation", "gcn3", (ea_emb, nf_b),
         lambda e, n: ablations.gin_bond_pass(e, n, b),
         "agg", {"ea": n_bg + n_bonds, "nf": n_bonds, "g": n_bonds,
                 "out": n_bonds, "dea": n_bg + n_bonds, "dnf": n_bonds},
         n_bg + n_bonds),
        ("GIN atom aggregation", "gcn3", (draw(A, W), bonds),
         lambda x, e: ablations.gin_atom_pass(x, e, b),
         "agg", {"x": n_atoms, "bonds": n_bonds, "g": n_atoms,
                 "out": n_atoms, "dx": n_atoms, "dbonds": n_bonds},
         n_bonds + n_atoms),
        ("fragment neighbour MLP", "gcn2 / gat / gcn / gcn3",
         (draw(A, W),),
         lambda x: ablations.frag_neighbor_mlp(x, b, gcn.frag_mlp),
         "mlp", {"x": n_atoms, "frag": n_frags, "g": n_frags,
                 "out": n_frags, "dx": n_atoms},
         n_atoms + n_fconn),
    ]
    out = []
    for op, used_by, inputs, fn, kind, rows, edges in cases:
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        g = draw(*fn(*xs).shape)

        def call():
            torch.autograd.backward(fn(*xs), g)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        n = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        busy, _rows = _busy(prof)
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0)
        if not busy > 0:
            raise AssertionError(f"{op}: no device time profiled")
        nbytes, flops = _agg_cost(kind, rows, edges, W)
        bound, by = _bound_ms(nbytes, flops)
        row = {"op": op, "models": used_by, "calls_per_step": L,
               "device_ms": busy / n, "kernels": launched / n,
               "ms": _median_ms(call, n=20), "bound_ms": bound,
               "bound_by": by}
        out.append(row)
        print(f"aggregation {op} ({used_by}) forward + backward: device "
              f"{row['device_ms']:.4f} ms in {row['kernels']:.0f} kernels, "
              f"events {row['ms']:.4f} ms, bound {bound:.6f} ms ({by}: "
              f"{nbytes} B, {flops} flop); {L} per train step")
    return out


def variant_phase(dev, datasets, spec, windows, batch_np, train_np, rng):
    """Phase 28: gat2_lite, gat2_edge, gcn2, gat, gcn and gcn3 through the
    port's entry points at the esol config's width: per model the
    prediction and one train step's loss and gradients, card (kernels)
    vs CPU (plain versions), same seeded weights and batch; run_finetune
    for FAMILY_EPOCHS epochs with every launch count set to 0 just before
    it, each kernel's launches equal to finetune_expect's (gat_levels: 0
    for gcn2, gcn and gcn3) and every loss finite; a timed train step.
    gat2_lite also trains under the dense-attr policy. K1 and K2 against
    their plain versions at layer 0 of v1 gat's bond pass (H = 3, D = 8);
    then aggregation_ops. Returns ({path: launches}, {kernel: report
    levels} at the v1 shape, {model: step}, aggregation rows)."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.finetune import run_finetune

    paths, steps, trained, report = {}, {}, {}, {}
    n_tasks = datasets[3]
    for mv, attr in VARIANT_RUNS:
        t0 = time.perf_counter()
        fopt = family_opt(mv, attr=attr)
        label = mv + (" [dense-attr policy]" if attr else "")
        if not attr:
            model = build_model_cpu(fopt, n_tasks).eval()
            card = copy.deepcopy(model).to(dev).eval()
            with torch.no_grad():
                pred_gpu = card(to_device(batch_np, dev)).cpu()
                pred_cpu = model(to_device(batch_np, "cpu"))
            G = int(fopt.finetune.batch_size)
            if tuple(pred_gpu.shape) != (G, n_tasks):
                raise AssertionError(f"{mv}: prediction shape "
                                     f"{tuple(pred_gpu.shape)}")
            fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
            l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
                model, train_np, dev)
            print(f"{label}: forward cpu vs gpu max_abs_err={fwd_err:.3e} "
                  f"rel={fwd_rel:.3e} (limit {FORWARD_REL_LIMIT}); train "
                  f"step loss {l_cpu:.6f} / {l_gpu:.6f}, worst relative "
                  f"diff {worst:.3e} ({worst_name}) over {n_par} "
                  f"parameters (limit {GRAD_REL_LIMIT})")
            if not fwd_rel <= FORWARD_REL_LIMIT:
                raise AssertionError(f"{mv}: card and CPU predictions "
                                     f"disagree")
            if not worst <= GRAD_REL_LIMIT:
                raise AssertionError(f"{mv}: card and CPU gradients "
                                     f"disagree")
            if mv == "gat":
                # K1 and K2 at the v1 bond shape: layer 0's K1 call of one
                # forward, the backward's arguments as phase 4 makes them
                n_layers = int(fopt.finetune.model.num_layer)
                with _Capture(("tcsr_gat_fwd",)) as cap, torch.no_grad():
                    card(to_device(batch_np, dev))
                fwd = cap.calls["tcsr_gat_fwd"]
                if len(fwd) != n_layers or fwd[0][0][1].shape[1] != 24:
                    raise AssertionError(
                        f"v1 gat: {len(fwd)} K1 calls in one forward, "
                        f"row width {fwd[0][0][1].shape[1]}")
                a, kw = fwd[0]
                calls = {"tcsr_gat_fwd": [(V1_LEVEL, a, kw)],
                         "tcsr_gat_bwd": [(V1_LEVEL, bwd_kernel_args(
                             "tcsr_gat_fwd", a, kw, rng), {})]}
                report.update({n: lv for n, (lv, _err) in check_kernels(
                    ("tcsr_gat_fwd", "tcsr_gat_bwd"), calls, rng).items()})
        expect, n_train, n_val, _ = finetune_expect(fopt, datasets, spec,
                                                    windows)
        _reset_launches()
        t1 = time.perf_counter()
        value, tr_model = run_finetune(fopt, datasets=datasets, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = _launches()
        paths[f"{mv}{'_attr' if attr else ''}_train"] = launches
        losses = [r["value"] for r in read_scalars(fopt.exp_dir)
                  if r["tag"] == "train/loss"][-FAMILY_EPOCHS:]
        print(f"{label} training path: {FAMILY_EPOCHS} epochs x {n_train} "
              f"train batches, {n_val} val, {len(windows)} test; test rmse "
              f"{value:.5f}, train losses {[round(x, 5) for x in losses]}, "
              f"run {run_s:.2f} s; kernels: "
              + (" ".join(f"{n}={c} (expected {expect[n]})"
                          for n, c in launches.items() if c or expect[n])
                 or "none (expected none)"))
        if len(losses) != FAMILY_EPOCHS or not np.isfinite(losses).all() \
                or not np.isfinite(value):
            raise AssertionError(f"{label}: training is not finite: losses "
                                 f"{losses}, test rmse {value}")
        for n, c in launches.items():
            if c != expect[n]:
                raise AssertionError(f"{label}: {n} launched {c} times on "
                                     f"the training path, expected "
                                     f"{expect[n]}")
        if not attr:
            steps[mv] = timed_train_step(tr_model, train_np, dev, mv)
            trained[mv] = tr_model
        print(f"phase 28, {label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aggs = aggregation_ops(trained, train_np, dev, rng)
    for mv in ("gcn2", "gat", "gcn", "gcn3"):
        mine = [r for r in aggs if mv in r["models"].split(" / ")]
        per_step = sum(r["device_ms"] * r["calls_per_step"] for r in mine)
        print(f"{mv} train step: device busy {steps[mv]['busy']:.3f} ms, of "
              f"which its aggregations ("
              + " + ".join(r["op"] for r in mine)
              + f", forward + backward, measured alone) {per_step:.3f} ms "
              f"({100 * per_step / steps[mv]['busy']:.1f}%)")
    print(f"phase 28, aggregations: {time.perf_counter() - t0:.1f} s")
    return paths, report, steps, aggs


# phase 29: the HP search, k-fold CV, bucketed finetuning and auxiliary
# pretraining at the esol config's width on phase 3's graphs (the HP and CV
# runs read them from pickles, as a user's data.create output)
HP_TRIALS = 3
HP_SEED = 0
# the widest trial the search space holds: FTHead3 at h1-h4 2048, prelu,
# batch 128
WIDEST_OVERRIDES = {**{f"finetune.model.h{i}": 2048 for i in range(1, 5)},
                    "finetune.model.act": "prelu",
                    "finetune.batch_size": 128}
WIDEST_LEVEL = "hp batch 128"
CV_FOLDS = 3
N_BUCKETS = 3
BUCKET_EPOCHS = 2
BUCKET_LEVEL = "bucket 0"
# auxiliary pretraining: a property table of phase 3's smallest molecules
# (the run featurizes them again, twice in structure mode)
AUX_MOLECULES = 24
AUX_BATCH = 8


def phase29_opt(name: str, *overrides):
    """The training path's config (smoke_opt(train=True)) for one epoch in
    exps/chip_smoke_{name}, with ``overrides`` ({dotted key: value})."""
    opt = smoke_opt(train=True)
    for ov in ({"finetune.n_epochs": 1,
                "exp_dir": os.path.join(REPO, "exps", f"chip_smoke_{name}")},
               *overrides):
        for k, v in ov.items():
            opt.set_path(k, v)
    return opt


def pickled_datasets(datasets, out_dir):
    """Phase 3's splits as pickles under ``out_dir`` (what data.create
    writes): the finetune keys that make load_datasets read them."""
    from fragnet_tpu_torch.data.datasets import save_pickle_dataset

    keys = {"finetune.n_classes": datasets[3],
            "finetune.target_type": datasets[4]}
    for name, graphs in zip(("train", "val", "test"), datasets[:3]):
        path = os.path.join(out_dir, f"{name}.pkl")
        save_pickle_dataset(graphs, path)
        keys[f"finetune.{name}.path"] = path
    return keys


def run_expect(fopt, datasets):
    """finetune_expect for ``run_finetune(fopt, datasets=datasets)`` at
    the config's batch size: the spec and test windows as the run builds
    them (spec_for depends on the graphs' order, so each fold and batch
    size gets its own)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import spec_for

    train_g, val_g, test_g, n_tasks, _task = datasets
    bs = int(fopt.finetune.batch_size)
    spec = spec_for(train_g + val_g + test_g, batch_size=bs, tcsr=True)
    test_w = list(BatchLoader(test_g, bs, spec=spec,
                              n_tasks=n_tasks)._windows())
    return finetune_expect(fopt, datasets, spec, test_w)


def bucket_expect(fopt, datasets):
    """Each kernel's launches on run_finetune's bucketed path
    (``finetune.n_buckets``): the device cache holds the train loader's
    first (shuffled) pass over the buckets, replayed every epoch, and the
    val batches (each epoch); the test batches run once; each batch's
    passes counted by expected_launches from the planes it carries.
    Returns (counts, train, val and test batches)."""
    from fragnet_tpu_torch.data.batcher import BucketedBatchLoader
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy

    ft = fopt.finetune
    n_epochs, seed = int(ft.n_epochs), int(fopt.seed)
    bs, L = int(ft.batch_size), int(ft.model.num_layer)
    train_g, val_g, test_g, n_tasks, _task = datasets
    kw = dict(n_buckets=int(ft.n_buckets), n_tasks=n_tasks,
              spec_kwargs={"tcsr": True})
    first = list(BucketedBatchLoader(train_g, bs, shuffle=True, seed=seed,
                                     **kw))
    val = list(BucketedBatchLoader(val_g, bs, **kw))
    test = list(BucketedBatchLoader(test_g, bs, **kw))
    batches = ([(_planes_of(b), n_epochs, n_epochs) for b in first]
               + [(_planes_of(b), n_epochs, 0) for b in val]
               + [(_planes_of(b), 1, 0) for b in test])
    return (expected_launches(resolve_kernel_policy(ft), L, batches,
                              fopt.get("model_version", "gat2")),
            len(first), len(val), len(test))


def aux_opt(mode: str, csv_path: str):
    """The auxiliary pretraining config at the esol config's encoder
    widths: ``property`` (mse on the table's column) or ``structure``
    (ring counts, 31 classes, cel) for one epoch."""
    from fragnet_tpu_torch.config import Config

    return Config({
        **{k: ESOL_CONFIG[k] for k in ("seed", "atom_features",
                                       "frag_features", "edge_features",
                                       "fedge_in", "fbond_edge_in")},
        "exp_dir": os.path.join(REPO, "exps", f"chip_smoke_aux_{mode}"),
        "pretrain": {
            "mode": mode, "loss": "cel" if mode == "structure" else "mse",
            "prop_csv": csv_path,
            "model": {k: ESOL_CONFIG["finetune"]["model"][k]
                      for k in ("num_layer", "num_heads", "drop_ratio",
                                "emb_dim")},
            "batch_size": AUX_BATCH, "n_epochs": 1, "lr": 1.0e-4}})


def aux_table(datasets, path: str):
    """The AUX_MOLECULES smallest of phase 3's graphs (fewest atoms, in
    their order) written to ``path`` as a property table (smiles, y: the
    synthetic label). Returns those graphs."""
    import csv

    graphs = [g for part in datasets[:3] for g in part]
    keep = sorted(sorted(range(len(graphs)),
                         key=lambda i: graphs[i].n_atoms)[:AUX_MOLECULES])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "y"])
        for i in keep:
            w.writerow([graphs[i].smiles, repr(float(graphs[i].y[0]))])
    return [graphs[i] for i in keep]


def aux_expect(popt, graphs):
    """Each kernel's launches on run_aux_pretrain's path for ``graphs``
    (the table's molecules, featurized as the run featurizes them): the
    seeded train / val split, cached loaders (the train loader's first
    pass replayed each epoch), as finetune_expect counts them. Returns
    (counts, train batches, val batches)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.pretrain import split_graphs

    pt = popt.pretrain
    n_epochs, seed, bs = int(pt.n_epochs), int(popt.seed), int(pt.batch_size)
    train_g, val_g = split_graphs(graphs, seed)
    spec = spec_for(graphs, batch_size=bs, tcsr=True)
    first = list(BatchLoader(train_g, bs, spec=spec, shuffle=True,
                             seed=seed)._windows())
    val_w = list(BatchLoader(val_g, bs, spec=spec)._windows())
    batches = [(_planes_of(pad_batch(w, spec)), n_epochs, steps)
               for ws, steps in ((first, n_epochs), (val_w, 0)) for w in ws]
    return (expected_launches(resolve_kernel_policy(pt),
                              int(pt.model.num_layer), batches),
            len(first), len(val_w))


def _check_launches(label, launches, expect):
    print(f"{label} kernels: "
          + " ".join(f"{n}={c} (expected {expect[n]})"
                     for n, c in launches.items() if c or expect[n]))
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{label}: {n} launched {c} times, "
                                 f"expected {expect[n]}")


def _tagged(calls, tag):
    return {n: [(f"{lvl}, {tag}", a, kw) for lvl, a, kw in c]
            for n, c in calls.items()}


def gat_kernel_calls(n_layers, model, batch, rng, tag):
    """{kernel: [(level, args, kwargs)]} for K1, K2, K4 and K5 at layer 0
    of one forward of ``model`` on ``batch`` (levels tagged ``tag``), the
    backward's arguments as phase 4 makes them."""
    calls = _tagged(layer0_kernel_calls(n_layers, model, batch), tag)
    for name in GAT_KERNELS:
        k = KERNELS[name]
        if k.fwd is not None:
            calls[name] = [(lvl, bwd_kernel_args(k.fwd, a, kw, rng), {})
                           for lvl, a, kw in calls[k.fwd]]
    return calls


def hp_search_phase(datasets, base):
    """Phase 29 (a): run_hp_search(backend="builtin", HP_TRIALS trials,
    seed HP_SEED) over the esol config read from pickles, through the
    port's ft objective on the card wrapped to count: per trial every
    launch count set to 0 just before the objective and compared with
    run_expect after it (a mismatch raises, which the study records as a
    FAIL), the params, wall, peak allocated memory and the memory still
    allocated once the trial's objects are collected (a leak across
    trials would climb). Then every trial read back from the study's
    sqlite table: all COMPLETE with a finite value, none FAIL or
    FAILURE_SCORE. Returns {path: launches} per trial."""
    import gc
    import math
    import shutil
    import sqlite3

    import torch

    from fragnet_tpu_torch.hp.search import (FAILURE_SCORE, run_hp_search,
                                             task_objective)

    shutil.rmtree(base.exp_dir, ignore_errors=True)  # no resumed study
    objective = task_objective("ft", device="cuda")
    trials, held = [], []

    def train_fn(opt):
        gc.collect()
        held.append(torch.cuda.memory_allocated())
        expect = run_expect(opt, datasets)[0]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        value = objective(opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        m = opt.finetune.model
        trials.append(launches)
        print(f"hp trial {len(trials)}: h1-h4 {m.h1}/{m.h2}/{m.h3}/{m.h4} "
              f"act {m.act} drop {m.drop_ratio} batch "
              f"{opt.finetune.batch_size} lr {opt.finetune.lr:.3e}: test "
              f"rmse {value:.5f}, wall {wall:.2f} s, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
        _check_launches(f"hp trial {len(trials)}", launches, expect)
        return value

    study = run_hp_search(base, n_trials=HP_TRIALS, backend="builtin",
                          seed=HP_SEED, train_fn=train_fn)
    gc.collect()
    held.append(torch.cuda.memory_allocated())
    rows = sqlite3.connect(os.path.join(base.exp_dir, "hp.sqlite")).execute(
        "SELECT id, state, value FROM trials WHERE study=? ORDER BY id",
        (study.name,)).fetchall()
    print(f"hp study: {rows}; allocated before each trial and after the "
          f"last: {[round(h / 2 ** 20, 1) for h in held]} MiB")
    bad = [r for r in rows if r[1] != "COMPLETE" or r[2] is None
           or not math.isfinite(r[2]) or r[2] == FAILURE_SCORE]
    if len(rows) != HP_TRIALS or bad or len(trials) != HP_TRIALS:
        raise AssertionError(f"hp search: {len(rows)} trials, failed or "
                             f"not finite: {bad}")
    # held[0] precedes the first trial's one-time allocations (e.g. the
    # cuBLAS workspace in a fresh process); from the first trial's end on,
    # what stays allocated must not climb
    if max(held[1:]) > held[1] + 16 * 2 ** 20:
        raise AssertionError(f"device memory held across trials climbs: "
                             f"{held}")
    return {f"hp_trial{i + 1}": c for i, c in enumerate(trials)}


def widest_trial_phase(datasets, dev, rng):
    """Phase 29 (b): the search space's widest model (WIDEST_OVERRIDES) on
    the first train batch of 128 slots: prediction and one train step's
    loss and gradients, card vs CPU, a timed train step (timed_train_step:
    wall, busy, peak memory), and K1, K2, K4, K5 against their plain
    versions at its layer 0 (levels tagged WIDEST_LEVEL). Returns the
    kernels' report levels."""
    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for

    wopt = phase29_opt("widest", WIDEST_OVERRIDES)
    train_g, val_g, test_g, n_tasks, _task = datasets
    bs, seed = int(wopt.finetune.batch_size), int(wopt.seed)
    spec = spec_for(train_g + val_g + test_g, batch_size=bs, tcsr=True)
    window = next(BatchLoader(train_g, bs, spec=spec, shuffle=True,
                              seed=seed)._windows())
    batch_np = pad_batch(window, spec, n_tasks=n_tasks)
    model = build_model_cpu(wopt, n_tasks).eval()
    card = copy.deepcopy(model).to(dev).eval()
    with torch.no_grad():
        pred_gpu = card(to_device(batch_np, dev)).cpu()
        pred_cpu = model(to_device(batch_np, "cpu"))
    fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
    l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
        model, batch_np, dev)
    print(f"widest trial ({len(window)} graphs in {bs} slots, "
          f"{sum(p.numel() for p in model.parameters())} parameters): "
          f"forward cpu vs gpu max_abs_err={fwd_err:.3e} rel={fwd_rel:.3e} "
          f"(limit {FORWARD_REL_LIMIT}); train step loss {l_cpu:.6f} / "
          f"{l_gpu:.6f}, worst relative diff {worst:.3e} ({worst_name}) over "
          f"{n_par} parameters (limit {GRAD_REL_LIMIT})")
    if tuple(pred_gpu.shape) != (bs, n_tasks) or \
            not fwd_rel <= FORWARD_REL_LIMIT or not worst <= GRAD_REL_LIMIT:
        raise AssertionError("the widest trial's card and CPU predictions "
                             "or gradients disagree")
    timed_train_step(card, batch_np, dev, "widest hp trial, batch 128")
    calls = gat_kernel_calls(int(wopt.finetune.model.num_layer), card,
                             to_device(batch_np, dev), rng, WIDEST_LEVEL)
    return {n: lv for n, (lv, _e) in check_kernels(GAT_KERNELS, calls,
                                                   rng).items()}


def cv_phase(datasets, base):
    """Phase 29 (c): run_finetune_cv over CV_FOLDS folds for one epoch
    each, every launch count set to 0 just before it: the launches equal
    the sum of each fold's run_expect, every fold's score finite, and
    cv_scores.pkl holds them. Returns the launches."""
    import math
    import pickle

    from fragnet_tpu_torch.data.splitters import cv_random_split
    from fragnet_tpu_torch.train.cv import run_finetune_cv

    train_g, val_g, test_g, n_tasks, task = datasets
    pool = list(train_g) + list(val_g)
    expect = {n: 0 for n in KERNELS}
    for tr, va in cv_random_split(len(pool), n_folds=CV_FOLDS,
                                  seed=int(base.seed)):
        fold = ([pool[i] for i in tr], [pool[i] for i in va], test_g,
                n_tasks, task)
        for n, c in run_expect(base, fold)[0].items():
            expect[n] += c
    _reset_launches()
    t0 = time.perf_counter()
    mean, std, scores = run_finetune_cv(base, n_folds=CV_FOLDS, quiet=True,
                                        device="cuda")
    wall = time.perf_counter() - t0
    launches = _launches()
    with open(os.path.join(base.exp_dir, "cv_scores.pkl"), "rb") as f:
        saved = pickle.load(f)
    print(f"cv: {CV_FOLDS} folds x 1 epoch, test rmse {scores} (mean "
          f"{mean:.5f} +/- {std:.5f}), run {wall:.2f} s")
    if len(scores) != CV_FOLDS or not all(map(math.isfinite, scores)) \
            or saved["scores"] != scores:
        raise AssertionError(f"cv scores not finite or not saved: {scores}")
    _check_launches("cv", launches, expect)
    return launches


def bucket_phase(datasets, dev, rng):
    """Phase 29 (d): run_finetune with finetune.n_buckets = N_BUCKETS for
    BUCKET_EPOCHS epochs, under the default and the dense-attr policy,
    every launch count set to 0 just before each: the launches equal
    bucket_expect's, the losses finite. Then a timed train step on the
    smallest bucket's first batch, and K1, K2, K4, K5 and K7, K8 against
    their plain versions at its layer 0 (levels tagged BUCKET_LEVEL).
    Returns ({path: launches}, the kernels' report levels)."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.data.batcher import BucketedBatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model, run_finetune

    paths = {}
    for attr in (False, True):
        label = "buckets" + ("_attr" if attr else "")
        bopt = phase29_opt(label, {"finetune.n_buckets": N_BUCKETS,
                                   "finetune.n_epochs": BUCKET_EPOCHS},
                           ({f"finetune.{k}": v for k, v in
                             ATTR_KERNEL.items()} if attr else {}))
        expect, n_train, n_val, n_test = bucket_expect(bopt, datasets)
        _reset_launches()
        t0 = time.perf_counter()
        value, _model = run_finetune(bopt, quiet=True, datasets=datasets,
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[label] = _launches()
        losses = [r["value"] for r in read_scalars(bopt.exp_dir)
                  if r["tag"] == "train/loss"][-BUCKET_EPOCHS:]
        print(f"{label}: {N_BUCKETS} buckets, {BUCKET_EPOCHS} epochs x "
              f"{n_train} train batches, {n_val} val, {n_test} test; test "
              f"rmse {value:.5f}, train losses "
              f"{[round(x, 5) for x in losses]}, run {wall:.2f} s")
        if len(losses) != BUCKET_EPOCHS or not np.isfinite(losses).all() \
                or not np.isfinite(value):
            raise AssertionError(f"{label}: not finite: {losses}, {value}")
        _check_launches(label, paths[label], expect)
    opt = smoke_opt(train=True)
    train_g, n_tasks = datasets[0], datasets[3]
    small = BucketedBatchLoader(train_g, int(opt.finetune.batch_size),
                                n_buckets=N_BUCKETS, n_tasks=n_tasks,
                                spec_kwargs={"tcsr": True}).loaders[0]
    batch_np = next(iter(small))
    batch = to_device(batch_np, dev)
    spec = small.spec
    print(f"bucket 0: {len(small.graphs)} graphs; spec atoms {spec.n_atoms}, "
          f"edges {spec.n_edges}, frags {spec.n_frags}, fconn "
          f"{spec.n_fconn}, bond-graph edges {spec.n_bg_edges}")
    L = int(opt.finetune.model.num_layer)
    card = build_model_cpu(opt, n_tasks).to(dev).eval()
    timed_train_step(card, batch_np, dev, "bucket 0")
    calls = gat_kernel_calls(L, card, batch, rng, BUCKET_LEVEL)
    aopt = smoke_opt(attr=True)
    acard = build_model(aopt, n_classes=n_tasks,
                        policy=resolve_kernel_policy(aopt.finetune),
                        generator=torch.Generator().manual_seed(0))
    acard = acard.to(dev).eval()
    fwd = layer0_kernel_calls(L, acard, batch, names=("dense_attr_fwd",))
    calls.update(_attr_calls(_tagged(fwd, BUCKET_LEVEL)["dense_attr_fwd"],
                             rng))
    report = check_kernels(GAT_KERNELS + ATTR_KERNELS, calls, rng)
    return paths, {n: lv for n, (lv, _e) in report.items()}


def aux_phase(datasets, dev):
    """Phase 29 (e): run_pretrain with pretrain.mode = property (mse on a
    table of phase 3's AUX_MOLECULES smallest molecules and their labels)
    and = structure (ring counts, cel), one epoch each, every launch count
    set to 0 just before each: launches equal aux_expect's, losses finite;
    then the structure model's logits (its checkpoint on a finetune batch
    of phase 3), card vs CPU within 1e-3 of scale. Returns {path:
    launches}."""
    import math

    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.pretrain import build_aux_model, run_pretrain

    csv_path = os.path.join(REPO, "exps", "chip_smoke_aux", "props.csv")
    graphs = aux_table(datasets, csv_path)
    paths, ckpts = {}, {}
    for mode in ("property", "structure"):
        popt = aux_opt(mode, csv_path)
        expect, n_train, n_val = aux_expect(popt, graphs)
        _reset_launches()
        t0 = time.perf_counter()
        best, ckpts[mode] = run_pretrain(popt, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[f"aux_{mode}"] = _launches()
        scal = read_scalars(popt.exp_dir)
        losses = [r["value"] for r in scal
                  if r["tag"] in ("train/loss", "val/loss")][-2:]
        print(f"aux pretrain ({mode}, {popt.pretrain.loss}): "
              f"{len(graphs)} molecules, {n_train} train batches, {n_val} "
              f"val; train / val loss {losses}, run {wall:.2f} s "
              f"(featurization included)")
        if len(losses) != 2 or not all(map(math.isfinite, losses)) \
                or not math.isfinite(best):
            raise AssertionError(f"aux pretrain ({mode}): not finite: "
                                 f"{losses}")
        _check_launches(f"aux_{mode}", paths[f"aux_{mode}"], expect)
    model = build_aux_model(aux_opt("structure", csv_path), 31)
    model.load_state_dict(torch.load(ckpts["structure"], map_location="cpu",
                                     weights_only=True))
    model.eval()
    bs = AUX_BATCH
    spec = spec_for(graphs, batch_size=bs, tcsr=True)
    batch_np = pad_batch(next(BatchLoader(graphs, bs, spec=spec)._windows()),
                         spec)
    card = copy.deepcopy(model).to(dev)
    with torch.no_grad():
        got = card(to_device(batch_np, dev)).cpu()
        want = model(to_device(batch_np, "cpu"))
    err, rel = _diff(got, want)
    print(f"structure model logits {tuple(got.shape)} cpu vs gpu: "
          f"max_abs_err={err:.3e} rel={rel:.3e} (limit {FORWARD_REL_LIMIT})")
    if tuple(got.shape) != (bs, 31) or not rel <= FORWARD_REL_LIMIT:
        raise AssertionError("the structure model's card and CPU logits "
                             "disagree")
    return paths


def phase29(dev, datasets, rng):
    """Phase 29: (a) the HP search, (b) its widest trial, (c) CV, (d) the
    bucketed finetune, (e) auxiliary pretraining. Returns ({path:
    launches}, {kernel: report levels} at the "hp batch 128" and "bucket
    0" levels)."""
    t0 = time.perf_counter()
    pickles = pickled_datasets(
        datasets, os.path.join(REPO, "exps", "chip_smoke_pickles"))
    paths = hp_search_phase(datasets, phase29_opt("hp", pickles))
    print(f"phase 29 (a), hp search: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    levels = widest_trial_phase(datasets, dev, rng)
    print(f"phase 29 (b), widest trial: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    paths["cv"] = cv_phase(datasets, phase29_opt("cv", pickles))
    print(f"phase 29 (c), cv: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    bucket_paths, bucket_levels = bucket_phase(datasets, dev, rng)
    paths.update(bucket_paths)
    for n, lv in bucket_levels.items():
        levels.setdefault(n, []).extend(lv)
    print(f"phase 29 (d), buckets: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    paths.update(aux_phase(datasets, dev))
    print(f"phase 29 (e), auxiliary pretraining: "
          f"{time.perf_counter() - t1:.1f} s; phase 29: "
          f"{time.perf_counter() - t0:.1f} s")
    return paths, levels


# phase 30: bf16 compute (finetune.dtype=bf16) on the main path: the esol
# recipe at full width, its GAT passes on the bf16 entries of K1, K2, K4, K5
BF16_OVERRIDES = {
    "finetune.dtype": "bf16",
    "finetune.n_epochs": 2,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol_bf16"),
}
# the f32 twin: the same data, seed and epochs in f32, for the test RMSE
# beside bf16's
BF16_TWIN_OVERRIDES = {
    "finetune.n_epochs": 2,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_esol_bf16_twin"),
}
# bf16 against f32 differs by bf16's rounding (the JAX package's own gap
# on the CPU: 1.4e-2 to 6.5e-2 of the prediction scale at these widths).
# The card is held to the CPU's bf16 within 2e-2 of the prediction scale.
# Its gradients are held against the CPU's f32 ones: their distance from
# them, each parameter's relative to its own norm, as a root mean square
# over the parameters, within twice the CPU bf16 gradients' own plus 1e-3
# — a card's bf16 is no further from exact than the CPU's. A bound between
# the two bf16 gradients alone would not hold at this width: the ReLU
# units of the 1024-wide head whose input lies within bf16's rounding of 0
# switch between devices, moving whole rows of the head's gradients (on
# an H100: card vs CPU up to 3.7 of a gradient's largest entry, on one
# that is 0 in exact arithmetic; CPU bf16 vs f32 up to 5.6e-1 of a
# gradient's norm); nor does a bound on each parameter alone, which one
# run's rounding decides (layer 1's atom attention vector 8.3e-2 of its
# norm from f32 on the card, 3.5e-2 on the CPU, in one run). The
# per-parameter and card-vs-CPU distances are printed beside (limit none).
# 1e-4 of the largest gradient's norm is every gradient's round-off floor
# (an embed bias's is 0 in exact arithmetic).
BF16_PRED_LIMIT = 2e-2
BF16_GRAD_FLOOR = 1e-4


def bf16_opt(twin: bool = False):
    """The training path's config (smoke_opt(train=True)) in bf16 for 2
    epochs, or (``twin``) its f32 twin."""
    opt = smoke_opt(train=True)
    for k, v in (BF16_TWIN_OVERRIDES if twin else BF16_OVERRIDES).items():
        opt.set_path(k, v)
    return opt


def bf16_grads_vs_f32(cpu_model, train_np, dev, n_tasks, twin_opt=None):
    """Phase 30 (b)'s gradient check: one train step's loss and gradients
    of the bf16 model on the card and on the CPU, and of its f32 twin (the
    same weights) on the CPU, dropout off. Each parameter's distance from
    the f32 gradient relative to its norm (norms floored at
    BF16_GRAD_FLOOR of the largest); the card's root mean square over the
    parameters must lie within 2 × the CPU bf16's + 1e-3. The worst
    parameter of each and the card-vs-CPU bf16 distance (largest entry,
    relative to the gradient's largest) are printed beside. ``twin_opt``
    (default: phase 30's twin) names the f32 twin's config."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import LOSSES

    f32_model = build_model_cpu(twin_opt or bf16_opt(twin=True),
                                n_tasks).eval()
    f32_model.load_state_dict(cpu_model.state_dict())

    def loss_and_grads(m, d):
        m_d = copy.deepcopy(m).to(d).eval()
        b_d = to_device(train_np, d)
        value = LOSSES["mse"](m_d(b_d), b_d.y, b_d.graph_mask)
        value.backward()
        return float(value.detach()), {
            n: p.grad.detach().cpu() for n, p in m_d.named_parameters()
            if p.grad is not None}

    l_card, g_card = loss_and_grads(cpu_model, dev)
    l_cpu, g_cpu = loss_and_grads(cpu_model, torch.device("cpu"))
    l_32, g_32 = loss_and_grads(f32_model, torch.device("cpu"))
    if set(g_card) != set(g_cpu) or set(g_cpu) != set(g_32):
        raise AssertionError("bf16: gradients on one device only")
    top = max(float(g.norm()) for g in g_32.values())
    dist = {"card": {}, "cpu": {}}
    card_cpu, cc_name = 0.0, None
    for n, g in g_32.items():
        sc = max(float(g.norm()), BF16_GRAD_FLOOR * top)
        for dev_name, gd in (("card", g_card), ("cpu", g_cpu)):
            dist[dev_name][n] = float((gd[n] - g).norm()) / sc
        cc = float((g_card[n] - g_cpu[n]).abs().max()) / max(
            float(g_cpu[n].abs().max()), 1e-30)
        if cc > card_cpu:
            card_cpu, cc_name = cc, n
    rms = {k: statistics.fmean(x * x for x in d.values()) ** 0.5
           for k, d in dist.items()}
    worst = {k: max(d.items(), key=lambda kv: kv[1])
             for k, d in dist.items()}
    print(f"bf16 train step: loss card {l_card:.6f}, cpu {l_cpu:.6f}, f32 "
          f"{l_32:.6f}; gradients against f32 over {len(g_32)} parameters "
          f"(each relative to its norm): root mean square card "
          f"{rms['card']:.3e}, cpu {rms['cpu']:.3e} (limit 2x + 1e-3); "
          f"worst card {worst['card'][1]:.3e} ({worst['card'][0]}), cpu "
          f"{worst['cpu'][1]:.3e} ({worst['cpu'][0]}); card vs cpu bf16 up "
          f"to {card_cpu:.3e} of a gradient's largest entry ({cc_name})")
    if not rms["card"] <= 2 * rms["cpu"] + 1e-3:
        raise AssertionError("bf16: the card's gradients are further from "
                             "f32 than twice the CPU's")


def bf16_phase(dev, datasets, spec, windows, batch_np, train_np,
               step_default, rng):
    """Phase 30: the esol recipe with finetune.dtype=bf16. (a) K1, K2, K4,
    K5's bf16 entries against their plain versions at layer 0 of a bf16
    forward of the esol batch (levels tagged "bf16"), timed, their bounds
    with nf at 2 bytes; every output is f32 (out, m, den, the gradients),
    held to 1e-4 of its scale. (b) One bf16 forward, card vs CPU, carried
    weights, dropout off: predictions within BF16_PRED_LIMIT of their
    scale; one train step's gradients against the f32 twin's
    (bf16_grads_vs_f32). (c) run_finetune in bf16 for 2 epochs, every
    launch count set to 0 just before it: the bf16 entries launch as
    finetune_expect
    counts the f32 ones, the f32 entries not at all; losses finite; the
    test RMSE beside the f32 twin's (same data and seed; no claim). (d) A
    timed bf16 train step beside phase 8's f32 step. Returns (the bf16
    kernels' report, the bf16 path's launches)."""
    import numpy as np
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.train.finetune import run_finetune

    t0 = time.perf_counter()
    opt = bf16_opt()
    n_tasks = datasets[3]
    L = int(opt.finetune.model.num_layer)
    cpu_model = build_model_cpu(opt, n_tasks).eval()
    model = copy.deepcopy(cpu_model).to(dev).eval()
    if model.pretrain.layers[0].dtype != torch.bfloat16:
        raise AssertionError("phase 30's model does not compute in bf16")

    # (a) the bf16 entries at layer 0 of a bf16 forward
    captured = layer0_kernel_calls(L, model, to_device(batch_np, dev))
    calls = {}
    for n32, per_level in captured.items():
        calls[BF16_OF[n32]] = [(f"{lvl}, bf16", a, kw)
                               for lvl, a, kw in per_level]
        if any(a[3 if n32 == "dense_gat_fwd" else 1].dtype != torch.bfloat16
               for _, a, _ in per_level):
            raise AssertionError(f"{n32}: a bf16 forward passed f32 nf")
    for name in GAT_BF16:
        fwd = KERNELS[name].fwd
        if fwd is not None:
            calls[name] = [(lvl, bwd_kernel_args(fwd, a, kw, rng), {})
                           for lvl, a, kw in calls[fwd]]
    report = check_kernels(GAT_BF16, calls, rng)
    print(f"phase 30 (a): {time.perf_counter() - t0:.1f} s")

    # (b) one forward and one train step's gradients, card vs CPU
    with torch.no_grad():
        pred_gpu = model(to_device(batch_np, dev)).cpu()
        pred_cpu = cpu_model(to_device(batch_np, "cpu"))
    fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
    print(f"bf16 forward cpu vs gpu: max_abs_err={fwd_err:.3e} "
          f"rel={fwd_rel:.3e} (limit {BF16_PRED_LIMIT})")
    if not fwd_rel <= BF16_PRED_LIMIT:
        raise AssertionError("bf16: card and CPU predictions disagree")
    bf16_grads_vs_f32(cpu_model, train_np, dev, n_tasks)

    # (c) the bf16 training path, then its f32 twin
    expect32, n_train, n_val, _ = finetune_expect(opt, datasets, spec,
                                                  windows)
    runs = {}
    for twin in (False, True):
        fopt = bf16_opt(twin)
        label = "f32 twin" if twin else "bf16"
        _reset_launches()
        t1 = time.perf_counter()
        value, tr_model = run_finetune(fopt, datasets=datasets,
                                       device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = _launches()
        n_ep = int(fopt.finetune.n_epochs)
        losses = [r["value"] for r in read_scalars(fopt.exp_dir)
                  if r["tag"] == "train/loss"][-n_ep:]
        runs[label] = (value, tr_model, launches)
        print(f"{label} training path: {n_ep} epochs x {n_train} train "
              f"batches, {n_val} val, {len(windows)} test; test rmse "
              f"{value:.5f}, train losses {[round(x, 5) for x in losses]}, "
              f"run {run_s:.2f} s")
        if len(losses) != n_ep or not np.isfinite(losses).all() \
                or not np.isfinite(value):
            raise AssertionError(f"{label}: training is not finite: losses "
                                 f"{losses}, test rmse {value}")
        _check_launches(f"{label} training path", launches,
                        expect32 if twin else as_bf16(expect32))
    print(f"test rmse after 2 epochs, same data and seed: bf16 "
          f"{runs['bf16'][0]:.5f}, f32 {runs['f32 twin'][0]:.5f} (no claim: "
          f"one seed, 2 epochs)")
    print(f"phase 30 (b, c): {time.perf_counter() - t0:.1f} s")

    # (d) one bf16 train step beside phase 8's f32 step
    step = timed_train_step(runs["bf16"][1], train_np, dev, "bf16")
    print(f"train step, bf16 vs f32 (phase 8): wall {step['wall']:.2f} / "
          f"{step_default['wall']:.2f} ms, busy {step['busy']:.3f} / "
          f"{step_default['busy']:.3f} ms, peak allocated "
          f"{step['peak_mib']:.1f} / {step_default['peak_mib']:.1f} MiB; "
          f"the GAT kernels' device ms: "
          + ", ".join(f"{BF16_OF[n32]} "
                      f"{step['kernels'][BF16_OF[n32]]:.4f} / "
                      f"{step_default['kernels'][n32]:.4f}"
                      for n32 in GAT_KERNELS))
    print(f"phase 30: {time.perf_counter() - t0:.1f} s")
    return report, runs["bf16"][2]


# phase 31: bf16 on the rest of the JAX package's bf16 paths — the
# dense-attr policy (K7, K8 with K9), geometric pretraining through the
# packed transport (K6 on widened bf16 attributes), auxiliary pretraining,
# DP and EP (K3) — each path for one epoch
BF16_REST_EPOCHS = 1
BF16_PT_OVERRIDES = {
    "pretrain.dtype": "bf16",
    "pretrain.n_epochs": BF16_REST_EPOCHS,
    "exp_dir": os.path.join(REPO, "exps", "chip_smoke_pt_bf16"),
}


def bf16_attr_opt(twin: bool = False):
    """The dense-attr training path's config (smoke_opt(train=True,
    attr=True)) in bf16 for BF16_REST_EPOCHS epochs, or (``twin``) its f32
    twin, each in its own exp_dir."""
    opt = smoke_opt(train=True, attr=True)
    opt.set_path("finetune.n_epochs", BF16_REST_EPOCHS)
    if not twin:
        opt.set_path("finetune.dtype", "bf16")
    opt.set_path("exp_dir", os.path.join(
        REPO, "exps", "chip_smoke_esol_attr_bf16" + ("_twin" if twin else "")))
    return opt


def _finite_run(label, exp_dir, n_epochs, value):
    """The last ``n_epochs`` train losses of a run's scalars, raising unless
    they and ``value`` are finite."""
    import numpy as np

    from fragnet_tpu_torch.obs import read_scalars

    losses = [r["value"] for r in read_scalars(exp_dir)
              if r["tag"] == "train/loss"][-n_epochs:]
    if len(losses) != n_epochs or not np.isfinite(losses + [value]).all():
        raise AssertionError(f"{label}: not finite: train losses {losses}, "
                             f"value {value}")
    return losses


def bf16_rest_phase(dev, datasets, spec, windows, batch_np, train_np,
                    step_attr, pgraphs, dist16, rng):
    """Phase 31: bf16 on the paths beyond phase 30's. (a) The bf16 entries
    of K7 and K8 (with K9's d_wea, exactly 0 off the counted edges) at
    layer 0 of a bf16 forward of the esol batch under the dense-attr
    policy, with a seeded case per level, and of K3 at each rank's layer-0
    shards of the bf16 EP step that phase 22's ranks ran (``dist16``), with
    seeded shards: each against its plain version at 1e-4 of the output's
    scale, timed. (b) finetune.dtype=bf16 under the dense-attr policy:
    card vs CPU predictions within BF16_PRED_LIMIT, a train step's
    gradients against the f32 twin's (bf16_grads_vs_f32), run_finetune for
    BF16_REST_EPOCHS epochs with exact launches, a timed step beside phase
    18's f32 one. (c) Geometric pretraining in bf16 through the packed
    transport (batch 64, one epoch, the HBM tier): exact launches; a bf16
    buffer's device planes equal K6's planes of the widened attributes and
    the plain builder's. (d) run_aux_pretrain in bf16 (property mode), one
    epoch, exact launches. (e) The bf16 EP and DP finetune paths that
    phases 22 and 23's ranks ran: each rank's launches exact, losses finite
    and equal across the ranks; the bf16 EP step's predictions within
    BF16_PRED_LIMIT of the one-device bf16 step's, its wall and busy time
    beside f32's. Every path's bf16 GAT entries launch as its f32 ones
    would, and no f32 GAT entry launches. Returns (the bf16 K7, K8, K3
    report, {path: launches}, the launches on the dense-attr and EP paths
    by "attr" / "ep")."""
    import dataclasses
    import math

    import torch

    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.data.packing import unpack_batch
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import spec_for
    from fragnet_tpu_torch.ops import dense_gat
    from fragnet_tpu_torch.train.finetune import run_finetune
    from fragnet_tpu_torch.train.pretrain import run_pretrain, split_graphs

    S = EP_SHARDS
    n_tasks = datasets[3]
    bf = torch.bfloat16
    paths = {}

    # (a) the bf16 entries of K7, K8 and K3 against their plain versions
    t0 = time.perf_counter()
    opt = bf16_attr_opt()
    L = int(opt.finetune.model.num_layer)
    cpu_model = build_model_cpu(opt, n_tasks).eval()
    model = copy.deepcopy(cpu_model).to(dev).eval()
    lay = model.pretrain.layers[0]
    if lay.dtype != bf or not lay.policy.attr or lay.policy.fc != "attr":
        raise AssertionError("phase 31's model is not bf16 under the "
                             "dense-attr policy")
    fwd = layer0_kernel_calls(L, model, to_device(batch_np, dev),
                              names=("dense_attr_fwd",))["dense_attr_fwd"]
    fwd = [(f"{lvl}, bf16", a, kw) for lvl, a, kw in fwd]
    fwd += [seeded_attr_call(c, rng) for c in fwd]
    ep = ep_kernel_calls([r["calls"] for r in dist16["ep_steps"]], rng)
    calls = {
        "dense_attr_fwd_bf16": fwd,
        "dense_attr_bwd_bf16": [
            (lvl, bwd_kernel_args("dense_attr_fwd_bf16", a, kw, rng), {})
            for lvl, a, kw in fwd],
        **{BF16_OF[n]: [(f"{lvl}, bf16", a, kw) for lvl, a, kw in ep[n]]
           for n in EP_KERNELS}}
    for name, cs in calls.items():
        i = 3 if name.startswith("dense_attr") else 1
        if any(a[i].dtype != bf for _, a, _ in cs):
            raise AssertionError(f"{name}: a case with f32 nf")
    report = check_kernels(ATTR_BF16, calls, rng)
    report.update(check_kernels(EP_BF16, calls, rng,
                                check_scales=check_ep_scales))
    # K9 in the bf16 K8's launch: checked at every level, and at each timed
    # level (K8's report there) its plain version and the library gather
    # timed as phase 16 times the f32 ones
    k8_16 = {p["level"]: p for p in report["dense_attr_bwd_bf16"][0]}
    for lvl, a, kw in calls["dense_attr_bwd_bf16"]:
        got = dense_gat.dense_attr_bwd(*a, **kw)
        want = dense_gat.dense_attr_bwd_emit_plain(*a, **kw)
        floor = 0.0 if "seeded" in lvl else _scale_floor(
            "dense_attr_bwd_bf16", a)
        emit_levels(a, got[4], want[4], _diff(got[4], want[4], floor),
                    k8_16.get(lvl))
    print(f"bf16 K8's d_wea (K9 in its launch) against the plain pair and "
          f"0 off the counted edges at all "
          f"{len(calls['dense_attr_bwd_bf16'])} levels")
    print(f"phase 31 (a): {time.perf_counter() - t0:.1f} s")

    # (b) the dense-attr finetune path in bf16
    t0 = time.perf_counter()
    with torch.no_grad():
        pred_gpu = model(to_device(batch_np, dev)).cpu()
        pred_cpu = cpu_model(to_device(batch_np, "cpu"))
    fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
    print(f"bf16 dense-attr forward cpu vs gpu: max_abs_err={fwd_err:.3e} "
          f"rel={fwd_rel:.3e} (limit {BF16_PRED_LIMIT})")
    if not fwd_rel <= BF16_PRED_LIMIT:
        raise AssertionError("bf16 dense-attr: card and CPU predictions "
                             "disagree")
    bf16_grads_vs_f32(cpu_model, train_np, dev, n_tasks,
                      twin_opt=bf16_attr_opt(twin=True))
    expect32, n_train, n_val, _ = finetune_expect(opt, datasets, spec,
                                                  windows)
    _reset_launches()
    t1 = time.perf_counter()
    value, tr_model = run_finetune(opt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches_attr = _launches()
    losses = _finite_run("bf16 dense-attr training path", opt.exp_dir,
                         BF16_REST_EPOCHS, value)
    print(f"bf16 dense-attr training path: {BF16_REST_EPOCHS} epoch x "
          f"{n_train} train batches, {n_val} val, {len(windows)} test; test "
          f"rmse {value:.5f}, train losses {[round(x, 5) for x in losses]}, "
          f"run {run_s:.2f} s")
    _check_launches("bf16 dense-attr training path", launches_attr,
                    as_bf16(expect32))
    paths["finetune_attr_bf16_train"] = launches_attr
    step = timed_train_step(tr_model, train_np, dev, "bf16 dense-attr")
    print(f"train step under the dense-attr policy, bf16 vs f32 (phase 18): "
          f"wall {step['wall']:.2f} / {step_attr['wall']:.2f} ms, busy "
          f"{step['busy']:.3f} / {step_attr['busy']:.3f} ms, peak allocated "
          f"{step['peak_mib']:.1f} / {step_attr['peak_mib']:.1f} MiB; the "
          f"GAT kernels' device ms: "
          + ", ".join(f"{BF16_OF[n]} {step['kernels'][BF16_OF[n]]:.4f} / "
                      f"{step_attr['kernels'][n]:.4f}"
                      for n in ("dense_gat_fwd", "dense_gat_bwd")
                      + ATTR_KERNELS))
    print(f"phase 31 (b): {time.perf_counter() - t0:.1f} s")

    # (c) geometric pretraining in bf16 through the packed transport
    t0 = time.perf_counter()
    popt = pt_opt(PT_OVERRIDES, BF16_PT_OVERRIDES)
    expect, n_train, n_val, levels = pretrain_expect(popt, pgraphs, 1, 1)
    print(f"bf16 pretraining path: {n_train} train steps, {n_val} val "
          f"batches at batch {popt.pretrain.batch_size}; device planes per "
          f"train step: {levels}")
    paths["pretrain_bf16"], _ckpt = drive_pretrain(popt, pgraphs,
                                                   as_bf16(expect), "HBM")
    seed, bs = int(popt.seed), int(popt.pretrain.batch_size)
    train_g, _val_g = split_graphs(pgraphs, seed)
    loader = BatchLoader(train_g, bs, spec=spec_for(pgraphs, bs, tcsr=True),
                         with_targets=True, pack=True, compute_dtype="bf16")
    buf = torch.from_numpy(next(iter(loader))).to(dev)
    up = unpack_batch(buf, loader.layout, ("dp_bond", "dp_fc"))
    if up.ea_bonds.dtype != bf:
        raise AssertionError("the bf16 layout's ea_bonds decode as "
                             f"{up.ea_bonds.dtype}")
    for lvl, (s_, d_, m_, ea) in {
            "dp_bond": ("bg_src", "bg_dst", "bg_mask", up.ea_bonds),
            "dp_fc": ("fc_src", "fc_dst", "fc_mask", up.ea_fbonds)}.items():
        got = getattr(up, lvl)
        args = (getattr(up, s_), getattr(up, d_), getattr(up, m_))
        n_nodes = got.shape[0] * got.shape[2]
        tm = getattr(up, "tm_" + lvl[3:])
        want = dense_gat.build_dense_planes_device(*args, ea.float(),
                                                   n_nodes, tm)
        cpu_tm = dataclasses.replace(tm, **{
            f: getattr(tm, f).cpu() for f in ("ew_blk", "sw_tile",
                                              "flat_slot", "cw")})
        plain = dense_gat.build_dense_planes_device_plain(
            *(a.cpu() for a in args), ea.float().cpu(), n_nodes, cpu_tm)
        if not (torch.equal(got, want) and torch.equal(got.cpu(), plain)):
            raise AssertionError(f"{lvl}: the planes of bf16 attributes are "
                                 f"not those of their widening")
    print(f"bf16 packed batch ({loader.layout.total_bytes} bytes, ea_bonds "
          f"in bf16): dp_bond and dp_fc from bf16 attributes equal K6's and "
          f"the plain builder's planes of the widened attributes exactly")
    print(f"phase 31 (c): {time.perf_counter() - t0:.1f} s")

    # (d) auxiliary pretraining in bf16
    t0 = time.perf_counter()
    csv_path = os.path.join(REPO, "exps", "chip_smoke_aux", "props.csv")
    graphs = aux_table(datasets, csv_path)
    aopt = aux_opt("property", csv_path)
    aopt.set_path("pretrain.dtype", "bf16")
    aopt.set_path("exp_dir", os.path.join(REPO, "exps",
                                          "chip_smoke_aux_property_bf16"))
    expect, n_train, n_val = aux_expect(aopt, graphs)
    _reset_launches()
    best, _ckpt = run_pretrain(aopt, device="cuda")
    torch.cuda.synchronize()
    paths["aux_property_bf16"] = _launches()
    losses = _finite_run("bf16 aux pretraining", aopt.exp_dir, 1, best)
    print(f"bf16 aux pretrain (property): {len(graphs)} molecules, "
          f"{n_train} train batches, {n_val} val; train losses {losses}")
    _check_launches("aux_property_bf16", paths["aux_property_bf16"],
                    as_bf16(expect))
    print(f"phase 31 (d): {time.perf_counter() - t0:.1f} s")

    # (e) EP and DP in bf16, from phases 22's and 23's ranks
    t0 = time.perf_counter()
    eopt, reports = dist16["ep_run"]
    exp_ep, steps = ep_expect(eopt, datasets, S)
    ep_launches = check_rank_reports(eopt, reports, [as_bf16(exp_ep)] * S,
                                     "bf16 EP finetune")
    print(f"bf16 EP finetune path: {S} ranks, {steps} train steps, test "
          f"rmse {reports[0]['value']:.5f}")
    dopt, reports = dist16["dp_run"]
    exp_dp, steps = dp_expect(dopt, datasets, spec, S)
    dp_launches = check_rank_reports(dopt, reports,
                                     [as_bf16(e) for e in exp_dp],
                                     "bf16 DP finetune")
    print(f"bf16 DP finetune path: {S} ranks, {steps} train steps, test "
          f"rmse {reports[0]['value']:.5f}")
    for r in range(S):
        paths[f"finetune_ep_bf16_rank{r}"] = ep_launches[r]
        paths[f"finetune_dp_bf16_rank{r}"] = dp_launches[r]
    opt16 = smoke_opt(train=True)
    opt16.set_path("finetune.dtype", "bf16")
    one = build_model_cpu(opt16, n_tasks).to(dev).eval()
    with torch.no_grad():
        pred = one(to_device(dist16["ep_ref"], dev)).cpu()
    for r, (res, res32) in enumerate(zip(dist16["ep_steps"],
                                         dist16["ep_steps32"])):
        err, rel = _diff(res["pred"].cpu(), pred)
        print(f"bf16 EP step rank {r} vs the one-device bf16 card step: "
              f"prediction max_abs_err={err:.3e} rel={rel:.3e} (limit "
              f"{BF16_PRED_LIMIT}); loss {res['loss']:.6f}; wall "
              f"{res['wall_ms']:.2f} ms, busy {res['busy_ms']:.3f} ms, K3 "
              f"device {res['k3_device_ms']:.3f} ms (f32, phase 22: "
              f"{res32['wall_ms']:.2f}, {res32['busy_ms']:.3f}, "
              f"{res32['k3_device_ms']:.3f})")
        if not rel <= BF16_PRED_LIMIT or not math.isfinite(res["loss"]):
            raise AssertionError("the bf16 EP step disagrees with the "
                                 "one-device bf16 step")
    print(f"phase 31 (e): {time.perf_counter() - t0:.1f} s here (the runs: "
          f"EP {dist16['ep_s']:.1f} s, DP {dist16['dp_s']:.1f} s in phases "
          f"22's and 23's ranks)")
    return report, paths, {"attr": launches_attr, "ep": ep_launches[0]}


def _same_bits(a, b) -> bool:
    """Whether two decoded fields (tensors, TileMeta or None) hold the same
    bits: floats compared as their integer patterns."""
    import dataclasses

    import torch

    if a is None or b is None:
        return a is None and b is None
    if not isinstance(a, torch.Tensor):
        return all(_same_bits(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a)
                   if isinstance(getattr(a, f.name), torch.Tensor)) and all(
            getattr(a, f.name) == getattr(b, f.name)
            for f in dataclasses.fields(a)
            if not isinstance(getattr(a, f.name), torch.Tensor))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return bool(torch.equal(a, b))


def compact_phase(dev, datasets, spec, pgraphs):
    """Phase 32: the compact packing encodings (``BatchLoader(pack_compact=
    True)``, data/packing.py). (a) At the esol batch 16 (the finetune spec)
    and the pretraining batch 64 (run_pretrain's spec, with targets), for
    the default and the compact layout: bytes per batch, host pack ms per
    batch (pack_batch alone, over one epoch's padded batches), the device
    decode's wall (median of 20, to a synchronize) and device busy time
    (profiler, one decode, K6's planes of the policy's levels included),
    and every decoded field of every batch of the epoch equal bit for bit
    between the two layouts on the card (the TileMeta parts with compact's
    derived flat_slot, the K6 planes, ea_bonds). (b) One epoch of packed
    geometric pretraining at batch 64 from the device packed cache, default
    then compact layout, each from the same seeded model: the wall (to a
    synchronize) and, over a second pass, the device busy time; the launch
    counts of the first pass exact (pretrain_expect: K6 once per train step
    per dp_specs level the policy reads, K1 / K2 / K4 / K5 as derived), the
    losses finite and within 1e-3 of the default's. Returns {path:
    launches}."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fragnet_tpu_torch.data import packing
    from fragnet_tpu_torch.data.batcher import (BatchLoader,
                                                DevicePackedCacheLoader)
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.optim import make_optimizer
    from fragnet_tpu_torch.train.pretrain import (PretrainTrainer,
                                                  build_pretrain_model,
                                                  split_graphs)

    popt = pt_opt(PT_OVERRIDES)
    seed, pbs = int(popt.seed), int(popt.pretrain.batch_size)
    train_pg, _ = split_graphs(pgraphs, seed)
    pspec = spec_for(pgraphs, batch_size=pbs, tcsr=True)
    policy = resolve_kernel_policy(popt.pretrain)
    planes = packing.plane_levels(policy)
    fbs = int(smoke_opt().finetune.batch_size)

    # ---- (a) bytes, host pack, device decode, equality ---------------------
    cases = {f"esol batch {fbs}": (datasets[0], fbs, spec, False),
             f"pretraining batch {pbs}": (train_pg, pbs, pspec, True)}
    for label, (graphs, bs, sp, targets) in cases.items():
        hosts = [pad_batch(w, sp, with_targets=targets, build_dense=False,
                           strict_tcsr=sp.tcsr)
                 for w in BatchLoader(graphs, bs, spec=sp)._windows()]
        decoded, stats = [], {}
        for compact in (False, True):
            loader = BatchLoader(graphs, bs, spec=sp, with_targets=targets,
                                 pack=True, pack_compact=compact)
            next(iter(loader))
            lay = loader.layout
            t0 = time.perf_counter()
            bufs = [packing.pack_batch(h, lay) for h in hosts]
            pack_ms = (time.perf_counter() - t0) * 1e3 / len(hosts)
            dbufs = [torch.from_numpy(b).to(dev) for b in bufs]
            decoded.append([packing.unpack_batch(b, lay, planes)
                            for b in dbufs])
            walls = []
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                packing.unpack_batch(dbufs[0], lay, planes)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                packing.unpack_batch(dbufs[0], lay, planes)
                torch.cuda.synchronize()
            busy, rows = _busy(prof)
            name = "compact" if compact else "default"
            stats[name] = lay.total_bytes
            encs = sorted({e.enc for e in lay.entries})
            print(f"packed {label} [{name}]: {lay.total_bytes} bytes/batch "
                  f"({len(lay.entries)} entries: {', '.join(encs)}), host "
                  f"pack {pack_ms:.3f} ms/batch over {len(hosts)} batches, "
                  f"device decode wall {statistics.median(walls[1:]):.3f} ms "
                  f"(median of 20), busy {busy:.4f} ms in {len(rows)} "
                  f"kernel kinds (planes {', '.join(planes)})")
        for i, (a, b) in enumerate(zip(*decoded)):
            bad = [f.name for f in dataclasses.fields(a)
                   if not _same_bits(getattr(a, f.name), getattr(b, f.name))]
            if bad:
                raise AssertionError(f"{label} batch {i}: the compact decode "
                                     f"differs from the default's at {bad}")
        print(f"packed {label}: compact/default bytes "
              f"{stats['compact'] / stats['default']:.4f}; every field of "
              f"{len(hosts)} decoded batches equal bit for bit")

    # ---- (b) one epoch of packed pretraining, default vs compact -----------
    expect, n_train, _n_val, levels = pretrain_expect(popt, pgraphs, 1, 0)
    losses = {}
    for compact in (False, True):
        name = "compact" if compact else "default"
        model = build_pretrain_model(
            popt, policy=policy,
            generator=torch.Generator().manual_seed(seed)).to(dev)
        optimizer, _ = make_optimizer(model.parameters(), "adam",
                                      lr=float(popt.pretrain.lr))
        loader = BatchLoader(train_pg, pbs, spec=pspec, shuffle=True,
                             seed=seed, with_targets=True, pack=True,
                             pack_compact=compact)
        next(iter(loader))
        loader._epoch = 0
        cache = DevicePackedCacheLoader(loader, seed=seed + 7, device=dev)
        trainer = PretrainTrainer(model, optimizer, layout=loader.layout,
                                  device=dev)
        torch.manual_seed(seed)  # the same dropout masks in both runs
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        step_losses = [trainer._step(b) for b in cache]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in cache:
                trainer._step(b)
            torch.cuda.synchronize()
        busy, _rows = _busy(prof)
        losses[name] = [float(x) for x in step_losses]
        print(f"packed pretraining epoch [{name}] at batch {pbs}: "
              f"{len(step_losses)} steps ({n_train} expected), wall "
              f"{wall * 1e3:.2f} ms, device busy (second pass, profiled) "
              f"{busy:.3f} ms, {loader.layout.total_bytes} bytes/batch; "
              f"losses {[round(x, 6) for x in losses[name]]}; kernels: "
              + " ".join(f"{n}={c} (expected {expect[n]})"
                         for n, c in launched.items() if c or expect[n]))
        if len(step_losses) != n_train \
                or not np.isfinite(losses[name]).all():
            raise AssertionError(f"packed pretraining [{name}]: "
                                 f"{losses[name]}")
        for n, c in launched.items():
            if c != expect[n]:
                raise AssertionError(f"{n} launched {c} times in the packed "
                                     f"pretraining epoch [{name}], expected "
                                     f"{expect[n]}")
    diff = max(abs(a - b) / max(abs(a), 1e-30)
               for a, b in zip(losses["default"], losses["compact"]))
    print(f"compact vs default pretraining losses: worst relative diff "
          f"{diff:.3e} (limit {GRAD_REL_LIMIT}); plane levels {levels}")
    if diff > GRAD_REL_LIMIT:
        raise AssertionError("compact and default pretraining disagree")
    return {"pretrain_compact": launched}


def smoke_weights(datasets):
    """(FragNetFineTune's arguments for the smoke's esol model, its seeded
    weights on the CPU)."""
    from fragnet_tpu_torch.train.finetune import model_kwargs

    opt = smoke_opt(train=True)
    model = build_model_cpu(opt, datasets[3])
    return (model_kwargs(opt, datasets[3]),
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def ep_train_batch(datasets):
    """The smoke's first train window padded under run_finetune's EP spec:
    (without kernel metadata, with 2-shard EPTileMeta at tn 128, te 256,
    the spec)."""
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.dist.edge_partition import with_ep_tile_meta
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch

    opt = smoke_opt(train=True)
    train_g, n_tasks = datasets[0], datasets[3]
    bs, seed = int(opt.finetune.batch_size), int(opt.seed)
    espec = ep_spec(datasets, bs, EP_SHARDS)
    window = next(BatchLoader(train_g, bs, spec=espec, shuffle=True,
                              seed=seed)._windows())
    plain_np = pad_batch(window, espec, n_tasks=n_tasks)
    ep_np, ok = with_ep_tile_meta(plain_np, EP_SHARDS, tn=128, te=256)
    if not ok:
        raise AssertionError("the smoke's train batch has no EP tile meta")
    return plain_np, ep_np, espec


def ep_step_ranks(kw, sd, ep_np):
    """One EP train step of the esol model on ``ep_np`` in EP_SHARDS ranks
    spawned on the card (dist/checks.py:ep_card_step_rank): each rank's
    result, layer 0's K3 forward calls included."""
    from fragnet_tpu_torch.dist import checks
    from fragnet_tpu_torch.dist.launch import run_ranks

    return run_ranks(checks.ep_card_step_rank, EP_SHARDS, (kw, sd, ep_np),
                     device="cuda", timeout_s=120, join_timeout_s=600,
                     workdir=os.path.join(REPO, "exps"))


# phase 33: the ELL neighbour-table path (ops/ell.py; the JAX package's
# spec_for(..., ell=True)) at the esol width: torch ops on the card, no
# kernel (the JAX package computes it in XLA); and the native host runtime
# (native/graphops.cc) against the Python / numpy paths
ELL_STEPS = 3
# the ELL passes in the order of one layer's calls, each beside the kernels
# that carry it under the default policy and their phase-4 level
ELL_LEVELS = (("bond", ("dense_gat_fwd", "dense_gat_bwd"), "bond (R=1)"),
              ("atom", ("tcsr_gat_fwd", "tcsr_gat_bwd"), "atom (self-loops)"),
              ("fconn", ("dense_gat_fwd", "dense_gat_bwd"), "fconn (R=6)"),
              ("frag", ("tcsr_gat_fwd", "tcsr_gat_bwd"), "frag"))


class _EllSpy:
    """Counts model/layers.py's ELL passes while in a with block, keeping
    the arguments of the first ``keep`` calls."""

    def __init__(self, keep: int = 0):
        self.calls, self.keep, self.args = 0, keep, []

    def __enter__(self):
        from fragnet_tpu_torch.model import layers

        self._mod, self._orig = layers, layers.ell_gat_pass

        def spy(*a, **kw):
            self.calls += 1
            if len(self.args) < self.keep:
                self.args.append((a, kw))
            return self._orig(*a, **kw)

        layers.ell_gat_pass = spy
        return self

    def __exit__(self, *exc):
        self._mod.ell_gat_pass = self._orig
        return False


def _no_launches(label):
    launched = {n: c for n, c in _launches().items() if c}
    if launched:
        raise AssertionError(f"{label}: kernels launched on the ELL path: "
                             f"{launched}")


def ell_adam_steps(cpu_model, batch_np, d):
    """ELL_STEPS Adam steps (lr 1e-4, dropout off) of a copy of
    ``cpu_model`` on ``batch_np`` on device ``d``: (each step's loss, the
    predictions after the last)."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.train.loop import mse_loss
    from fragnet_tpu_torch.train.optim import make_optimizer

    m = copy.deepcopy(cpu_model).to(d).eval()
    adam, _ = make_optimizer(m.parameters(), "adam", lr=1e-4)
    b = to_device(batch_np, d)
    losses = []
    for _ in range(ELL_STEPS):
        loss = mse_loss(m(b), b.y, b.graph_mask)
        loss.backward()
        adam.step()
        adam.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    with torch.no_grad():
        return losses, m(b).cpu()


def ell_level_times(model, batch_np, dev, report, rng):
    """Each ELL pass of layer 0 of one forward of ``model`` on
    ``batch_np`` (phase 4's test batch, with ELL tables), forward +
    backward alone on the card: device ms and event ms per call, beside
    the device ms of the kernels that carry the level under the default
    policy at phase 4 (forward + backward)."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.ops.ell import ell_gat_pass

    with _EllSpy(keep=len(ELL_LEVELS)) as spy, torch.no_grad():
        model(to_device(batch_np, dev))
    out = {}
    for (lvl, kernels, k_lvl), (a, kw) in zip(ELL_LEVELS, spy.args):
        nf, ea, src, nbr, mask, avec = a
        nf, ea, avec = (t.detach().clone().requires_grad_()
                        for t in (nf, ea, avec))
        g = torch.from_numpy(rng.standard_normal(tuple(nf.shape)).astype(
            "float32")).to(dev)

        def fwd_bwd():
            o, _ = ell_gat_pass(nf, ea, src, nbr, mask, avec,
                                want_attn_by_src=False,
                                num_src_nodes=kw["num_src_nodes"])
            return torch.autograd.grad(o, (nf, ea, avec), g)

        k_ms = sum(next(p["device_ms"] for p in report[k][0]
                        if p["level"] == k_lvl) for k in kernels)
        out[lvl] = dict(device_ms=_device_ms(fwd_bwd), ms=_median_ms(fwd_bwd),
                        kernel_device_ms=k_ms, K=tuple(nbr.shape),
                        kernels=kernels)
        print(f"ELL pass [{lvl}, layer 0] forward + backward: nf "
              f"{'x'.join(map(str, nf.shape))}, table "
              f"{'x'.join(map(str, nbr.shape))}: device_ms="
              f"{out[lvl]['device_ms']:.4f} ms={out[lvl]['ms']:.4f}; "
              f"{' + '.join(kernels)} at phase 4's [{k_lvl}]: device_ms="
              f"{k_ms:.4f} ({out[lvl]['device_ms'] / k_ms:.1f}x)")
    return out


def ell_phase(dev, datasets, train_win, batch_win, step_default, report,
              rng):
    """Phase 33 (a)-(e): the ELL path of FragNetFineTune at the esol
    config's width (4 layers, emb 128, 4 heads, batch 16, f32), on the
    molecules of phase 8's train batch (``train_win``) in batches built
    with spec_for(..., ell=True) (no TCSR): (a) a forward card vs CPU,
    seeded weights: predictions within 1e-3 of scale, 4 ELL passes per
    layer, no kernel launched; (b) one train step's loss and gradients
    card vs CPU (1e-3 of each scale); (c) ELL_STEPS Adam steps on each:
    every loss and the predictions after them within 1e-3, no launch; (d)
    a bf16 forward card vs CPU within 2e-2 of scale, no launch; (e) the
    same molecules with ell=True and tcsr=True run K1 / K4 (launches as
    expected_launches counts) and no ELL pass. Then, for the record, the
    ELL train step's wall and busy beside phase 8's TCSR step and each ELL
    level's forward + backward device time at layer 0 of phase 4's test
    batch (``batch_win``) beside its kernels'. Returns {step, levels}."""
    import torch

    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.model.layers import KernelPolicy

    train_g, val_g, test_g, n_tasks, _task = datasets
    opt = smoke_opt()
    L = int(opt.finetune.model.num_layer)
    bs = int(opt.finetune.batch_size)
    graphs = train_g + val_g + test_g
    spec_e = spec_for(graphs, bs, ell=True)
    ell_np = pad_batch(train_win, spec_e, n_tasks=n_tasks)
    if ell_np.atom_nbr_edge is None or ell_np.tm_atom is not None \
            or ell_np.dp_bond is not None:
        raise AssertionError("phase 33's batch is not an ELL-only batch")
    print(f"ELL spec: widths atom {spec_e.k_atom} (self-loop included), "
          f"bond line {spec_e.k_bg}, frag {spec_e.k_frag}, fconn line "
          f"{spec_e.k_fc}; slots {spec_e.n_atoms} atoms, {spec_e.n_edges} "
          f"bonds, {spec_e.n_frags} frags, {spec_e.n_fconn} connections")

    # (a) the forward
    t0 = time.perf_counter()
    cpu_model = build_model_cpu(opt, n_tasks).eval()
    model = copy.deepcopy(cpu_model).to(dev).eval()
    _reset_launches()
    with _EllSpy() as spy, torch.no_grad():
        pred_gpu = model(to_device(ell_np, dev)).cpu()
    torch.cuda.synchronize()
    _no_launches("ELL forward")
    with torch.no_grad():
        pred_cpu = cpu_model(to_device(ell_np, "cpu"))
    if tuple(pred_gpu.shape) != (bs, n_tasks) \
            or not torch.isfinite(pred_gpu).all():
        raise AssertionError(f"ELL prediction shape {tuple(pred_gpu.shape)}"
                             f" or not finite")
    err, rel = _diff(pred_gpu, pred_cpu)
    print(f"ELL forward cpu vs gpu: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(limit {FORWARD_REL_LIMIT}); {spy.calls} ELL passes (expected "
          f"{4 * L}), no kernel launched")
    if spy.calls != 4 * L or rel > FORWARD_REL_LIMIT:
        raise AssertionError("the ELL forward disagrees")

    # (b) one train step's gradients
    l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
        cpu_model, ell_np, dev)
    _no_launches("ELL train step")
    print(f"ELL train step cpu vs gpu: loss {l_cpu:.6f} / {l_gpu:.6f}; "
          f"worst relative diff {worst:.3e} ({worst_name}) over {n_par} "
          f"parameters (limit {GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("ELL: card and CPU gradients disagree")

    # (c) a few Adam steps on each
    losses_gpu, after_gpu = ell_adam_steps(cpu_model, ell_np, dev)
    _no_launches("ELL Adam steps")
    losses_cpu, after_cpu = ell_adam_steps(cpu_model, ell_np, "cpu")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_gpu,
                                                       losses_cpu))
    err, rel = _diff(after_gpu, after_cpu)
    print(f"ELL {ELL_STEPS} Adam steps: losses card {losses_gpu}, cpu "
          f"{losses_cpu} (worst rel {loss_rel:.3e}); predictions after them "
          f"max_abs_err={err:.3e} rel={rel:.3e} (limit {FORWARD_REL_LIMIT})")
    if loss_rel > FORWARD_REL_LIMIT or rel > FORWARD_REL_LIMIT:
        raise AssertionError("ELL: the Adam steps disagree")

    # (d) a bf16 forward
    opt16 = smoke_opt()
    opt16.set_path("finetune.dtype", "bf16")
    cpu16 = build_model_cpu(opt16, n_tasks).eval()
    cpu16.load_state_dict(cpu_model.state_dict())
    card16 = copy.deepcopy(cpu16).to(dev)
    _reset_launches()
    with _EllSpy() as spy16, torch.no_grad():
        p16_gpu = card16(to_device(ell_np, dev)).cpu()
    torch.cuda.synchronize()
    _no_launches("ELL bf16 forward")
    with torch.no_grad():
        p16_cpu = cpu16(to_device(ell_np, "cpu"))
    err, rel = _diff(p16_gpu, p16_cpu)
    print(f"ELL bf16 forward cpu vs gpu: max_abs_err={err:.3e} "
          f"rel={rel:.3e} (limit {BF16_PRED_LIMIT}); {spy16.calls} ELL "
          f"passes, no kernel launched")
    if spy16.calls != 4 * L or not rel <= BF16_PRED_LIMIT:
        raise AssertionError("the ELL bf16 forward disagrees")

    # (e) TCSR metadata and ELL tables together: the kernels run
    spec_b = spec_for(graphs, bs, ell=True, tcsr=True)
    both_np = pad_batch(train_win, spec_b, n_tasks=n_tasks)
    if both_np.atom_nbr_edge is None or both_np.tm_atom is None:
        raise AssertionError("phase 33 (e)'s batch lacks a table or TCSR")
    expect = expected_launches(KernelPolicy(), L,
                               [(_planes_of(both_np), 1, 0)])
    _reset_launches()
    with _EllSpy() as spy_b, torch.no_grad():
        model(to_device(both_np, dev))
    torch.cuda.synchronize()
    launched = _launches()
    print(f"ell=True, tcsr=True: {spy_b.calls} ELL passes; kernels: "
          + " ".join(f"{n}={c} (expected {expect[n]})"
                     for n, c in launched.items() if c or expect[n]))
    if spy_b.calls or launched != expect or not expect["tcsr_gat_fwd"]:
        raise AssertionError("a batch with TCSR metadata and ELL tables did "
                             "not take the kernels")
    print(f"phase 33 (a)-(e): {time.perf_counter() - t0:.1f} s")

    # for the record: the step and the passes alone
    t0 = time.perf_counter()
    step_ell = timed_train_step(model, ell_np, dev, "ELL")
    print(f"ELL train step vs phase 8's TCSR step (same molecules): wall "
          f"{step_ell['wall']:.2f} / {step_default['wall']:.2f} ms, device "
          f"busy {step_ell['busy']:.3f} / {step_default['busy']:.3f} ms, "
          f"peak {step_ell['peak_mib']:.1f} / {step_default['peak_mib']:.1f}"
          f" MiB")
    levels = ell_level_times(model, pad_batch(batch_win, spec_e,
                                              n_tasks=n_tasks),
                             dev, report, rng)
    print(f"phase 33, timings: {time.perf_counter() - t0:.1f} s")
    return {"step": step_ell, "levels": levels}


def _host_ms(fn, n: int):
    """Median host ms of ``n`` calls of ``fn`` (after one warm-up)."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def native_phase(datasets, train_np, pgraphs, feat_s, calls_after_feat):
    """Phase 33 (f): the native host runtime. It must have loaded, and
    its counters must have moved during the esol featurization (line
    graphs, ``calls_after_feat``) and the TCSR builds since (tile
    metadata). Host ms per call, native beside the Python / numpy path
    (same outputs): the atom line graph of each esol molecule and of each
    molecule of one batch-64 pretraining batch; each level's TCSR windows
    of the esol train batch and of that pretraining batch."""
    import numpy as np

    from fragnet_tpu_torch import native
    from fragnet_tpu_torch.graphs.build import (_line_graph_edges,
                                                _line_graph_edges_py)
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
    from fragnet_tpu_torch.ops.tcsr import (build_tile_meta,
                                            build_tile_meta_numpy)

    t0 = time.perf_counter()
    calls = dict(native.CALLS)
    print(f"native runtime: available {native.available()}, library "
          f"{os.path.relpath(native.so_path('g++'), REPO)}; calls after "
          f"the esol featurization {calls_after_feat}, now {calls}")
    if not native.available() or not calls_after_feat["line_graph"] \
            or calls["tile_meta_arrays"] <= calls_after_feat[
                "tile_meta_arrays"]:
        raise AssertionError("the native runtime did not run")
    pt_bs = int(PT_OVERRIDES["pretrain.batch_size"])
    esol = datasets[0] + datasets[1] + datasets[2]
    out = {}
    for label, gs in (("esol", esol), (f"pretraining batch {pt_bs}",
                                       pgraphs[:pt_bs])):
        ends = [list(zip(g.edge_index[0].tolist(), g.edge_index[1].tolist()))
                for g in gs]
        if any(_line_graph_edges(e) != _line_graph_edges_py(e)
               for e in ends):
            raise AssertionError("native and Python line graphs differ")
        nat = _host_ms(lambda: [_line_graph_edges(e) for e in ends], 5)
        py = _host_ms(lambda: [_line_graph_edges_py(e) for e in ends], 5)
        out[f"line_graph, {label}"] = (nat / len(gs), py / len(gs))
        print(f"line_graph [{label}, {len(gs)} molecules, "
              f"{sum(len(e) for e in ends)} directed bonds]: native "
              f"{nat / len(gs):.4f} ms, Python {py / len(gs):.4f} ms per "
              f"molecule ({py / nat:.1f}x)")
    spec_p = spec_for(pgraphs, pt_bs, tcsr=True)
    levels = {"atom": ("edge_src", "edge_dst", "edge_mask"),
              "bond": ("bg_src", "bg_dst", "bg_mask"),
              "frag": ("frag_src", "frag_dst", "fconn_mask"),
              "fc": ("fc_src", "fc_dst", "fc_mask")}
    for label, b in (("esol batch 16", train_np),
                     (f"pretraining batch {pt_bs}",
                      pad_batch(pgraphs[:pt_bs], spec_p))):
        for lvl, (s_, d_, m_) in levels.items():
            tm = getattr(b, f"tm_{lvl}")
            args = (getattr(b, s_), getattr(b, d_), getattr(b, m_),
                    tm.tn * tm.ew_blk.shape[0])  # the level's node slots
            kw = dict(tn=tm.tn, te=tm.te, n_chunks=tm.n_chunks,
                      k_src=tm.k_src)
            got, want = build_tile_meta(*args, **kw), \
                build_tile_meta_numpy(*args, **kw)
            if not all(np.array_equal(getattr(got, f), getattr(want, f))
                       for f in ("ew_blk", "sw_tile", "flat_slot", "cw")):
                raise AssertionError(f"native and numpy TCSR windows "
                                     f"differ [{label}, {lvl}]")
            nat = _host_ms(lambda: build_tile_meta(*args, **kw), 20)
            py = _host_ms(lambda: build_tile_meta_numpy(*args, **kw), 20)
            out[f"tile_meta, {label}, {lvl}"] = (nat, py)
            print(f"build_tile_meta [{label}, {lvl}: {args[0].shape[0]} "
                  f"edge slots, {args[3]} nodes]: native {nat:.4f} ms, "
                  f"numpy {py:.4f} ms ({py / nat:.1f}x)")
    per_mol = out["line_graph, esol"]
    print(f"esol featurization (phase 3) {feat_s:.2f} s for {len(esol)} "
          f"molecules with the native line graph; the Python one would add "
          f"~{(per_mol[1] - per_mol[0]) * len(esol) / 1e3:.3f} s")
    print(f"phase 33 (f): {time.perf_counter() - t0:.1f} s")
    return out


def build_model_cpu(opt, n_tasks):
    """The smoke's esol model, seeded, on the CPU, in the compute type and
    under the kernel policy its config names (finetune.dtype,
    finetune.kernel)."""
    import torch

    from fragnet_tpu_torch.train.fastpath import (resolve_dtype,
                                                  resolve_kernel_policy)
    from fragnet_tpu_torch.train.finetune import build_model

    return build_model(opt, n_classes=n_tasks,
                       policy=resolve_kernel_policy(opt.finetune),
                       generator=torch.Generator().manual_seed(0),
                       dtype=resolve_dtype(opt.finetune))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fragnet_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(fragnet_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs reduce in f32, as XLA's do (run_finetune sets it too)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_all = time.perf_counter()

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    # ---- 2. build ---------------------------------------------------------
    from fragnet_tpu_torch.data.batcher import BatchLoader
    from fragnet_tpu_torch.graphs.batch import to_device
    from fragnet_tpu_torch.graphs.hiergraph import pad_batch
    from fragnet_tpu_torch.obs import read_scalars
    from fragnet_tpu_torch.ops import _cuda
    from fragnet_tpu_torch.train.finetune import (build_model,
                                                  load_datasets,
                                                  run_finetune)
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    logs = _cuda.build_all([_counter(n)[1] for n in KERNELS], force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(logs)} sources, nvcc in parallel); per source: "
          + ", ".join(f"{src} {sec:.1f} s"
                      for src, sec in _cuda.BUILD_SECONDS.items()))
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # ---- 3. data ----------------------------------------------------------
    # the pretraining set featurizes in spawned processes meanwhile
    pending = PretrainGraphs(pt_opt(PT_OVERRIDES),
                             workers=max(1, (os.cpu_count() or 2) - 1))
    atexit.register(pending.close)  # a failing phase leaves none running
    opt = smoke_opt()
    t_feat = time.perf_counter()
    datasets = load_datasets(opt)
    t_feat_end = time.perf_counter()
    train_g, val_g, test_g, n_tasks, _task = datasets
    print(f"featurization: {t_feat_end - t_feat:.2f} s "
          f"({len(train_g)}/{len(val_g)}/{len(test_g)} graphs)")
    from fragnet_tpu_torch import native
    native_after_feat = dict(native.CALLS)  # phase 33 reads them
    # phase 27's sets, behind the pretraining set, once the esol set is
    # done: the main process featurizes it beside the pool
    task_graphs = TaskGraphs(pending)
    bs = int(opt.finetune.batch_size)
    spec, windows, batch_np = smoke_batch(opt, datasets)
    dev = torch.device("cuda")
    batch = to_device(batch_np, dev)
    model = build_model(opt, n_classes=n_tasks,
                        generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    t_phase = time.perf_counter()
    # ---- 4. kernel vs plain, at the shapes of a real batch ----------------
    calls = layer0_kernel_calls(int(opt.finetune.model.num_layer), model,
                                batch)
    rng = np.random.default_rng(0)
    calls["dense_gat_fwd"].append(
        seeded_fconn_call(calls["dense_gat_fwd"][1], rng))
    for name in GAT_KERNELS:
        k = KERNELS[name]
        if k.fwd is not None:
            calls[name] = [(lvl, bwd_kernel_args(k.fwd, a, kw, rng), {})
                           for lvl, a, kw in calls[k.fwd]]
    report = check_kernels(GAT_KERNELS, calls, rng)

    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 5. the prediction path -------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    rmse, ft_model = run_finetune(opt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = _launches()
    expect = finetune_expect(opt, datasets, spec, windows)[0]
    print(f"prediction path: test rmse {rmse:.5f} eval {eval_s:.2f} s "
          f"({len(windows)} test batches)")
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches.items()))
    if not np.isfinite(rmse):
        raise AssertionError(f"test rmse is not finite: {rmse}")
    for n, c in launches.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the prediction "
                                 f"path, expected {expect[n]}")

    # where the eval's time goes: a second pass over the test batches, each
    # stage timed to a synchronize, then the forward's device time under
    # the profiler
    t_pad = t_copy = t_fwd = 0.0
    for w in windows:
        t0 = time.perf_counter()
        b = pad_batch(w, spec, n_tasks=n_tasks)
        t1 = time.perf_counter()
        tb = to_device(b, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            ft_model(tb)
        torch.cuda.synchronize()
        t_pad, t_copy = t_pad + t1 - t0, t_copy + t2 - t1
        t_fwd += time.perf_counter() - t2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            ft_model(tb)
        torch.cuda.synchronize()
    dev_busy, busy = _busy(prof)
    print(f"eval breakdown ({len(windows)} batches): pad_batch "
          f"{t_pad * 1e3:.2f} ms, to_device {t_copy * 1e3:.2f} ms, forward "
          f"{t_fwd * 1e3:.2f} ms; one forward's device busy time "
          f"{dev_busy:.3f} ms in {len(busy)} kernel kinds, top: "
          + ", ".join(f"{k[:48]} {ms:.3f}" for k, ms in busy[:5]))

    print(f"phase 5: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 6. whole forward: CPU (plain versions) vs card (kernels) ---------
    cpu_model = copy.deepcopy(ft_model).cpu().eval()
    with torch.no_grad():
        pred_gpu = ft_model(to_device(batch_np, dev)).cpu()
        pred_cpu = cpu_model(to_device(batch_np, "cpu"))
    if tuple(pred_gpu.shape) != (bs, n_tasks):
        raise AssertionError(f"prediction shape {tuple(pred_gpu.shape)}")
    fwd_err, fwd_rel = _diff(pred_gpu, pred_cpu)
    print(f"forward cpu vs gpu: max_abs_err={fwd_err:.3e} rel={fwd_rel:.3e} "
          f"(limit {FORWARD_REL_LIMIT})")
    if fwd_rel > FORWARD_REL_LIMIT:
        raise AssertionError("card and CPU predictions disagree")

    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 7. the training path ---------------------------------------------
    topt = smoke_opt(train=True)
    n_epochs = int(topt.finetune.n_epochs)
    seed = int(topt.seed)
    train_loader = BatchLoader(train_g, bs, spec=spec, shuffle=True,
                               seed=seed, n_tasks=n_tasks)
    expect, n_train, n_val, _ = finetune_expect(topt, datasets, spec, windows)
    for _ in range(n_epochs):  # the run's shuffled epochs pack as counted
        if len(list(train_loader._windows())) != n_train:
            raise AssertionError("a train epoch packs more batches than "
                                 "the loader's length")
    _reset_launches()
    t0 = time.perf_counter()
    rmse_t, tr_model = run_finetune(topt, datasets=datasets, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_t = _launches()
    scal = read_scalars(topt.exp_dir)
    losses = [r["value"] for r in scal if r["tag"] == "train/loss"][-n_epochs:]
    eps = [r["value"] for r in scal
           if r["tag"] == "train/edges_per_sec"][-n_epochs:]
    print(f"training path: {n_epochs} epochs x {n_train} train batches, "
          f"{n_val} val, {len(windows)} test; test rmse {rmse_t:.5f}, "
          f"train losses {[round(x, 5) for x in losses]}, run {train_s:.2f} s")
    print("train message-edges/s per epoch: "
          + ", ".join(f"{x / 1e6:.4f}M" for x in eps))
    print("kernels: " + " ".join(f"{n}={c} (expected {expect[n]})"
                                 for n, c in launches_t.items()))
    if len(losses) != n_epochs or not np.isfinite(losses).all() \
            or not np.isfinite(rmse_t):
        raise AssertionError(f"training is not finite: losses {losses}, "
                             f"test rmse {rmse_t}")
    for n, c in launches_t.items():
        if c != expect[n]:
            raise AssertionError(f"{n} launched {c} times on the training "
                                 f"path, expected {expect[n]}")

    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 8. one train step: host time and device busy time ----------------
    train_win = next(iter(train_loader._windows()))
    train_np = pad_batch(train_win, spec, n_tasks=n_tasks)
    step_default = timed_train_step(tr_model, train_np, dev,
                                    "default policy")

    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    # ---- 9. one train step's gradients: CPU vs card -----------------------
    l_cpu, l_gpu, worst, worst_name, n_par = train_grads_card_vs_cpu(
        tr_model, train_np, dev)
    print(f"train step cpu vs gpu: loss {l_cpu:.6f} / {l_gpu:.6f}; worst "
          f"relative diff {worst:.3e} ({worst_name}) over {n_par} "
          f"parameters (limit {GRAD_REL_LIMIT})")
    if worst > GRAD_REL_LIMIT:
        raise AssertionError("card and CPU gradients disagree")

    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---- 10.-15. the pretraining path -------------------------------------
    k6_report, launches_pt, pgraphs, big_report, logit_report = \
        pretrain_phases(dev, pending, datasets)
    report[PLANES] = (k6_report, 0.0)
    for name, (levels, _err) in big_report.items():
        # the batch-512 levels stand beside the finetune layer's in the
        # kernel's line; its ms and bound stay the finetune layer's
        report[name][0].extend(dict(p, on_path=False) for p in levels)

    # ---- 16.-19. the dense-attr kernel policy ------------------------------
    attr_report, launches_fa, launches_pa, step_attr = attr_phases(
        dev, datasets, spec, windows, batch, train_np, step_default, pgraphs,
        rng)
    report.update(attr_report)

    # ---- 20.-24. edge-partitioned and data-parallel finetuning -------------
    ep_report, dist_runs, bf16_dist = ep_dp_phases(
        dev, datasets, spec, train_np, step_default, rng)
    report.update(ep_report)

    # ---- 25. interpretability: attention weights and contributions ------
    t_phase = time.perf_counter()
    interp_report, interp_paths = interp_phase(
        os.path.join(topt.exp_dir, topt.finetune.chkpoint_name), n_tasks,
        rng)
    for name, levels in interp_report.items():
        # the interpret path's levels stand beside the finetune layer's
        report[name][0].extend(dict(p, on_path=False) for p in levels)
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")

    # ---- 26. the models on the gat2 encoder ---------------------------------
    t_phase = time.perf_counter()
    family_paths, _steps, _post = family_phase(
        dev, datasets, spec, windows, batch_np, train_np, rng)
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s")

    # ---- 27. the DTA and CDRP tasks ----------------------------------------
    t_phase = time.perf_counter()
    task_paths, task_levels, _task_steps, _encoders = task_phase(
        dev, task_graphs, datasets, spec, windows, rng)
    pending.close()
    # where the pool's work fell: the task sets' own wall is from the later
    # of their queueing and the pretraining set's end to their own end
    at = {k: v - t_all for k, v in pending.ready.items()}
    queued = task_graphs.t0 - t_all
    task_end = max(at["dta"], at["cdrp"])
    print(f"host timeline (s after the start): esol featurization "
          f"{t_feat - t_all:.2f}-{t_feat_end - t_all:.2f} (main process); "
          f"pool of {pending.workers}: pretraining set "
          f"{pending.t0 - t_all:.2f}-{at['pretrain']:.2f}, task sets queued "
          f"at {queued:.2f}, done at {task_end:.2f} (dta {at['dta']:.2f}, "
          f"cdrp {at['cdrp']:.2f}), {task_end - max(queued, at['pretrain']):.2f}"
          f" s of the pool's wall")
    for name, levels in task_levels.items():
        # the DTA batch's levels stand beside the finetune layer's
        report[name][0].extend(dict(p, on_path=False) for p in levels)
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")

    # ---- 28. the model variants and ablations --------------------------
    t_phase = time.perf_counter()
    variant_paths, v1_levels, _variant_steps, _aggs = variant_phase(
        dev, datasets, spec, windows, batch_np, train_np, rng)
    for name, levels in v1_levels.items():
        # v1 gat's bond level stands beside the finetune layer's
        report[name][0].extend(dict(p, on_path=False) for p in levels)
    print(f"phase 28: {time.perf_counter() - t_phase:.1f} s")

    # ---- 29. HP search, CV, bucketed finetuning, auxiliary pretraining ----
    t_phase = time.perf_counter()
    p29_paths, p29_levels = phase29(dev, datasets, rng)
    for name, levels in p29_levels.items():
        # the widest trial's and the smallest bucket's levels stand beside
        # the finetune layer's
        report[name][0].extend(dict(p, on_path=False) for p in levels)
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s")

    # ---- 30. bf16 compute on the main path ---------------------------------
    t_phase = time.perf_counter()
    bf16_report, launches_16 = bf16_phase(dev, datasets, spec, windows,
                                          batch_np, train_np, step_default,
                                          rng)
    report.update(bf16_report)
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s")

    # ---- 31. bf16 on the rest of the bf16 paths ----------------------------
    t_phase = time.perf_counter()
    rest_report, rest_paths, rest_main = bf16_rest_phase(
        dev, datasets, spec, windows, batch_np, train_np, step_attr,
        pgraphs, bf16_dist, rng)
    report.update(rest_report)
    in_ranks = bf16_dist["ep_s"] + bf16_dist["dp_s"]
    print(f"phase 31: {time.perf_counter() - t_phase + in_ranks:.1f} s "
          f"({in_ranks:.1f} s of it in phase 22's and 23's ranks); build of "
          f"the sources of its entries: "
          + ", ".join(f"{src} {_cuda.BUILD_SECONDS[src]:.1f} s"
                      for src in sorted({KERNELS[n].source.rsplit("/", 1)[1]
                                         for n in ATTR_BF16 + EP_BF16})))

    # ---- 32. the compact packing encodings ---------------------------------
    t_phase = time.perf_counter()
    compact_paths = compact_phase(dev, datasets, spec, pgraphs)
    print(f"phase 32: {time.perf_counter() - t_phase:.1f} s")

    # ---- 33. the ELL path and the native host runtime -----------------------
    t_phase = time.perf_counter()
    ell_phase(dev, datasets, train_win, windows[0], step_default, report,
              rng)
    native_phase(datasets, train_np, pgraphs, t_feat_end - t_feat,
                 native_after_feat)
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s")

    paths = {"finetune_train": launches_t, "pretrain": launches_pt,
             "finetune_bf16_train": launches_16,
             "finetune_attr_train": launches_fa, "pretrain_attr": launches_pa,
             **interp_paths, **family_paths, **task_paths, **variant_paths,
             **p29_paths, **rest_paths, **compact_paths}
    for run, per_rank in dist_runs.items():
        for r, counts in enumerate(per_rank):
            paths[f"{run}_rank{r}"] = counts
    out = []
    for name, (per_level, seeded_err) in report.items():
        # a GAT kernel: one layer's levels of one finetune batch; the plane
        # builder: its two levels of one batch-512 pretrain step
        on_path = [p for p in per_level if p.get("on_path", True)]
        tot_bytes = sum(p["bytes"] for p in on_path)
        tot_flops = sum(p["flops"] for p in on_path)
        _, by = _bound_ms(tot_bytes, tot_flops)
        # K9 runs in K8's launches: its source, counts and times are K8's
        counted = EMIT_IN if name == EMIT else name
        out.append({
            "name": name, "route": "cuda",
            "source": KERNELS[counted].source,
            "replaces": (EMIT_REPLACES if name == EMIT
                         else KERNELS[name].replaces),
            **({"computed_in": EMIT_IN} if name == EMIT else {}),
            "launches": (rest_main["attr"] if name in ATTR_BF16
                         else rest_main["ep"] if name in EP_BF16
                         else launches_pa if counted in ATTR_KERNELS
                         else dist_runs["finetune_ep"][0] if name in EP_KERNELS
                         else launches_16 if name in GAT_BF16
                         else launches_pt)[counted],
            "launches_by_path": {p: c[counted] for p, c in paths.items()},
            "max_abs_err": max([seeded_err]
                               + [p["max_abs_err"] for p in per_level]),
            "ms": sum(p["ms"] for p in on_path),
            "plain_ms": sum(p["plain_ms"] for p in on_path),
            "bound_ms": sum(p["bound_ms"] for p in on_path),
            "bound_by": by,
            "library_ms": (sum(p["library_ms"] for p in on_path)
                           if name in (PLANES, EMIT) else None),
            "levels": per_level,
        })
    # the logit kernels: launches from the pretraining paths (the others'
    # counts are not kept), levels from phase 13's batch-512 step, where the
    # backward wrapper's ms and plain ms stand on gat_logits_bwd
    for name, (per_level, _err) in logit_report.items():
        by_key = lambda k: (None if per_level[0][k] is None
                            else sum(p[k] for p in per_level))
        out.append({
            "name": name, "route": "cuda", "source": LOGIT_SOURCE,
            "replaces": LOGIT_REPLACES,
            "launches": launches_pt[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()
                                 if name in c},
            "max_abs_err": max(p["max_abs_err"] for p in per_level),
            "max_ulps": max(p["max_ulps"] for p in per_level),
            "ms": by_key("ms"), "plain_ms": by_key("plain_ms"),
            "device_ms": by_key("device_ms"),
            "plain_device_ms": by_key("plain_device_ms"),
            "bound_ms": by_key("bound_ms"),
            "bound_by": _bound_ms(by_key("bytes"), by_key("flops"),
                                  F64_FLOPS)[1],
            "library_ms": None,
            "levels": per_level,
        })
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
