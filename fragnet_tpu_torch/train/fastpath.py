"""Fast-path policy for the port (counterpart of
fragnet_tpu/train/fastpath.py): device, compute dtype, TCSR batches and the
per-level kernel policy, resolved in one place for every entry point.

  * ``device`` — CUDA unless the caller asks for the CPU; a CUDA request
    with no card raises instead of falling back;
  * ``dtype``  — the compute type (``dtype: f32|bf16``), f32 by default:
    the JAX package picks bf16 only on a TPU (fastpath.py:85), and the
    card is not one. bf16 runs for the families of ``_DTYPE_FAMILIES``
    (``supports_dtype``; build_model builds the others in f32, as the JAX
    package does) under every kernel policy and every ``dist.mode``, in
    finetuning and in both pretraining trainers, through the bf16 forms of
    the GAT kernels (K1-K5, K7, K8; K6 widens bf16 attributes). The task
    trainer (``run_task``) raises on bf16 (``require_f32``): the JAX
    package's DTA and CDRP models take no dtype and run f32;
  * ``tcsr``   — on by default on CUDA for the families that run GAT
    passes (TCSR_FAMILIES: those on the gat2 encoder, and gat2_lite,
    gat2_edge and v1 gat, which the JAX package leaves out because it runs
    them on its segment path), so batches carry TCSR tile metadata and
    tile-aligned dense planes (``align`` follows it,
    graphs/hiergraph.py:spec_for) and every GAT pass runs a kernel. That
    holds under ``dist.mode=dp`` too (the JAX package turns TCSR off there
    and runs the segment path, which the port has on the CPU only). Under
    ``dist.mode=ep`` it means per-shard EPTileMeta (the K3 kernels) and is
    on for every device, as the JAX package's is on the TPU; with it off
    (or ``dist.tcsr=false``) EP runs its segment mode;
  * ``kernel`` — the per-level KernelPolicy from ``kernel.*`` config keys;
  * ``cache``  — the finetune/pretrain section's ``cache``: 'auto' wraps a
    loader in DeviceCacheLoader (data/batcher.py) when its padded batches
    fit ``CACHE_BUDGET_BYTES`` (the JAX package's 4 GB budget, not tuned
    for the GPU), 'on' always does, 'off' never does (``maybe_cache``). A
    cached loader fixes batch composition after its first pass and
    reshuffles batch order per epoch, as the JAX package's does, so the two
    packages draw the same batches from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from fragnet_tpu_torch.model.layers import KernelPolicy

# model families whose layers consume TCSR tile metadata: the FragNet
# core and the variants whose GAT passes run on its kernels on the card
# (gcn2, gcn and gcn3 run no GAT pass)
TCSR_FAMILIES = frozenset({"gat2", "gat2_masked", "gat2_masked2",
                           "gat2_transformer", "gat2_transformer2",
                           "gat2_multitask", "gat2_lite", "gat2_edge",
                           "gat"})

# families that accept a compute dtype: the JAX package's _DTYPE_FAMILIES,
# its TCSR_FAMILIES (fastpath.py:33-41) — gat2, the models on its encoder
# and the masked pretraining models
_DTYPE_FAMILIES = frozenset({"gat2", "gat2_masked", "gat2_masked2",
                             "gat2_transformer", "gat2_transformer2",
                             "gat2_multitask"})

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "fp32": torch.float32,
           "float32": torch.float32}

# device budget for dataset caching (the JAX package's conservative value;
# leaves room for parameters, activations and workspace)
CACHE_BUDGET_BYTES = 4 << 30


@dataclasses.dataclass(frozen=True)
class FastPath:
    tcsr: bool
    device: torch.device
    cache: str = "auto"      # 'auto' | 'on' | 'off'
    kernel: KernelPolicy = KernelPolicy()
    dtype: torch.dtype = torch.float32

    @property
    def dtype_name(self) -> str:
        return "bf16" if self.dtype == torch.bfloat16 else "f32"


def supports_dtype(model_version: str) -> bool:
    """Whether ``model_version``'s model takes a compute dtype (the JAX
    package's supports_dtype)."""
    return model_version in _DTYPE_FAMILIES


def resolve_dtype(section) -> torch.dtype:
    """The section's ``dtype``: f32 (the default) or bf16."""
    dname = str(section.get("dtype", "f32")).lower()
    if dname not in _DTYPES:
        raise ValueError(f"unknown dtype {dname!r} (bf16|f32)")
    return _DTYPES[dname]


def require_f32(section, entry: str) -> None:
    """Raise when the config section of ``entry``, a trainer of the JAX
    package that runs f32 only, asks for bf16 — never a quiet f32 run."""
    if resolve_dtype(section) != torch.float32:
        raise NotImplementedError(
            f"{entry} runs f32 only: the reference's task trainers build "
            f"their models without a compute dtype "
            f"(fragnet_tpu/train/tasks.py), so dtype=bf16 has no "
            f"counterpart there")


def reduce_bf16_gemms_in_f32(fp: FastPath) -> None:
    """A bf16 run on CUDA: bf16 GEMMs reduce in f32, as XLA's do (cuBLAS
    may otherwise reduce split-K partial sums in bf16)."""
    if fp.dtype == torch.bfloat16 and fp.device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when CUDA is asked for (or defaulted to) and no card
    is present — the port never drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def resolve_kernel_policy(section) -> KernelPolicy:
    """Per-level kernel strategy from the config subtree's ``kernel.*`` keys
    (``kernel.bond=planes|tcsr``, ``kernel.fc=planes|attr|tcsr``,
    ``kernel.attr=true|false``); ``bond=attr`` is refused by KernelPolicy.
    Config keys only: the JAX package's ``FRAGNET_DENSE_*`` environment
    overrides are not carried over."""
    ksec = section.get("kernel", {}) if hasattr(section, "get") else {}
    getk = ksec.get if hasattr(ksec, "get") else (lambda k, d: d)
    return KernelPolicy(bond=str(getk("bond", "planes")),
                        fc=str(getk("fc", "planes")),
                        attr=bool(getk("attr", False)))


def resolve_cache(section) -> str:
    """The section's ``cache`` policy: 'auto', 'on' or 'off'."""
    cache = str(section.get("cache", "auto")).lower()
    if cache not in ("auto", "on", "off"):
        raise ValueError(f"unknown cache policy {cache!r} (auto|on|off)")
    return cache


def resolve(section, model_version: str = "gat2",
            device: Union[str, torch.device, None] = None,
            dist_mode: str = "none") -> FastPath:
    """``section`` is the finetune/pretrain config subtree (supports .get);
    ``dist_mode`` the run's ``dist.mode`` (none|dp|ep)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(section)
    kernel = resolve_kernel_policy(section)
    tcsr_default = model_version in TCSR_FAMILIES and (
        dev.type == "cuda" or dist_mode == "ep")
    tcsr = bool(section.get("tcsr", tcsr_default))
    return FastPath(tcsr=tcsr, device=dev, cache=resolve_cache(section),
                    kernel=kernel, dtype=dtype)


def padded_batch_bytes(spec, n_tasks: int = 1) -> int:
    """Upper-bound bytes of one padded HierGraphBatch (f32/i32 leaves)."""
    b = 0
    b += spec.n_atoms * (167 + 1 + 1 + 1) * 4           # x_atoms, masks, segs
    b += spec.n_edges * (2 + 17 + 1 + 17) * 4           # ei, attr, mask, nf
    b += spec.n_bg_edges * (2 + 1 + 1) * 4
    b += spec.n_frags * (167 + 1 + 1) * 4
    b += spec.n_fconn * (2 + 6 + 1 + 6) * 4
    b += spec.n_fc_edges * (2 + 6 + 1) * 4
    b += spec.n_graphs * (n_tasks + 1) * 4
    return b


def maybe_cache(loader, device, spec=None, n_tasks: int = 1,
                policy: str = "auto", seed: int = 0,
                budget: int = CACHE_BUDGET_BYTES):
    """Wrap a BatchLoader in DeviceCacheLoader on ``device`` when the padded
    dataset fits the budget (or the policy forces it). Returns the loader
    unchanged when caching is off or the set does not fit."""
    if policy == "off":
        return loader
    if policy == "auto":
        spec = spec if spec is not None else getattr(loader, "spec", None)
        if spec is None:
            return loader
        if padded_batch_bytes(spec, n_tasks) * max(1, len(loader)) > budget:
            return loader
    from fragnet_tpu_torch.data.batcher import DeviceCacheLoader

    return DeviceCacheLoader(loader, seed=seed, device=device)


def epoch_message_edges(graphs, num_layer: int) -> float:
    """Real message edges processed per epoch over all four graph levels
    (incl. atom self-loops) × num_layer — the bench.py metric definition."""
    total = 0
    for g in graphs:
        total += (g.n_edges + g.n_atoms + g.n_bg_edges
                  + g.n_fconn + g.n_fc_edges)
    return float(total) * num_layer

