"""Fast-path policy for the port (counterpart of
fragnet_tpu/train/fastpath.py): device, compute dtype, TCSR batches and the
per-level kernel policy, resolved in one place for every entry point.

  * ``device`` — CUDA unless the caller asks for the CPU; a CUDA request
    with no card raises instead of falling back;
  * ``dtype``  — f32 only in this slice (bf16 raises, ROADMAP.md);
  * ``tcsr``   — on by default on CUDA for the gat2 family, so batches carry
    TCSR tile metadata and tile-aligned dense planes (``align`` follows it,
    graphs/hiergraph.py:spec_for) and every GAT pass runs a kernel;
  * ``kernel`` — the per-level KernelPolicy from ``kernel.*`` config keys;
  * ``finetune.cache`` — 'auto' and 'off' run uncached (the
    train loader reshuffles molecules per epoch; the JAX package's
    DeviceCacheLoader, which instead reshuffles the order of cached batches,
    is not ported), 'on' raises (ROADMAP.md Queue A6). The JAX package also
    runs uncached under 'auto' whenever the padded set exceeds its budget.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from fragnet_tpu_torch.model.layers import KernelPolicy

# model families whose layers consume TCSR tile metadata (FragNet core)
TCSR_FAMILIES = frozenset({"gat2"})


@dataclasses.dataclass(frozen=True)
class FastPath:
    tcsr: bool
    device: torch.device
    kernel: KernelPolicy = KernelPolicy()


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
    (``kernel.bond=planes|tcsr``, ``kernel.fc=planes|tcsr``,
    ``kernel.attr=false``)."""
    ksec = section.get("kernel", {}) if hasattr(section, "get") else {}
    getk = ksec.get if hasattr(ksec, "get") else (lambda k, d: d)
    return KernelPolicy(bond=str(getk("bond", "planes")),
                        fc=str(getk("fc", "planes")),
                        attr=bool(getk("attr", False)))


def resolve_cache(section) -> None:
    """Checks ``finetune.cache``: the port always runs uncached (see the
    module docstring), so 'on' raises."""
    cache = str(section.get("cache", "auto")).lower()
    if cache not in ("auto", "on", "off"):
        raise ValueError(f"unknown cache policy {cache!r} (auto|on|off)")
    if cache == "on":
        raise NotImplementedError(
            "finetune.cache=on: the device-resident dataset cache "
            "(DeviceCacheLoader) is not ported yet (ROADMAP.md Queue A6); "
            "use auto or off (both run uncached)")


def resolve(section, model_version: str = "gat2",
            device: Union[str, torch.device, None] = None) -> FastPath:
    """``section`` is the finetune config subtree (supports .get)."""
    dev = resolve_device(device)
    dname = str(section.get("dtype", "f32")).lower()
    if dname in ("bf16", "bfloat16"):
        raise NotImplementedError(
            "finetune.dtype=bf16 is not ported yet: this slice runs f32 "
            "(ROADMAP.md, later items: bf16)")
    if dname not in ("f32", "fp32", "float32"):
        raise ValueError(f"unknown dtype {dname!r} (bf16|f32)")
    tcsr_default = dev.type == "cuda" and model_version in TCSR_FAMILIES
    tcsr = bool(section.get("tcsr", tcsr_default))
    resolve_cache(section)
    return FastPath(tcsr=tcsr, device=dev,
                    kernel=resolve_kernel_policy(section))


def epoch_message_edges(graphs, num_layer: int) -> float:
    """Real message edges processed per epoch over all four graph levels
    (incl. atom self-loops) × num_layer — the bench.py metric definition."""
    total = 0
    for g in graphs:
        total += (g.n_edges + g.n_atoms + g.n_bg_edges
                  + g.n_fconn + g.n_fc_edges)
    return float(total) * num_layer

