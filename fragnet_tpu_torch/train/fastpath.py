"""Fast-path policy for the port (counterpart of
fragnet_tpu/train/fastpath.py): device, compute dtype, TCSR batches and the
per-level kernel policy, resolved in one place for every entry point.

  * ``device`` — CUDA unless the caller asks for the CPU; a CUDA request
    with no card raises instead of falling back;
  * ``dtype``  — f32 only in this slice (bf16 raises, ROADMAP.md);
  * ``tcsr``   — on by default on CUDA for the gat2 family, so batches carry
    TCSR tile metadata and tile-aligned dense planes (``align`` follows it,
    graphs/hiergraph.py:spec_for) and every GAT pass runs a kernel;
  * ``kernel`` — the per-level KernelPolicy from ``kernel.*`` config keys.
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
    return FastPath(tcsr=tcsr, device=dev,
                    kernel=resolve_kernel_policy(section))

