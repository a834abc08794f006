"""fragnet_tpu_torch — the PyTorch/CUDA port of fragnet_tpu for NVIDIA H100.

Same layout and names as ``fragnet_tpu`` (the JAX reference), so each module
has a counterpart there. The port imports ``torch`` and never ``jax``,
``flax`` or anything under ``fragnet_tpu``: host code it needs is copied.
Every TPU (Pallas) kernel on a ported path has a hand-written CUDA kernel
for ``sm_90a`` under ``csrc/``, built on first use (ops/_cuda.py). Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
