"""Compute primitives: masked segment ops (PyTorch) and the fused GAT
kernels (CUDA, csrc/) with their plain PyTorch versions."""
