"""Carry weights from the JAX package into the port.

``state_dict_from_jax`` turns fragnet_tpu's flax params (a nested dict of
numpy arrays, with or without the top-level ``"params"`` key) into the
port's ``state_dict``, under the reference torch names that
fragnet_tpu/train/checkpoint.py:_torch_key_to_flax maps the other way:

  pretrain/layers_{i}/{projection_b,...}/{kernel,bias}
                               → pretrain.layers.{i}.{projection_b,...}.{weight,bias}
  pretrain/layers_{i}/{a_b,a,f,f_a_b} → pretrain.layers.{i}.{a_b,a,f,f_a_b}
  head/_MLPHead_0/predictor_{k}/*     → fthead.predictor.{k}.*
  head/{lin1,out,dense,out_proj}/*    → fthead.{lin1,out,dense,out_proj}.*

Dense kernels (in, out) become Linear weights (out, in).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LINEARS = ("projection_b", "projection_a", "projection_fb",
            "edge_attr_bond_embed", "edge_attr_fbond_embed")
_LEAF = {"kernel": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _torch_name(path: Tuple[str, ...]) -> str:
    key = "/".join(path)
    m = re.fullmatch(r"pretrain/layers_(\d+)/(a_b|a|f|f_a_b)", key)
    if m:
        return f"pretrain.layers.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"pretrain/layers_(\d+)/(\w+)/(kernel|bias)", key)
    if m and m.group(2) in _LINEARS:
        return f"pretrain.layers.{m.group(1)}.{m.group(2)}.{_LEAF[m.group(3)]}"
    m = re.fullmatch(r"head/_MLPHead_0/predictor_(\d+)/(kernel|bias)", key)
    if m:
        return f"fthead.predictor.{m.group(1)}.{_LEAF[m.group(2)]}"
    m = re.fullmatch(r"head/(lin1|out|dense|out_proj)/(kernel|bias)", key)
    if m:
        return f"fthead.{m.group(1)}.{_LEAF[m.group(2)]}"
    raise KeyError(f"no port parameter for flax param {key!r}")


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fragnet_tpu FragNetFineTune params → the port's ``state_dict``
    (f32 CPU tensors); raises KeyError on a param the port has no name
    for."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, val in _flatten(tree):
        arr = np.asarray(val, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        out[_torch_name(path)] = torch.from_numpy(np.array(arr, copy=True))
    return out
