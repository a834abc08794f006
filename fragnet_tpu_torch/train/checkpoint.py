"""Checkpoints of the port, and carrying weights from the JAX package into
it (counterpart of fragnet_tpu/train/checkpoint.py).

``save_params`` / ``load_params`` write and read a torch ``state_dict`` of
f32 CPU tensors under the reference torch names (gat2.py), so a port
checkpoint is exactly what ``fragnet_tpu.train.checkpoint.
import_torch_state_dict`` reads, and a reference checkpoint loads here.
Encoder transfer from a pretrain checkpoint comes with pretraining
(ROADMAP.md Queue A7).

``state_dict_from_jax`` turns fragnet_tpu's flax params (a nested dict of
numpy arrays, with or without the top-level ``"params"`` key) into the
port's ``state_dict``, under the reference torch names that
fragnet_tpu/train/checkpoint.py:_torch_key_to_flax maps the other way:

  pretrain/layers_{i}/{projection_b,...}/{kernel,bias}
                               → pretrain.layers.{i}.{projection_b,...}.{weight,bias}
  pretrain/layers_{i}/{a_b,a,f,f_a_b} → pretrain.layers.{i}.{a_b,a,f,f_a_b}
  head/_MLPHead_0/predictor_{k}/*     → fthead.predictor.{k}.*
  head/{lin1,out,dense,out_proj}/*    → fthead.{lin1,out,dense,out_proj}.*
  head/{_MLPHead_0/,}_PReLU_0/alpha   → fthead.act.weight  (act=prelu)
  head/bl_reduce_layer/*              → head.bl_reduce_layer.*   (pretrain)
  head/{bl,ba,da,FC}_layers/layers_{k}/* → head.{bl,ba,da,FC}_layers.{k}.*

and, for the models on the gat2 encoder (model/transformer.py), under the
names fragnet_tpu/train/checkpoint.py:_torch_key_to_flax_transformer reads:

  {atom,frag}_transformer/lin_{query,key,value,skip}/*
                               → {atom,frag}_transformer.lin_*.*
  {lin1,out}/*                        → {lin1,out}.*
  transformer{,2}/layers_{i}/self_attn/{qkv_proj,o_proj}/*
                               → transformer{,2}.layers.{i}.self_attn.*.*
  transformer{,2}/layers_{i}/norm{1,2}/{scale,bias}
                               → transformer{,2}.layers.{i}.norm{1,2}.{weight,bias}
  transformer{,2}/layers_{i}/linear_net_{0,3}/*
                               → transformer{,2}.layers.{i}.linear_net.{0,3}.*
  ms_heads_{i}/*                      → ms_heads.{i}.*

and, for the variants and ablations (model/variants.py,
model/ablations.py), under the names of the JAX package's
``_torch_key_to_flax_{lite,edge,gcn2,gat1}`` mappers:

  pretrain/layers_{i}/{atom_embed,edge_embed,cnx_attr_transform}/*
                               → pretrain.layers.{i}.{...}.*
  pretrain/layers_{i}/frag_mlp_{0,1}/* → pretrain.layers.{i}.frag_mlp.{0,2}.*
  (family="gat") pretrain/layers_{i}/… → pretrain.layer{i+1}.…

and, for the DTA and CDRP models (model/dta.py, model/cdrp.py), under the
names fragnet_tpu/train/checkpoint.py:import_dta_state_dict and its
``cdrp`` mapper read:

  drug_model/<encoder path>           → drug_model.<its name above>
  target_model/{word,position}_embeddings/embedding
                               → target_model.emb.{word,position}_embeddings.weight
  target_model/LayerNorm_0/{scale,bias} → target_model.emb.LayerNorm.{gamma,beta}
  target_model/layers/<leaf> (stacked over depth, one slice per layer)
                               → target_model.encoder.layer.{i}.<_DTA_LAYER[leaf]>
  target_model/{embedding_xt,conv_xt_1,fc1_xt}/* → {embedding_xt,conv_xt_1,fc1_xt}.*
  cell_model/predictor_{k}/*          → cell_model.predictor.{k}.*
  {fc1,fc2}/*                         → {fc1,fc2}.*

The attention's DenseGeneral kernels, (emb, H, Dh) and (H, Dh, emb), become
(H·Dh, emb) and (emb, H·Dh) Linear weights and its (H, Dh) biases flat
vectors; the CNN's Conv kernel (k, in, out) becomes the Conv1d weight
(out, in, k).

Dense kernels (in, out) become Linear weights (out, in); the scalar PReLU
slope becomes the (1,) weight of ``nn.PReLU``. The way back is the JAX
package's ``import_torch_state_dict``, whose mappers skip
``fthead.act.weight``: a port checkpoint with ``act=prelu`` crosses back
only with its slope given to the JAX side by hand (the JAX package is the
reference and is not changed for it).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

_LINEARS = ("projection_b", "projection_a", "projection_fb",
            "edge_attr_bond_embed", "edge_attr_fbond_embed", "atom_embed",
            "edge_embed", "cnx_attr_transform")
_FRAG_MLP = {"frag_mlp_0": "frag_mlp.0", "frag_mlp_1": "frag_mlp.2"}
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}


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
    if m and (m.group(2) in _LINEARS or m.group(2) in _FRAG_MLP):
        mod = _FRAG_MLP.get(m.group(2), m.group(2))
        return f"pretrain.layers.{m.group(1)}.{mod}.{_LEAF[m.group(3)]}"
    m = re.fullmatch(r"head/_MLPHead_0/predictor_(\d+)/(kernel|bias)", key)
    if m:
        return f"fthead.predictor.{m.group(1)}.{_LEAF[m.group(2)]}"
    m = re.fullmatch(r"head/(lin1|out|dense|out_proj)/(kernel|bias)", key)
    if m:
        return f"fthead.{m.group(1)}.{_LEAF[m.group(2)]}"
    if re.fullmatch(r"head/(_MLPHead_0/)?_PReLU_0/alpha", key):
        return "fthead.act.weight"
    m = re.fullmatch(r"(atom_transformer|frag_transformer)/"
                     r"(lin_query|lin_key|lin_value|lin_skip)/(kernel|bias)",
                     key)
    if m:
        return f"{m.group(1)}.{m.group(2)}.{_LEAF[m.group(3)]}"
    m = re.fullmatch(r"(lin1|out|ms_heads_\d+)/(kernel|bias)", key)
    if m:
        return f"{m.group(1).replace('ms_heads_', 'ms_heads.')}." \
               f"{_LEAF[m.group(2)]}"
    m = re.fullmatch(r"(transformer2?)/layers_(\d+)/(self_attn/qkv_proj|"
                     r"self_attn/o_proj|norm1|norm2|linear_net_0|"
                     r"linear_net_3)/(kernel|bias|scale)", key)
    if m:
        sub = m.group(3).replace("/", ".").replace("linear_net_",
                                                   "linear_net.")
        return f"{m.group(1)}.layers.{m.group(2)}.{sub}.{_LEAF[m.group(4)]}"
    m = re.fullmatch(r"head/bl_reduce_layer/(kernel|bias)", key)
    if m:
        return f"head.bl_reduce_layer.{_LEAF[m.group(1)]}"
    m = re.fullmatch(r"head/(bl|ba|da|FC)_layers/layers_(\d+)/(kernel|bias)",
                     key)
    if m:
        return f"head.{m.group(1)}_layers.{m.group(2)}.{_LEAF[m.group(3)]}"
    raise KeyError(f"no port parameter for flax param {key!r}")


# a stacked protein-transformer leaf (its path under target_model/layers)
# → (the torch name inside target_model.encoder.layer.{i}, its kind)
_DTA_LAYER = {
    "attn/query/kernel": ("attention.self.query.weight", "qkv"),
    "attn/query/bias": ("attention.self.query.bias", "flat"),
    "attn/key/kernel": ("attention.self.key.weight", "qkv"),
    "attn/key/bias": ("attention.self.key.bias", "flat"),
    "attn/value/kernel": ("attention.self.value.weight", "qkv"),
    "attn/value/bias": ("attention.self.value.bias", "flat"),
    "attn/out/kernel": ("attention.output.dense.weight", "out"),
    "attn/out/bias": ("attention.output.dense.bias", "flat"),
    "ln1/scale": ("attention.output.LayerNorm.gamma", "flat"),
    "ln1/bias": ("attention.output.LayerNorm.beta", "flat"),
    "ffn1/kernel": ("intermediate.dense.weight", "out"),
    "ffn1/bias": ("intermediate.dense.bias", "flat"),
    "ffn2/kernel": ("output.dense.weight", "out"),
    "ffn2/bias": ("output.dense.bias", "flat"),
    "ln2/scale": ("output.LayerNorm.gamma", "flat"),
    "ln2/bias": ("output.LayerNorm.beta", "flat"),
}


def _task_entries(path: Tuple[str, ...], arr: np.ndarray):
    """The port's (name, array) entries for a leaf of the DTA or CDRP
    models' own modules (not the drug encoder), or None for another
    leaf."""
    key = "/".join(path)
    if path[0] == "target_model" and len(path) > 2 and path[1] == "layers":
        name, kind = _DTA_LAYER[key[len("target_model/layers/"):]]
        out = []
        for i, a in enumerate(arr):  # one slice per layer
            if kind == "qkv":        # (emb, H, Dh) → (H·Dh, emb)
                a = a.reshape(a.shape[0], -1).T
            elif kind == "out":      # (H, Dh, emb) or (in, out) → (out, in)
                a = a.reshape(-1, a.shape[-1]).T
            else:
                a = a.reshape(-1)
            out.append((f"target_model.encoder.layer.{i}.{name}", a))
        return out
    m = re.fullmatch(r"target_model/(word|position)_embeddings/embedding",
                     key)
    if m:
        return [(f"target_model.emb.{m.group(1)}_embeddings.weight", arr)]
    m = re.fullmatch(r"target_model/LayerNorm_0/(scale|bias)", key)
    if m:
        leaf = {"scale": "gamma", "bias": "beta"}[m.group(1)]
        return [(f"target_model.emb.LayerNorm.{leaf}", arr)]
    m = re.fullmatch(r"target_model/(embedding_xt|conv_xt_1|fc1_xt)/"
                     r"(embedding|kernel|bias)", key)
    if m:
        if m.group(2) == "embedding":
            return [(f"{m.group(1)}.weight", arr)]
        if m.group(2) == "kernel":  # Dense (in, out); Conv (k, in, out)
            arr = arr.transpose(tuple(range(arr.ndim))[::-1])
        return [(f"{m.group(1)}.{_LEAF[m.group(2)]}", arr)]
    m = re.fullmatch(r"cell_model/predictor_(\d+)/(kernel|bias)", key)
    if m:
        return [(f"cell_model.predictor.{m.group(1)}.{_LEAF[m.group(2)]}",
                 arr.T if m.group(2) == "kernel" else arr)]
    m = re.fullmatch(r"(fc1|fc2)/(kernel|bias)", key)
    if m:
        return [(f"{m.group(1)}.{_LEAF[m.group(2)]}",
                 arr.T if m.group(2) == "kernel" else arr)]
    return None


def state_dict_from_jax(params: Mapping[str, Any],
                        family: str = "gat2") -> Dict[str, torch.Tensor]:
    """fragnet_tpu FragNetFineTune, FragNetPreTrain,
    FragNetFineTuneTransformer{,2}, FragNetFineTuneMultiTask, the variants
    and ablations, DTAModel (either protein encoder) or CDRPModel params →
    the port's ``state_dict`` (f32 CPU tensors); raises KeyError on a param
    the port has no name for. ``family`` is the model_version the params
    belong to: the same JAX path has another torch name in v1 ``gat``,
    whose layers are ``pretrain.layer{i+1}``; every other family (and the
    pretraining, DTA and CDRP models) takes the default. gcn and gcn3 get
    gcn2's names; the JAX package has no mapper for them, so their port
    checkpoints have no way back."""
    from fragnet_tpu_torch.train.finetune import MODEL_VERSIONS

    if family not in MODEL_VERSIONS:
        raise ValueError(f"unknown family {family!r}")
    tree = params["params"] if "params" in params else params
    out = {}
    for path, val in _flatten(tree):
        arr = np.asarray(val, dtype=np.float32)
        entries = _task_entries(path, arr)
        if entries is None:
            prefix = ""
            if path[0] == "drug_model":  # the DTA / CDRP drug encoder
                prefix, path = "drug_model.", path[1:]
            if path[-1] == "kernel":
                arr = arr.T
            elif path[-1] == "alpha":
                arr = arr.reshape(1)
            entries = [(prefix + _torch_name(path), arr)]
        if family == "gat":  # the reference's fixed attributes layer1..
            entries = [(re.sub(r"^pretrain\.layers\.(\d+)\.",
                               lambda m: f"pretrain.layer{int(m[1]) + 1}.",
                               name), a) for name, a in entries]
        for name, a in entries:
            out[name] = torch.from_numpy(np.array(a, copy=True))
    return out


def save_params(model_or_state_dict: Union[torch.nn.Module,
                                           Mapping[str, torch.Tensor]],
                path: str) -> None:
    """Write the ``state_dict`` (of a module, or as given) to ``path`` with
    ``torch.save``, every tensor as a detached CPU copy."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)


def load_params(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a ``state_dict`` written by ``save_params`` (or by the reference)
    into ``model`` (strict names and shapes) on the model's device."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model


def transfer_pretrained_encoder(model: torch.nn.Module,
                                pretrain_state: Mapping[str, torch.Tensor]
                                ) -> torch.nn.Module:
    """Copy the encoder — every ``pretrain.*`` entry — of a pretrain
    ``state_dict`` (a port pretrain checkpoint) into
    ``model`` (the JAX package's transfer_pretrained_encoder,
    checkpoint.py:435). Every encoder entry of ``model`` must be present
    with its shape; the head keeps its own parameters."""
    own = model.state_dict()
    enc = {k: v for k, v in pretrain_state.items() if k.startswith("pretrain.")}
    want = {k for k in own if k.startswith("pretrain.")}
    if set(enc) != want:
        raise KeyError(f"encoder entries differ: missing "
                       f"{sorted(want - set(enc))[:5]}, unexpected "
                       f"{sorted(set(enc) - want)[:5]}")
    for k, v in enc.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: checkpoint {tuple(v.shape)} vs model "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(enc, strict=False)
    return model
