"""The filter's weights between the Flax layout and the port's state_dict.

The JAX package keeps the filter as a Flax ``{"params", "batch_stats"}``
tree (its ``models/torch_import.py`` maps a reference state_dict into it);
this module goes both ways, on numpy arrays:

  input_embedding                      <-> Dense_0
  block{1,2}.{conv1,normal_layer1,conv2}
                                       <-> ConvBlock_{0,1}.{Conv_0,BatchNorm_0,Conv_1}
  classify{1,2,3}.{prj,classify.fc1,classify.fc2}
                                       <-> Classify_{0,1,2}.{Dense_0,MLP2_0.Dense_0,MLP2_0.Dense_1}
  transformer.input_embedding          <-> Dense_1
  transformer.position_encoding.weight <-> position_encoding
  transformer.transformer_encoder.layers.i.{self_attn,norm1,linear1,linear2,norm2}
      <-> EncoderLayer_i.{MultiHeadDotProductAttention_0,LayerNorm_0,Dense_0,Dense_1,LayerNorm_1}

Layouts: a Linear weight (out, in) is the transpose of the Flax kernel; a
Conv1d weight (out, in, k) is the Flax kernel (k, in, out) transposed; the
packed ``in_proj_weight`` (3h, h) holds the per-head Flax query, key and
value kernels (in, heads, head_dim), head-major; ``out_proj.weight`` (h, h)
is the Flax ``out`` kernel (heads, head_dim, h) flattened and transposed;
BatchNorm ``running_mean`` / ``running_var`` are Flax's ``mean`` / ``var``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import FilterModelConfig

_ENC = "transformer.transformer_encoder.layers"


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _flax_modules(cfg: FilterModelConfig):
    """(state_dict prefix, Flax path, kind) for every parameterised layer."""
    out = [("input_embedding", ("Dense_0",), "dense")]
    for b in (0, 1):
        blk, cls = f"block{b + 1}", f"classify{b + 1}"
        out += [(f"{blk}.conv1", (f"ConvBlock_{b}", "Conv_0"), "conv"),
                (f"{blk}.normal_layer1", (f"ConvBlock_{b}", "BatchNorm_0"),
                 "bn"),
                (f"{blk}.conv2", (f"ConvBlock_{b}", "Conv_1"), "conv")]
        out += _classify(cls, f"Classify_{b}")
    out.append(("transformer.input_embedding", ("Dense_1",), "dense"))
    for i in range(cfg.transformer_layers):
        p, f = f"{_ENC}.{i}", f"EncoderLayer_{i}"
        out += [(f"{p}.self_attn", (f, "MultiHeadDotProductAttention_0"),
                 "mha"),
                (f"{p}.norm1", (f, "LayerNorm_0"), "ln"),
                (f"{p}.linear1", (f, "Dense_0"), "dense"),
                (f"{p}.linear2", (f, "Dense_1"), "dense"),
                (f"{p}.norm2", (f, "LayerNorm_1"), "ln")]
    out += _classify("classify3", "Classify_2")
    return out


def _classify(name: str, flax_name: str):
    return [(f"{name}.prj", (flax_name, "Dense_0"), "dense"),
            (f"{name}.classify.fc1", (flax_name, "MLP2_0", "Dense_0"),
             "dense"),
            (f"{name}.classify.fc2", (flax_name, "MLP2_0", "Dense_1"),
             "dense")]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_dict_from_flax(variables, cfg: FilterModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """The port's FilterModel state_dict from a Flax variables tree."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for name, path, kind in _flax_modules(cfg):
        p = _get(params, path)
        if kind == "dense":
            sd[f"{name}.weight"] = _f32(p["kernel"]).T
            sd[f"{name}.bias"] = _f32(p["bias"])
        elif kind == "conv":
            sd[f"{name}.weight"] = _f32(p["kernel"]).transpose(2, 1, 0)
            sd[f"{name}.bias"] = _f32(p["bias"])
        elif kind in ("bn", "ln"):
            sd[f"{name}.weight"] = _f32(p["scale"])
            sd[f"{name}.bias"] = _f32(p["bias"])
            if kind == "bn":
                s = _get(stats, path)
                sd[f"{name}.running_mean"] = _f32(s["mean"])
                sd[f"{name}.running_var"] = _f32(s["var"])
        else:  # mha
            qkv = [_f32(p[part]["kernel"]) for part in ("query", "key", "value")]
            h = qkv[0].shape[0]
            sd[f"{name}.in_proj_weight"] = np.concatenate(
                [k.reshape(h, -1).T for k in qkv], axis=0)
            sd[f"{name}.in_proj_bias"] = np.concatenate(
                [_f32(p[part]["bias"]).reshape(-1)
                 for part in ("query", "key", "value")])
            out = _f32(p["out"]["kernel"])
            sd[f"{name}.out_proj.weight"] = out.reshape(-1, out.shape[-1]).T
            sd[f"{name}.out_proj.bias"] = _f32(p["out"]["bias"])
    sd["transformer.position_encoding.weight"] = _f32(
        params["position_encoding"])
    tensors = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    for b in (1, 2):
        tensors[f"block{b}.normal_layer1.num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)
    return tensors


def flax_from_state_dict(sd, cfg: FilterModelConfig) -> dict:
    """The Flax ``{"params", "batch_stats"}`` tree (numpy float32) of a
    port or reference state_dict."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}
    heads = cfg.transformer_heads
    for name, path, kind in _flax_modules(cfg):
        if kind == "dense":
            leaf = {"kernel": _f32(sd[f"{name}.weight"].T),
                    "bias": _f32(sd[f"{name}.bias"])}
        elif kind == "conv":
            leaf = {"kernel": _f32(sd[f"{name}.weight"].transpose(2, 1, 0)),
                    "bias": _f32(sd[f"{name}.bias"])}
        elif kind in ("bn", "ln"):
            leaf = {"scale": _f32(sd[f"{name}.weight"]),
                    "bias": _f32(sd[f"{name}.bias"])}
            if kind == "bn":
                _put(stats, path, {
                    "mean": _f32(sd[f"{name}.running_mean"]),
                    "var": _f32(sd[f"{name}.running_var"])})
        else:  # mha
            w = sd[f"{name}.in_proj_weight"]
            b = sd[f"{name}.in_proj_bias"]
            h = w.shape[1]
            leaf = {part: {"kernel": _f32(w[i * h:(i + 1) * h].T.reshape(
                               h, heads, h // heads)),
                           "bias": _f32(b[i * h:(i + 1) * h].reshape(
                               heads, h // heads))}
                    for i, part in enumerate(("query", "key", "value"))}
            leaf["out"] = {
                "kernel": _f32(sd[f"{name}.out_proj.weight"].T.reshape(
                    heads, h // heads, h)),
                "bias": _f32(sd[f"{name}.out_proj.bias"])}
        _put(params, path, leaf)
    params["position_encoding"] = _f32(
        sd["transformer.position_encoding.weight"])
    return {"params": params, "batch_stats": stats}


_GATES = ("i", "f", "g", "o")   # torch's stacking order of the LSTM gates


def bilstm_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The port's BiLSTMFilter state_dict from the JAX package's Flax
    ``params`` (numpy or jax arrays).  ``BiLSTM_i/OptimizedLSTMCell_0`` is
    the forward cell and ``_1`` the backward one; a cell's input kernels
    ``ii/if/ig/io`` (in, h) have no bias, its hidden kernels ``hi/hf/hg/ho``
    (h, h) do.  torch stacks the gates i, f, g, o and transposes them; the
    hidden biases become ``bias_hh`` and ``bias_ih`` is zero."""
    sd: Dict[str, np.ndarray] = {
        "embed.weight": _f32(params["Embed_0"]["embedding"])}
    for i in range(4):
        for cell, suffix in (("OptimizedLSTMCell_0", ""),
                             ("OptimizedLSTMCell_1", "_reverse")):
            c = params[f"BiLSTM_{i}"][cell]
            pre = f"lstms.{i}.lstm."
            sd[pre + "weight_ih_l0" + suffix] = np.concatenate(
                [_f32(c["i" + g]["kernel"]).T for g in _GATES])
            sd[pre + "weight_hh_l0" + suffix] = np.concatenate(
                [_f32(c["h" + g]["kernel"]).T for g in _GATES])
            bias = np.concatenate([_f32(c["h" + g]["bias"]) for g in _GATES])
            sd[pre + "bias_hh_l0" + suffix] = bias
            sd[pre + "bias_ih_l0" + suffix] = np.zeros_like(bias)
    for j, name in ((0, "dense1"), (1, "dense2")):
        sd[f"{name}.weight"] = _f32(params[f"Dense_{j}"]["kernel"]).T
        sd[f"{name}.bias"] = _f32(params[f"Dense_{j}"]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
