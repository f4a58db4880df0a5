"""Parameters of the JAX package <-> the port's `state_dict`.

The JAX `QwenFamilyModel.init` returns {"params": {...}} whose top-level keys
are flax module paths such as "layers_3/self_attn" or "embed_tokens", holding
numpy-convertible arrays. The mapping to the port's parameter names:

  layers_{i}/...                 -> layers.{i}....
  Dense  .../kernel [in, out]    -> nn.Linear .weight [out, in] (transposed)
  Dense  .../bias                -> .bias
  RMSNorm .../scale              -> .weight
  Embed  .../embedding           -> nn.Embedding .weight
  experts_gate/up/down [E, ...]  -> kept stacked, same layout

The enc-dec tree (`models/generative/encdec.py`) maps by the same rules:
its flax module names ("encoder_{i}/self_attn", "decoder_{i}/mlp", ...) are
the port's module paths, so "encoder_0/self_attn/q/kernel" becomes
`encoder_0.self_attn.q.weight`, "decoder_0/self_attn/rel_bias/embedding"
`decoder_0.self_attn.rel_bias.weight`, "decoder_1/ln3/scale"
`decoder_1.ln3.weight`, and the stacked `experts_wi`/`experts_wo` and
`shared_wi`/`shared_wo`, "shared/embedding", "encoder_norm",
"decoder_norm" and an untied "lm_head" follow.

The RQ-VAE tokenizer (`models/tokenizer/rqvae.py`) names its modules as
flax does ("encoder/Dense_0", "decoder/BatchNorm_2", "codebooks"), so its
trees map by the same rules; its "batch_stats" collection (the BatchNorms'
running "mean" and "var") maps to the buffers of the same names, e.g.
"encoder/BatchNorm_0/var" to `encoder.BatchNorm_0.var`.

`to_flax` maps the other way (port tensors, e.g. parameters or their
grads, into the flax tree of a template), and `flax_path` names a port
parameter as flax does. Only numpy crosses the boundary, so this module
imports neither JAX nor the JAX package; the tests use it to run both
packages on the same weights and to compare grads and updates name by name.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def torch_name(flax_path: str) -> tuple[str, bool]:
    """(port parameter name, whether the array is transposed) of a flax path."""
    parts = [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in flax_path.split("/")]
    leaf = parts[-1]
    transpose = leaf == "kernel"
    if leaf in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts), transpose


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`params` is what the JAX model's init returns (with or without the
    outer "params" key; beside it a "batch_stats" collection maps too);
    arrays may be jax or numpy arrays."""
    trees = [params["params"], params.get("batch_stats", {})] if "params" in params else [params]
    flat = {}
    for tree in trees:
        flat.update(_flatten(tree))
    state = {}
    for path, arr in flat.items():
        name, transpose = torch_name(path)
        a = np.asarray(arr, dtype=np.float32)
        state[name] = torch.from_numpy(np.array(a.T if transpose else a, copy=True))
    return state


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy JAX parameters into `model` (every parameter must be matched);
    values are cast to the model's (fp32) dtype and moved to its device."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def to_flax(tensors: Mapping[str, torch.Tensor], template: Mapping[str, Any]) -> dict:
    """Port tensors by parameter name -> numpy arrays in the nested layout of
    `template` (a flax params tree, with or without the outer "params";
    every collection beside it, e.g. "batch_stats", maps too)."""
    def build(tree: Mapping[str, Any], prefix: str) -> dict:
        out = {}
        for key, value in tree.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                out[key] = build(value, path)
            else:
                name, transpose = torch_name(path)
                a = tensors[name].detach().float().cpu().numpy()
                out[key] = a.T if transpose else a
        return out

    if "params" in template:
        return {col: build(tree, "") for col, tree in template.items()}
    return build(template, "")


def flax_path(model: torch.nn.Module, name: str) -> str:
    """The flax path of port parameter `name` (inverse of `torch_name`):
    a Linear's weight is "kernel", an Embedding's "embedding", any other
    module's "weight" (the RMSNorms) "scale"."""
    mod_name, _, leaf = name.rpartition(".")
    if leaf == "weight":
        mod = model.get_submodule(mod_name)
        leaf = ("kernel" if isinstance(mod, torch.nn.Linear)
                else "embedding" if isinstance(mod, torch.nn.Embedding) else "scale")
    path = re.sub(r"(^|\.)layers\.(\d+)", r"\1layers_\2", mod_name)
    return "/".join([*path.split("."), leaf]) if path else leaf
