"""Carry a flax parameter tree over to the port's modules.

`flax_to_torch(params)` takes the nested dict that a JAX package model's
`init` returns (leaves as numpy arrays, or anything `np.asarray` reads) and
returns a state_dict that the matching port module accepts with
`load_state_dict(..., strict=True)`:

  * Dense `kernel` (in, out) -> Linear `weight` (out, in);
  * LayerNorm / RMSNorm `scale` -> `weight`; `bias` stays `bias`;
  * Embed `embedding` -> `weight` (it also serves the tied LM head);
  * `pos_embed`, `cls_token`, `lora_a`, `lora_b`, CLIP's 0-d
    `logit_scale` and a W8A8 dense's 0-d `act_scale` keep name and layout;
  * int8 leaves become the int8 / f32 buffers of the port's modules and
    keep their dtype: `kernel_q` (in, out) int8 -> `weight_q` (out, in),
    transposed like `kernel`, so that one output channel is one
    contiguous row of codes, the layout the int8 matvec kernel reads;
    `kernel_scale` -> `weight_scale`; a `QuantEmbed`'s `embedding_q` and
    its per-row `scale` keep name and layout;
  * `nn.scan` stacks (`tower/blocks` of the ViT towers, `decoder/layers`
    of the Phi decoder, `language_encoder/layers` of CLIP's BERT) are
    unstacked on axis 0 into `ModuleList` entries.

A leaf of any other name raises, so nothing is dropped silently.

`load_flax(module, params)` loads the whole tree (LoRA leaves included)
into a port module, strictly; for a training module it checks that every
leaf that requires grad arrived as an f32 master.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_SCAN_STACKS = (("tower", "blocks"), ("decoder", "layers"),
                ("language_encoder", "layers"))
_SAME_NAME = ("bias", "pos_embed", "cls_token", "lora_a", "lora_b",
              "embedding_q", "logit_scale", "act_scale")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _leaf(name: str, value: np.ndarray, path,
          quant_embed: bool = False) -> Tuple[str, np.ndarray]:
    if name in ("kernel", "kernel_q"):
        if value.ndim != 2:
            raise ValueError(f"{'/'.join(path)}: Dense kernel of shape {value.shape}")
        return ("weight" if name == "kernel" else "weight_q"), value.T
    if name == "kernel_scale":
        return "weight_scale", value
    if name == "scale" and quant_embed:  # a QuantEmbed's per-row scales
        return "scale", value
    if name in ("scale", "embedding"):
        return "weight", value
    if name in _SAME_NAME:
        return name, value
    raise KeyError(f"no torch counterpart for flax leaf {'/'.join(path)}")


def _stack_at(path: Tuple[str, ...]):
    for i in range(len(path) - 1):
        if path[i:i + 2] in _SCAN_STACKS:
            return i + 2
    return None


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (with or without the top "params" key) -> state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    flat = dict(_flatten(params))
    for path, value in flat.items():
        value = np.asarray(value)
        if value.dtype != np.int8:
            value = value.astype(np.float32)
        quant_embed = path[:-1] + ("embedding_q",) in flat
        at = _stack_at(path)
        if at is None:
            name, arr = _leaf(path[-1], value, path, quant_embed)
            state[".".join(path[:-1] + (name,))] = torch.tensor(arr)
            continue
        for i, layer_value in enumerate(value):  # unstack the scan axis
            name, arr = _leaf(path[-1], layer_value, path, quant_embed)
            key = path[:at] + (str(i),) + path[at:-1] + (name,)
            state[".".join(key)] = torch.tensor(arr)
    return state


def load_flax(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax param tree into `module` (strict). Each leaf takes the
    dtype of the module's parameter; a parameter that requires grad must be
    f32, so trainable leaves keep the tree's f32 values exactly."""
    low = [name for name, p in module.named_parameters()
           if p.requires_grad and p.dtype != torch.float32]
    if low:
        raise ValueError(
            f"trainable parameters must be held in f32 before loading: {low[:4]}"
        )
    module.load_state_dict(flax_to_torch(params), strict=True)
    return module
