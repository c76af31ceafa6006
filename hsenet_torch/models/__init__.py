"""Models of the port: ViT towers, packers, the Phi decoder, the VLM."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `generator`, in place.

    Dense weights are normal with std 1/sqrt(fan_in) (flax's lecun_normal
    without truncation), embeddings, position embeddings and the CLS token
    normal with std 0.02, norm scales 1 and biases and LoRA B 0. For runs
    that need no checkpoint: the generator fixes the weights, on the
    device where the module lives."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "lora_b"):
            p.zero_()
        elif leaf == "weight" and p.ndim == 1:  # LayerNorm / RMSNorm scale
            p.fill_(1.0)
        elif leaf in ("pos_embed", "cls_token") or name.endswith("embed.weight"):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        elif leaf == "lora_a":
            p.normal_(0.0, 1.0 / p.shape[1], generator=generator)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return module
