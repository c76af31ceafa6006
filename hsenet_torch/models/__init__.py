"""Models of the port: ViT towers, packers, the Phi decoder, the VLM, BERT
and the CLIP dual encoder."""

from __future__ import annotations

import math

import torch
from torch import nn

# CLIP's learnable logit scale starts at log(1/0.07)
LOGIT_SCALE_INIT = math.log(1 / 0.07)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `generator`, in place.

    Dense weights are normal with std 1/sqrt(fan_in) (flax's lecun_normal
    without truncation), embedding tables, position embeddings, the CLS
    token and QFormer's learned queries normal with std 0.02, norm scales 1, biases and LoRA B 0, and
    CLIP's logit scale log(1/0.07). For runs that need no checkpoint: the
    generator fixes the weights, on the device where the module lives."""
    tables = {f"{name}.weight" for name, m in module.named_modules()
              if isinstance(m, nn.Embedding)}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "lora_b"):
            p.zero_()
        elif leaf == "logit_scale":
            p.fill_(LOGIT_SCALE_INIT)
        elif leaf == "weight" and p.ndim == 1:  # LayerNorm / RMSNorm scale
            p.fill_(1.0)
        elif leaf in ("pos_embed", "cls_token", "query_embeds") or name in tables:
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        elif leaf == "lora_a":
            p.normal_(0.0, 1.0 / p.shape[1], generator=generator)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return module
