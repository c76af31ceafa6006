"""Models of the port: ViT towers, packers, the Phi decoder, the VLM, BERT,
the CLIP dual encoders, SegVol and its Swin encoder."""

from __future__ import annotations

import math

import torch
from torch import nn

# CLIP's learnable logit scale starts at log(1/0.07)
LOGIT_SCALE_INIT = math.log(1 / 0.07)
# SegVol's Fourier matrix and its prompt and output token tables
UNIT_NORMAL = ("gaussian_matrix", "point_embeddings", "not_a_point_embed",
               "no_mask_embed", "iou_token", "mask_tokens")


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `generator`, in place.

    Dense weights are normal with std 1/sqrt(fan_in) (flax's lecun_normal
    without truncation; a transposed convolution's fan-in counts its
    kernel's voxels), embedding tables, position embeddings, the CLS token,
    QFormer's learned queries and Swin's bias tables normal with std 0.02,
    SegVol's `UNIT_NORMAL` leaves normal with std 1, norm scales 1, biases
    and LoRA B 0, and CLIP's logit scale log(1/0.07). For runs that need no checkpoint: the
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
        elif (leaf in ("pos_embed", "cls_token", "query_embeds",
                       "relative_position_bias_table") or name in tables):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf in UNIT_NORMAL:
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf == "weight" and p.ndim == 5:  # ConvTranspose3d (in, out, k...)
            p.normal_(0.0, 1.0 / math.sqrt(p[:, 0].numel()), generator=generator)
        elif leaf == "weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        elif leaf == "lora_a":
            p.normal_(0.0, 1.0 / p.shape[1], generator=generator)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return module
