"""Legacy masked-contrastive CLIP training (the port of the JAX package's
train/legacy_clip.py; the reference's `M3DCLIP`, model/CLIP.py).

loss = unmasked_CL + 0.1 * masked_CL. The mask ratio follows a Gaussian
ramp from `initial_mask_ratio` to `max_mask_ratio` (the reference's
update_mask_ratio, CLIP.py:54-72; production max 0.4, temperature 1e-4),
and the masked stream keeps the top (1 - ratio) patches by slice-guided
score (`models.vit.MaskedViT3D`).

The ratio is cut to `num_buckets` token counts, as in the JAX package.
PyTorch compiles nothing per shape, but the buckets decide the masked
stream's length and so the numbers: the port keeps them so that both
packages train on the same streams.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from hsenet_torch.models.layers import dropout_rng
from hsenet_torch.train.losses import clip_contrastive_loss, retrieval_accuracy
from hsenet_torch.train.train_state import AdamW
from hsenet_torch.train.vlm import make_masked_train_step

Batch = Dict[str, torch.Tensor]


def update_mask_ratio(step: float, initial_mask_ratio: float = 0.05,
                      max_mask_ratio: float = 0.4,
                      temperature_factor: float = 1e-4) -> float:
    """The Gaussian ramp (CLIP.py:54-72, production args CLIP.py:141-146)."""
    growth = math.exp(-((step * temperature_factor) ** 2))
    ratio = initial_mask_ratio + (max_mask_ratio - initial_mask_ratio) * (
        1 - growth)
    return min(ratio, max_mask_ratio)


def bucketed_unmasked_tokens(step: int, num_patches: int,
                             num_buckets: int = 8, **ratio_kwargs) -> int:
    """The masked stream's token count at `step`: the unmasked share of
    `num_patches` rounded to a multiple of num_patches // num_buckets."""
    ratio = update_mask_ratio(step, **ratio_kwargs)
    unmasked = num_patches * (1.0 - ratio)
    bucket = max(1, num_patches // num_buckets)
    return max(bucket, int(round(unmasked / bucket)) * bucket)


def masked_clip_loss_fn(model: nn.Module, batch: Batch, unmasked_tokens: int,
                        generator: Optional[torch.Generator] = None,
                        masked_loss_weight: float = 0.1
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Both streams' contrastive losses over one batch (`image`,
    `input_ids`, `attention_mask`, `image_2d`); dropout on, drawing from
    `generator`, unless it is None."""
    with dropout_rng(generator):
        img_f, img_f_masked, txt_f, scale = model(
            batch["image"], batch["input_ids"], batch.get("attention_mask"),
            batch["image_2d"], unmasked_tokens,
            deterministic=generator is None,
        )
    loss_unmasked, logits_i, _ = clip_contrastive_loss(img_f, txt_f, scale)
    loss_masked, _, _ = clip_contrastive_loss(img_f_masked, txt_f, scale)
    loss = loss_unmasked + masked_loss_weight * loss_masked
    return loss, {
        "loss": loss,
        "loss_unmasked": loss_unmasked,
        "loss_masked": loss_masked,
        "retrieval_acc": retrieval_accuracy(logits_i),
    }


def make_masked_clip_train_step(model: nn.Module, tx: AdamW,
                                masked_loss_weight: float = 0.1):
    """`train_step(state, batch, rng, unmasked_tokens) -> (state, metrics)`:
    the gradient over every trainable parameter of the state and one AdamW
    update. `rng` is an int seed, required: the step's dropout generator is
    seeded from it and the state's step count, as the port's stage-1 step
    does."""

    def train_step(state, batch: Batch, rng: int, unmasked_tokens: int):
        loss_fn = functools.partial(
            masked_clip_loss_fn, model, unmasked_tokens=int(unmasked_tokens),
            masked_loss_weight=masked_loss_weight)
        state, metrics = make_masked_train_step(
            lambda b, g: loss_fn(b, generator=g), tx)(state, batch, int(rng))
        metrics.pop("grad_norm")  # the JAX step reports no norm
        return state, metrics

    return train_step
