"""Stage-1 CLIP train step (the port of the JAX package's train/stage1.py):
vision and text forward, symmetric InfoNCE over the batch, gradients over
every parameter, one AdamW update.

As in the JAX package the step always draws its dropout stream from
(rng, step): the trainer passes `fold_seed(seed, step)` and the step seeds
its generator from that and the state's step count. The data-parallel mesh
and the sequence-parallel loss (the JAX package's `mesh` and `loss_fn`
hooks, `parallel/sp.py`) come with the port's SP slice; this step runs on
one card.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from hsenet_torch.models.layers import dropout_rng
from hsenet_torch.train.losses import clip_contrastive_loss, retrieval_accuracy
from hsenet_torch.train.train_state import AdamW
from hsenet_torch.train.vlm import make_masked_train_step

Batch = Dict[str, torch.Tensor]


def stage1_loss_fn(model: nn.Module, batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Contrastive loss of one batch (`image`, `input_ids`, optional
    `attention_mask`); dropout on, drawing from `generator`, unless it is
    None."""
    with dropout_rng(generator):
        image_features, text_features, scale = model(
            batch["image"], batch["input_ids"], batch.get("attention_mask"),
            deterministic=generator is None,
        )
    loss, logits_i, _ = clip_contrastive_loss(image_features, text_features,
                                              scale)
    metrics = {
        "loss": loss,
        "retrieval_acc": retrieval_accuracy(logits_i),
        # a copy: the scale may be the parameter, which the update changes
        "logit_scale": scale.detach().clone(),
    }
    return loss, metrics


def make_stage1_train_step(model: nn.Module, tx: AdamW):
    """`train_step(state, batch, rng) -> (state, metrics)` over the state's
    trainable leaves (every parameter, under an optimizer without a mask);
    `rng` is an int seed, required (see the module docstring)."""
    step = make_masked_train_step(functools.partial(stage1_loss_fn, model), tx)

    def train_step(state, batch: Batch, rng: int):
        return step(state, batch, int(rng))

    return train_step
