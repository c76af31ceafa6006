"""Stage-1 CLIP train step (the port of the JAX package's train/stage1.py):
vision and text forward, symmetric InfoNCE over the batch, gradients over
every parameter, one AdamW update.

As in the JAX package the step always draws its dropout stream from
(rng, step): the trainer passes `fold_seed(seed, step)` and the step seeds
its generator from that and the state's step count.

Over a data-parallel mesh (a model that `parallel.sharding.shard_params`
placed) the loss is the global one: every rank all-gathers the features
of the whole batch with a gradient (`parallel.mesh.gather_with_grad`, whose
backward sums each shard's gradient over the ranks) and computes the same
(B, B) logits; the train step's mean over dp then gives the single-card
gradient. The sequence-parallel step, with the vision tower over the ring,
is `parallel.sp.make_sp_stage1_train_step`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from hsenet_torch.models.layers import dropout_rng
from hsenet_torch.parallel.mesh import gather_with_grad
from hsenet_torch.train.losses import clip_contrastive_loss, retrieval_accuracy
from hsenet_torch.train.train_state import AdamW
from hsenet_torch.train.vlm import make_masked_train_step
from hsenet_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def global_features(model: nn.Module, *features: torch.Tensor,
                    grad: bool = True):
    """Each (B_local, D) tensor gathered over the model's dp ranks to the
    global batch (rank order), with a gradient unless `grad` is False;
    unchanged without a dp axis."""
    from hsenet_torch.parallel.mesh import all_gather, axis_group, axis_size

    mesh = model.__dict__.get("mesh")
    if axis_size(mesh, "dp") == 1:
        return features
    group = axis_group(mesh, "dp")
    return tuple(gather_with_grad(f, group, 0) if grad
                 else all_gather(f, group, 0) for f in features)


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
    image_features, text_features = global_features(
        model, image_features, text_features)
    with span("model.head_loss"):
        loss, logits_i, _ = clip_contrastive_loss(image_features,
                                                  text_features, scale)
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
