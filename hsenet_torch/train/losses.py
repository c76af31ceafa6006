"""Losses of the port's training paths (the JAX package's train/losses.py).

  * `clip_contrastive_loss`: symmetric InfoNCE over the batch, logits in
    f32 (CLIP stages 1 and 2);
  * `relation_regulation_loss` + `relation_weight`: stage 2's MSE between
    the frozen teacher's and the student's logit matrices, weighted
    0.1 (1 - step/5000) and 0 from step 5000 on;
  * `retrieval_accuracy`: the in-training diagonal argmax accuracy;
  * `masked_lm_loss`: the VLM finetune's next-token loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from hsenet_torch.utils.profiling import span

IGNORE_INDEX = -100


def masked_lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) with -100 = ignore
    shift: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal-LM cross-entropy in f32; returns (loss, token_accuracy), both
    means over the positions whose label is not -100 (0 when there is
    none)."""
    with span("model.head_loss"):
        loss_sum, hits, count = _masked_lm_sums(logits, labels, shift)
        denom = count.clamp(min=1)
        return loss_sum / denom, hits / denom


def _masked_lm_sums(logits, labels, shift):
    """(summed cross-entropy, correct argmax count, counted positions) over
    the positions whose (shifted) label is not -100."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe_labels = torch.where(valid, labels, 0).long()
    ce = F.cross_entropy(
        logits.float().flatten(0, 1), safe_labels.flatten(), reduction="none"
    ).view(safe_labels.shape)
    hits = valid & (logits.argmax(dim=-1) == safe_labels)
    return torch.where(valid, ce, 0.0).sum(), hits.sum(), valid.sum()


def masked_lm_loss_global(logits: torch.Tensor, labels: torch.Tensor, group,
                          dp: int, shift: bool = True):
    """`masked_lm_loss` of the global batch whose rows are split over the
    data-parallel `group` of `dp` ranks: (loss_to_differentiate, loss,
    token_accuracy). The loss is the token mean over the whole global batch
    (the JAX package's `sum() / denom` over global arrays), so the summed
    loss and the token count are both summed over the group. The first item
    is this rank's summed loss over the global count, times dp: its
    gradient averaged over dp is the gradient of the global loss."""
    from hsenet_torch.parallel.mesh import all_reduce

    with span("model.head_loss"):
        local, hits, count = _masked_lm_sums(logits, labels, shift)
        totals = all_reduce(torch.stack([local.detach(), hits.float(),
                                         count.float()]), group)
        denom = totals[2].clamp(min=1)
        return local * dp / denom, totals[0] / denom, totals[1] / denom


def clip_contrastive_loss(
    image_features: torch.Tensor,  # (B, D), L2-normalised
    text_features: torch.Tensor,  # (B, D), L2-normalised
    logit_scale: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, logits_per_image, logits_per_text): the mean of the image->text
    and text->image cross-entropies. The logits are the products of the
    features summed in f32, times the scale."""
    logits_per_image = logit_scale * torch.matmul(
        image_features.float(), text_features.float().t())
    logits_per_text = logits_per_image.t()
    if labels is None:
        labels = torch.arange(image_features.shape[0],
                              device=image_features.device)
    loss_i = F.cross_entropy(logits_per_image, labels)
    loss_t = F.cross_entropy(logits_per_text, labels)
    return (loss_i + loss_t) / 2.0, logits_per_image, logits_per_text


def relation_regulation_loss(
    teacher_logits_per_image: torch.Tensor,
    teacher_logits_per_text: torch.Tensor,
    student_logits_per_image: torch.Tensor,
    student_logits_per_text: torch.Tensor,
) -> torch.Tensor:
    """Mean squared distance of the student's logit matrices from the
    teacher's, whose gradient is stopped."""
    t_i = teacher_logits_per_image.detach()
    t_t = teacher_logits_per_text.detach()
    loss_i = (t_i - student_logits_per_image).pow(2).mean()
    loss_t = (t_t - student_logits_per_text).pow(2).mean()
    return (loss_i + loss_t) / 2.0


def relation_weight(step: int, max_weighted_step: int = 5000,
                    base_weight: float = 0.1) -> torch.Tensor:
    """base_weight (1 - step/max_weighted_step) before max_weighted_step,
    else 0, as an f32 scalar tensor."""
    w = base_weight * (1.0 - step / max_weighted_step)
    return torch.tensor(w if step < max_weighted_step else 0.0,
                        dtype=torch.float32)


def retrieval_accuracy(logits_per_image: torch.Tensor) -> torch.Tensor:
    """Mean of the image->text and text->image diagonal argmax accuracies."""
    labels = torch.arange(logits_per_image.shape[0],
                          device=logits_per_image.device)
    acc_i = (logits_per_image.argmax(dim=1) == labels).float().mean()
    acc_t = (logits_per_image.argmax(dim=0) == labels).float().mean()
    return (acc_i + acc_t) / 2.0
