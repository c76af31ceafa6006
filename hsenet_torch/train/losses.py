"""Losses of the port's training paths (the JAX package's train/losses.py).

`masked_lm_loss` is the VLM finetune's loss; the contrastive and relation
losses come with the CLIP slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100


def masked_lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) with -100 = ignore
    shift: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal-LM cross-entropy in f32; returns (loss, token_accuracy), both
    means over the positions whose label is not -100 (0 when there is
    none)."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe_labels = torch.where(valid, labels, 0).long()
    ce = F.cross_entropy(
        logits.float().flatten(0, 1), safe_labels.flatten(), reduction="none"
    ).view(safe_labels.shape)
    denom = valid.sum().clamp(min=1)
    loss = torch.where(valid, ce, 0.0).sum() / denom
    hits = valid & (logits.argmax(dim=-1) == safe_labels)
    return loss, hits.sum() / denom
