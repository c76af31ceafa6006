"""Image-text retrieval evaluation (the port of the JAX package's
eval/retrieval.py).

  * I2T / T2I recall@k: encode every volume and report, rank the similarity
    matrix, check whether the ground-truth index is in the top k;
  * volume-volume retrieval scored by the pathology-label overlap of the
    top-k neighbours: |labels_i AND labels_j| / |labels_i OR labels_j|,
    averaged over the top k.

The encoders run batched on the model's device under `torch.no_grad()`;
the ranking runs in numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn


def recall_at_k(
    image_features: np.ndarray,  # (N, D) L2-normalised
    text_features: np.ndarray,  # (N, D)
    ks: Sequence[int] = (5, 10, 50, 100),
) -> Dict[str, float]:
    sim = np.asarray(image_features, np.float32) @ np.asarray(
        text_features, np.float32).T
    gt = np.arange(sim.shape[0])
    # I2T: rank texts for each image; T2I: images for each text
    ranks_i2t = np.argmax(np.argsort(-sim, axis=1) == gt[:, None], axis=1)
    ranks_t2i = np.argmax(np.argsort(-sim.T, axis=1) == gt[:, None], axis=1)
    out = {}
    for k in ks:
        out[f"i2t_r@{k}"] = float(np.mean(ranks_i2t < k))
        out[f"t2i_r@{k}"] = float(np.mean(ranks_t2i < k))
    return out


def volume_volume_label_overlap(
    image_features: np.ndarray,  # (N, D)
    labels: np.ndarray,  # (N, L) binary pathology labels
    ks: Sequence[int] = (1, 5, 10, 50),
) -> Dict[str, float]:
    sim = image_features @ image_features.T
    np.fill_diagonal(sim, -np.inf)
    order = np.argsort(-sim, axis=1)
    labels = labels.astype(bool)
    out = {}
    for k in ks:
        scores = []
        for i in range(len(labels)):
            nbrs = order[i, :k]
            inter = (labels[i] & labels[nbrs]).sum(axis=1)
            union = (labels[i] | labels[nbrs]).sum(axis=1)
            overlap = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
            scores.append(overlap.mean())
        out[f"i2i_overlap@{k}"] = float(np.mean(scores))
    return out


def encode_corpus(
    encode_image_batch: Callable[[np.ndarray, Optional[np.ndarray]], np.ndarray],
    encode_text_batch: Callable[[np.ndarray, np.ndarray], np.ndarray],
    loader: Iterable[dict],
):
    """Run the encoders over a loader; returns the stacked features."""
    img_feats, txt_feats = [], []
    for batch in loader:
        img_feats.append(np.asarray(
            encode_image_batch(batch["image"], batch.get("image_2d"))))
        txt_feats.append(np.asarray(
            encode_text_batch(batch["input_ids"], batch["attention_mask"])))
    return np.concatenate(img_feats), np.concatenate(txt_feats)


def make_clip_retrieval_eval_fn(model: nn.Module, ks=(5, 10, 50, 100)):
    """`eval_fn(loader) -> metrics` of the model's current parameters (the
    trainer's `on_eval` hook calls it every `eval_every` steps); features
    come back to the host as f32 numpy."""
    device = next(model.parameters()).device

    def dev(x):
        return torch.as_tensor(x).to(device)

    @torch.no_grad()
    def enc_img(volume, slices):
        if not model.config.vision.slice_guided:
            slices = None
        feats = model.encode_image(
            dev(volume), None if slices is None else dev(slices))
        return feats.float().cpu().numpy()

    @torch.no_grad()
    def enc_txt(ids, mask):
        feats, _ = model.encode_text(dev(ids), dev(mask))
        return feats.float().cpu().numpy()

    def eval_fn(loader):
        img, txt = encode_corpus(enc_img, enc_txt, loader)
        return recall_at_k(img, txt, ks)

    return eval_fn


def clip_retrieval_eval(model: nn.Module, loader, ks=(5, 10, 50, 100)):
    """One-shot retrieval eval of a `CLIPModel` over a loader."""
    return make_clip_retrieval_eval_fn(model, ks)(loader)
