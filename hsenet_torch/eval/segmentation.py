"""Segmentation and grounding (REC) evaluation (the port of the JAX
package's eval/segmentation.py).

The reference scores segmentation by dice on SegVol's outputs and REC by
the IoU of boxes parsed from generated text (`Bench/utils.py`
extract_box_from_text + calculate_iou):

  * `dice_score` / `evaluate_segmentation`: thresholded dice over a loader
    of {image, seg, question} batches;
  * `evaluate_rec`: generate box answers, parse `<bx_start>[..]<bx_end>`,
    report the mean IoU and accuracy at IoU 0.25 and 0.5.

The generate contract and the device are those of `eval.mrg.evaluate_mrg`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from hsenet_torch import resolve_device
from hsenet_torch.eval.mrg import generate_batch
from hsenet_torch.utils.boxes import box_iou_3d, extract_box_from_text


def dice_score(pred_mask: np.ndarray, target: np.ndarray,
               smooth: float = 1e-6) -> float:
    p = pred_mask.astype(bool).ravel()
    t = target.astype(bool).ravel()
    inter = np.logical_and(p, t).sum()
    return float((2 * inter + smooth) / (p.sum() + t.sum() + smooth))


def evaluate_segmentation(segment_fn: Callable, text_embed_fn: Callable,
                          loader: Iterable[dict], threshold: float = 0.5,
                          max_samples: Optional[int] = None, *,
                          device="cuda"):
    """Mean dice over a loader of seg QA batches (`SegQADataset`'s):
    `segment_fn(volume (B, 1, D, H, W), text_emb (B, C))` gives the logits
    and `text_embed_fn(prompts)` the prompt embeddings (numpy or a tensor)
    of each question with [SEG] taken out."""
    device = resolve_device(device)
    scores = []
    for batch in loader:
        prompts = ([t.replace("[SEG]", "").strip() for t in batch["question"]]
                   if "question" in batch else [""] * len(batch["image"]))
        emb = text_embed_fn(prompts)
        text_emb = torch.as_tensor(
            emb if isinstance(emb, torch.Tensor) else np.asarray(emb)
        ).to(device)
        with torch.no_grad():
            logits = segment_fn(
                torch.as_tensor(np.asarray(batch["image"]), device=device),
                text_emb)
        logits = logits.float().cpu().numpy()
        probs = 1.0 / (1.0 + np.exp(-logits))
        for i in range(len(probs)):
            scores.append(dice_score(probs[i, 0] > threshold,
                                     np.asarray(batch["seg"][i, 0])))
            if max_samples and len(scores) >= max_samples:
                break
        if max_samples and len(scores) >= max_samples:
            break
    return {"dice": float(np.mean(scores)) if scores else 0.0,
            "num_samples": len(scores)}


def evaluate_rec(generate_fn: Callable, loader: Iterable[dict], tokenizer,
                 iou_thresholds=(0.25, 0.5), max_samples: Optional[int] = None,
                 reference_compatible: bool = False, *, device="cuda"):
    """Referring-expression comprehension: the IoU of each generated box
    against the gold `box` of `PosRECDataset` batches (rows without a gold
    box are skipped); `reference_compatible` scores with the reference's
    bounding-extent IoU (Bench/utils.py:38-54)."""
    device = resolve_device(device)
    ious, parsed, n = [], 0, 0
    for batch in loader:
        out_ids = generate_batch(generate_fn, batch, device)
        golds = batch.get("box")
        for i in range(len(out_ids)):
            if golds is None or golds[i] is None:
                continue
            pred = extract_box_from_text(
                tokenizer.decode(out_ids[i], skip_special_tokens=True))
            if pred is not None:
                parsed += 1
                ious.append(box_iou_3d(pred, np.asarray(golds[i]),
                                       reference_compatible=reference_compatible))
            else:
                ious.append(0.0)
            n += 1
            if max_samples and n >= max_samples:
                break
        if max_samples and n >= max_samples:
            break
    ious = np.asarray(ious) if ious else np.zeros(1)
    out = {"mean_iou": float(ious.mean()), "parse_rate": parsed / max(n, 1),
           "num_samples": n}
    for t in iou_thresholds:
        out[f"acc@{t}"] = float((ious >= t).mean())
    return out
