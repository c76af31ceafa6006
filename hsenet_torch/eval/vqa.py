"""RadGenome location-VQA evaluation harness (the port of the JAX package's
eval/vqa.py).

Mirrors `Bench/eval/eval_HSENet_Rad_Geome_VQA.py`: greedy generation
(reference: batch 1, max_new 74), per-anatomy NLG buckets over the 11 chest
regions (:513-526), class-accuracy (gold anatomy contained in the answer)
and exact-text accuracy (:582-590), plus a sklearn classification report
(:634) when sklearn imports. The generate contract and the device are
those of `eval.mrg.evaluate_mrg`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Iterable, Optional

from hsenet_torch import resolve_device
from hsenet_torch.eval.metrics import (
    RunningMeans,
    containment_accuracy,
    exact_match_accuracy,
    nlg_metrics,
)
from hsenet_torch.eval.mrg import generate_batch

# the 11 anatomical regions the reference buckets by (:513-526)
ANATOMY_REGIONS = [
    "left lung",
    "right lung",
    "mediastinum",
    "heart",
    "pleura",
    "trachea",
    "esophagus",
    "bones",
    "thyroid",
    "abdomen",
    "breast",
]


def evaluate_vqa(
    generate_fn: Callable,
    loader: Iterable[dict],
    tokenizer,
    max_samples: Optional[int] = None,
    *,
    device="cuda",
):
    device = resolve_device(device)
    predictions, references, anatomies = [], [], []
    per_anatomy = defaultdict(RunningMeans)
    overall = RunningMeans()
    n = 0
    for batch in loader:
        out_ids = generate_batch(generate_fn, batch, device)
        for i in range(len(out_ids)):
            pred = tokenizer.decode(out_ids[i], skip_special_tokens=True)
            ref = batch["answer"][i]
            anatomy = batch.get("anatomy", batch["answer"])[i]
            row = nlg_metrics(pred, ref)
            overall.update(row)
            per_anatomy[anatomy].update(row)
            predictions.append(pred)
            references.append(ref)
            anatomies.append(anatomy)
            n += 1
            if max_samples and n >= max_samples:
                break
        if max_samples and n >= max_samples:
            break

    result = {
        "class_accuracy": containment_accuracy(predictions, references),
        "exact_accuracy": exact_match_accuracy(predictions, references),
        "num_samples": n,
        **{f"mean_{k}": v for k, v in overall.means().items()},
        "per_anatomy": {k: v.means() for k, v in per_anatomy.items()},
    }
    try:
        from sklearn.metrics import classification_report

        pred_classes = [
            next((a for a in ANATOMY_REGIONS if a in p.lower()), "unknown")
            for p in predictions
        ]
        result["classification_report"] = classification_report(
            anatomies, pred_classes, zero_division=0, output_dict=True
        )
    except Exception:
        pass
    return result
