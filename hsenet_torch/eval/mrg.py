"""Medical Report Generation (MRG) evaluation harness (the port of the JAX
package's eval/mrg.py).

Mirrors `Bench/eval/eval_HSENet_CT_Rate_MRG.py`: batched greedy generation
(reference: batch 14, max_new 512), per-sample BLEU/ROUGE/METEOR (+ optional
BERTScore), rows + running means streamed to CSV (:408-467). Works for
CT-RATE and BIMCV-R alike — the dataset manifest is the only difference.

The generate function follows the port's contract,
generate(input_ids, kv_lens, volume, slice_features) -> token ids, with the
weights inside the model it closes over (`make_greedy_generate`,
`make_pld_generate`, `engine_generate_fn`); each batch's arrays are moved to
`device`, the model's device, and the ids come back to the host.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from hsenet_torch import resolve_device
from hsenet_torch.eval.metrics import RunningMeans, bert_score, nlg_metrics
from hsenet_torch.eval.ratescore import (
    active_scorer_name,
    compute_ratescore,
    entity_f1,
    ratescore_available,
)

CSV_FIELDS = [
    "index",
    "question",
    "answer",
    "prediction",
    "bleu1",
    "bleu2",
    "bleu3",
    "bleu4",
    "rouge_l",
    "meteor",
    # ratescore-style column: the official RaTEScore when installed, else
    # the in-port negation-aware entity-F1 fallback (eval/ratescore.py) —
    # populated either way
    "entity_f1",
]


def generate_batch(generate_fn: Callable, batch: dict, device) -> np.ndarray:
    """One harness batch through `generate_fn` on `device`: the prompt ids,
    their valid lengths (the attention mask's row sums), the volumes and,
    where the batch has them, the slice features; the ids come back as
    numpy."""

    def dev(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    kv_lens = batch["attention_mask"].sum(-1).astype(np.int32)
    slices = batch.get("image_2d")
    out = generate_fn(
        dev(batch["input_ids"]),
        dev(kv_lens),
        dev(batch["image"]),
        None if slices is None else dev(slices),
    )
    return out.detach().cpu().numpy()


def evaluate_mrg(
    generate_fn: Callable,  # (input_ids, kv_lens, volume, slices) -> ids
    loader: Iterable[dict],
    tokenizer,
    csv_path: Optional[str] = None,
    bert_embed_fn: Optional[Callable] = None,
    max_samples: Optional[int] = None,
    *,
    device="cuda",
):
    """Returns dict of mean metrics; streams per-sample rows to csv_path."""
    device = resolve_device(device)
    running = RunningMeans()
    rows_written = 0
    writer = None
    f = None
    predictions, references = [], []
    if csv_path:
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        f = open(csv_path, "w", newline="")
        writer = csv.DictWriter(
            f, fieldnames=CSV_FIELDS + [f"mean_{k}" for k in CSV_FIELDS[4:]]
        )
        writer.writeheader()
    try:
        for batch in loader:
            out_ids = generate_batch(generate_fn, batch, device)
            for i in range(len(out_ids)):
                pred = tokenizer.decode(out_ids[i], skip_special_tokens=True)
                ref = batch["answer"][i]
                row = nlg_metrics(pred, ref)
                row["entity_f1"] = entity_f1(pred, ref)
                means = running.update(row)
                predictions.append(pred)
                references.append(ref)
                if writer:
                    writer.writerow(
                        {
                            "index": rows_written,
                            "question": batch.get("question", [""] * len(out_ids))[i],
                            "answer": ref,
                            "prediction": pred,
                            **{k: f"{v:.6f}" for k, v in row.items()},
                            **{
                                f"mean_{k}": f"{v:.6f}"
                                for k, v in means.items()
                            },
                        }
                    )
                rows_written += 1
                if max_samples and rows_written >= max_samples:
                    break
            if max_samples and rows_written >= max_samples:
                break
    finally:
        if f:
            f.close()

    result = running.means()
    if bert_embed_fn is not None and predictions:
        bs = bert_score(predictions, references, bert_embed_fn)
        result["bertscore_f1"] = float(bs["f1"].mean())
    if predictions:
        if ratescore_available():
            scores = compute_ratescore(predictions, references)
            result["ratescore_mean"] = float(np.mean(scores))
        else:
            # the fallback IS the per-row entity_f1 column — reuse its
            # running mean instead of re-extracting the whole corpus
            result["ratescore_mean"] = result["entity_f1"]
        result["ratescore_scorer"] = active_scorer_name()
    result["num_samples"] = rows_written
    return result
