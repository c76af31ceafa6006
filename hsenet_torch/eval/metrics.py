"""NLG + VQA metrics (the port's own copy of the JAX package's
eval/metrics.py).

The reference computes per-sample BLEU-1..4 / ROUGE-L / METEOR / BERTScore
via HF `evaluate` (Bench/eval/eval_HSENet_CT_Rate_MRG.py:402-405,439-452)
and VQA class/exact accuracies + sklearn classification_report
(eval_HSENet_Rad_Geome_VQA.py:582-634). `evaluate` isn't available here;
BLEU and ROUGE-L are implemented from the definitions, METEOR delegates to
nltk, and BERTScore runs on any text-embedding callable (e.g. our BERT with
converted weights) — greedy token-similarity F1 per the BERTScore paper.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def simple_tokenize(text: str) -> List[str]:
    return re.findall(r"\w+|[^\w\s]", text.lower())


# ------------------------------------------------------------------ BLEU


def bleu_n(
    prediction: str, reference: str, max_n: int = 4, smooth: bool = False
) -> Dict[str, float]:
    """Papineni BLEU with brevity penalty; returns bleu1..bleu{max_n}
    where bleu_k uses uniform weights over 1..k (HF evaluate semantics)."""
    pred = simple_tokenize(prediction)
    ref = simple_tokenize(reference)
    out = {}
    precisions = []
    for n in range(1, max_n + 1):
        p_ngrams = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
        r_ngrams = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
        overlap = sum((p_ngrams & r_ngrams).values())
        total = max(sum(p_ngrams.values()), 0)
        if total == 0:
            precisions.append(0.0)
        elif overlap == 0 and smooth:
            precisions.append(1.0 / (2 * total))
        else:
            precisions.append(overlap / total)
        if len(ref) == 0 or len(pred) == 0:
            bp = 0.0
        elif len(pred) > len(ref):
            bp = 1.0
        else:
            bp = math.exp(1 - len(ref) / len(pred))
        if all(p > 0 for p in precisions):
            geo = math.exp(sum(math.log(p) for p in precisions) / n)
        else:
            geo = 0.0
        out[f"bleu{n}"] = bp * geo
    return out


# --------------------------------------------------------------- ROUGE-L


def _lcs_len(a: Sequence, b: Sequence) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(prediction: str, reference: str) -> float:
    """ROUGE-L F-measure (beta=1.2 like rouge_score/HF)."""
    pred = simple_tokenize(prediction)
    ref = simple_tokenize(reference)
    lcs = _lcs_len(pred, ref)
    if lcs == 0:
        return 0.0
    p = lcs / len(pred)
    r = lcs / len(ref)
    beta2 = 1.2**2
    return (1 + beta2) * p * r / (r + beta2 * p)


# ---------------------------------------------------------------- METEOR


def meteor(prediction: str, reference: str) -> float:
    try:
        from nltk.translate.meteor_score import meteor_score

        return float(
            meteor_score([simple_tokenize(reference)], simple_tokenize(prediction))
        )
    except Exception:
        # degenerate fallback: unigram harmonic mean, recall-weighted 9:1
        pred, ref = simple_tokenize(prediction), simple_tokenize(reference)
        if not pred or not ref:
            return 0.0
        overlap = sum((Counter(pred) & Counter(ref)).values())
        if overlap == 0:
            return 0.0
        p, r = overlap / len(pred), overlap / len(ref)
        return 10 * p * r / (r + 9 * p)


# ------------------------------------------------------------- BERTScore


def bert_score(
    predictions: Sequence[str],
    references: Sequence[str],
    embed_fn: Callable[[List[str]], np.ndarray],
) -> Dict[str, np.ndarray]:
    """Greedy-matching token-level F1 (BERTScore) over contextual embeddings.

    embed_fn: texts -> (B, S, H) embeddings with 0-rows for padding.
    """
    e_pred = embed_fn(list(predictions))
    e_ref = embed_fn(list(references))
    ps, rs, fs = [], [], []
    for ep, er in zip(e_pred, e_ref):
        ep = ep[np.abs(ep).sum(-1) > 0]
        er = er[np.abs(er).sum(-1) > 0]
        if len(ep) == 0 or len(er) == 0:
            ps.append(0.0), rs.append(0.0), fs.append(0.0)
            continue
        ep = ep / np.linalg.norm(ep, axis=-1, keepdims=True)
        er = er / np.linalg.norm(er, axis=-1, keepdims=True)
        sim = ep @ er.T
        p = sim.max(axis=1).mean()
        r = sim.max(axis=0).mean()
        f = 2 * p * r / (p + r) if p + r > 0 else 0.0
        ps.append(p), rs.append(r), fs.append(f)
    return {
        "precision": np.asarray(ps),
        "recall": np.asarray(rs),
        "f1": np.asarray(fs),
    }


# ------------------------------------------------------- aggregate helpers


def nlg_metrics(prediction: str, reference: str) -> Dict[str, float]:
    """Per-sample metric row, mirroring the reference eval CSV columns."""
    m = bleu_n(prediction, reference)
    m["rouge_l"] = rouge_l(prediction, reference)
    m["meteor"] = meteor(prediction, reference)
    return m


def exact_match_accuracy(predictions: Sequence[str], references: Sequence[str]):
    hits = [
        p.strip().lower() == r.strip().lower()
        for p, r in zip(predictions, references)
    ]
    return float(np.mean(hits)) if hits else 0.0


def containment_accuracy(predictions: Sequence[str], references: Sequence[str]):
    """VQA 'class accuracy': the gold anatomy string appears in the answer
    (eval_HSENet_Rad_Geome_VQA.py:582-590 semantics)."""
    hits = [
        r.strip().lower() in p.strip().lower()
        for p, r in zip(predictions, references)
    ]
    return float(np.mean(hits)) if hits else 0.0


class RunningMeans:
    """Streaming per-metric means (the reference appends running means to
    its eval CSV, eval_HSENet_CT_Rate_MRG.py:408-467)."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.n = 0

    def update(self, row: Dict[str, float]) -> Dict[str, float]:
        self.n += 1
        for k, v in row.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
        return self.means()

    def means(self) -> Dict[str, float]:
        return {k: v / max(self.n, 1) for k, v in self.sums.items()}
