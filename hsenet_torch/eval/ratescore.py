"""RaTEScore hook + self-contained entity-F1 fallback (the port's own copy of
the JAX package's eval/ratescore.py).

The official RaTEScore (reference `Bench/eval/compute_RateScore.py:24-40`)
requires its external NER + entity-similarity models (the `RaTEScore` pip
package downloads them at runtime). When the package and weights are
present they are used; otherwise (e.g. this offline environment) a
self-contained fallback scores reports with the same shape of signal the
real metric captures — per-report medical-entity F1 with negation
awareness:

  * entity extraction by longest-match against a radiology vocabulary
    (anatomy from `data.term_dictionary` incl. synonyms, plus common CT
    findings) — the dictionary-based stand-in for RaTEScore's NER;
  * NegEx-style polarity: a negation cue ("no", "without", "free of", ...)
    scoping over the following clause flips an entity to ABSENT;
  * synonyms canonicalise to one entity, so "cardiac silhouette" in the
    prediction matches "heart" in the reference;
  * score = F1 over (entity, polarity) sets, 1.0 when both reports contain
    no known entities (two clean-negative reports agree).

The fallback is clearly labelled in every result (`scorer` key) — it is a
stand-in for environments without the official package, not a drop-in
reimplementation of the learned metric.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

# ------------------------------------------------------------------ fallback

_FINDINGS = [
    "pleural effusion", "pericardial effusion", "effusion",
    "consolidation", "atelectasis", "pneumothorax", "pneumonia",
    "ground glass opacity", "ground-glass opacity", "opacity",
    "nodule", "mass", "lesion", "cyst", "cavity",
    "emphysema", "fibrosis", "bronchiectasis", "edema",
    "cardiomegaly", "hernia", "hiatal hernia",
    "lymphadenopathy", "thickening", "calcification", "atherosclerosis",
    "fracture", "degenerative changes", "scoliosis",
    "ectasia", "aneurysm", "dilatation", "dilation", "embolism",
    "thrombus", "stenosis", "infiltrate", "infiltration", "scarring",
    "granuloma", "metastasis", "tumor", "tumour", "abscess",
    "collapse", "honeycombing", "mosaic attenuation", "air trapping",
    "bronchial wall thickening", "septal thickening", "tree-in-bud",
]

# negation cues (multi-word matched longest-first, then single-word);
# a cue scopes over the following ~12 words until a breaker/sentence end
_MULTI_WORD_CUES = [
    "no evidence of", "no sign of", "no signs of", "negative for",
    "free of", "clear of", "ruled out", "rules out", "rather than",
    "unremarkable for",
]
_SINGLE_WORD_CUES = {"no", "not", "without", "absent", "denies"}
_SCOPE_BREAKERS = {"but", "however", "although", "though", "except", ";"}
_NEGATION_SCOPE_WORDS = 12


def _vocabulary() -> Dict[str, str]:
    """phrase (lowercase) -> canonical entity name."""
    from hsenet_torch.data.term_dictionary import term_dict

    vocab: Dict[str, str] = {}
    for canonical, synonyms in term_dict.items():
        vocab[canonical.lower()] = canonical
        for s in synonyms:
            # strip leading articles from the natural-language synonyms
            phrase = re.sub(r"^(the|a|an)\s+", "", s.lower()).strip()
            vocab[phrase] = canonical
    for f in _FINDINGS:
        vocab[f] = f.replace("-", " ")
    return vocab


_VOCAB: Optional[Dict[str, str]] = None
_MAX_PHRASE_WORDS = 6


def extract_entities(text: str) -> Set[Tuple[str, str]]:
    """{(canonical_entity, 'present'|'absent')} for one report."""
    global _VOCAB
    if _VOCAB is None:
        _VOCAB = _vocabulary()
    words = re.findall(r"[a-z0-9-]+|[.;,]", text.lower())
    entities: Set[Tuple[str, str]] = set()
    negated_until = -1  # word index the active negation scope covers
    i = 0
    while i < len(words):
        w = words[i]
        if w in {".", ";", ","} or w in _SCOPE_BREAKERS:
            if w in {".", ";"} or w in _SCOPE_BREAKERS:
                negated_until = -1
            i += 1
            continue
        # negation cues (longest multi-word cue first)
        cued = False
        for cue in _MULTI_WORD_CUES:
            cw = cue.split()
            if words[i:i + len(cw)] == cw:
                negated_until = i + _NEGATION_SCOPE_WORDS
                i += len(cw)
                cued = True
                break
        if cued:
            continue
        if w in _SINGLE_WORD_CUES:
            negated_until = i + _NEGATION_SCOPE_WORDS
            i += 1
            continue
        # longest phrase match at this position
        matched = None
        for n in range(_MAX_PHRASE_WORDS, 0, -1):
            phrase = " ".join(words[i:i + n])
            if phrase in _VOCAB:
                matched = (_VOCAB[phrase], n)
                break
        if matched:
            polarity = "absent" if i <= negated_until else "present"
            entities.add((matched[0], polarity))
            i += matched[1]
        else:
            i += 1
    return entities


def entity_f1(prediction: str, reference: str) -> float:
    """Negation-aware medical-entity F1 between two reports (the fallback
    per-pair score; 1.0 when neither mentions a known entity)."""
    p = extract_entities(prediction)
    r = extract_entities(reference)
    if not p and not r:
        return 1.0
    if not p or not r:
        return 0.0
    tp = len(p & r)
    precision = tp / len(p)
    recall = tp / len(r)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


# ------------------------------------------------------------------ official


def ratescore_available() -> bool:
    try:
        import RaTEScore  # noqa: F401

        return True
    except Exception:
        return False


def compute_ratescore(
    predictions: Sequence[str],
    references: Sequence[str],
    allow_fallback: bool = False,
) -> Optional[List[float]]:
    """Per-sample scores: the official RaTEScore when installed, else the
    entity-F1 fallback when `allow_fallback`, else None (legacy gate
    behavior)."""
    if ratescore_available():
        from RaTEScore import RaTEScore as _RaTEScore

        scorer = _RaTEScore()
        return list(scorer.compute_score(list(predictions), list(references)))
    if allow_fallback:
        return [
            entity_f1(p, r) for p, r in zip(predictions, references)
        ]
    return None


def active_scorer_name() -> str:
    return "ratescore" if ratescore_available() else "entity_f1_fallback"


def score_eval_csv(csv_path: str) -> Optional[Dict[str, float]]:
    """Post-hoc scoring over an MRG eval CSV (reference reads the CSV the
    same way, compute_RateScore.py:24-40). Falls back to entity-F1 with
    the scorer name recorded in the result."""
    preds, refs = [], []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            preds.append(row["prediction"])
            refs.append(row["answer"])
    scores = compute_ratescore(preds, refs, allow_fallback=True)
    if scores is None:
        return None
    return {
        "ratescore_mean": sum(scores) / max(len(scores), 1),
        "num_samples": len(scores),
        "scorer": active_scorer_name(),
    }
