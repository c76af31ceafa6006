"""The part of the JAX package's data/datasets.py that the training CLIs'
and the evaluation harnesses' batches need: the tokenization rules, the
word-level tokenizer of tests and synthetic runs, batching and the host
loader, the synthetic CT dataset in caption, clip, clip2 and seg modes, the
CT-RATE CLIP pairs (`CTRateCLIPDataset`, `ITRDataset`,
`CTRateCLIPStage2Dataset`), the manifest-driven MRG (`CaptionDataset`),
location-VQA (`VQALocationDataset`) and closed-VQA (`ClosedVQADataset`,
`YesNoVQADataset`) sets, the M3D sets (`M3DCapDataset`, `M3DVQADataset`,
`M3DVQAYNDataset`), the grounding sets (`PosRECDataset`, `PosREGDataset`,
`SegQADataset`) and the task mix (`MixDataset`, `build_task_mix`). The
host side is plain numpy, as in the JAX package; the trainer and the
harnesses move each batch to the device.

Reproduced semantics: question = [BOS] + "<im_patch>" * proj_out_num +
prompt; question + " " + answer tokenized right-padded, EOS patched at the
valid length, labels -100 over the question span and the padding; report
text stripped of quotes and parentheses; validation cut to the first
`val_limit` entries of the manifest.
"""

from __future__ import annotations

import csv
import json
import os
import random
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from hsenet_torch.data.prompts import (
    Caption_templates,
    PosREC_templates,
    PosREG_templates,
    Seg_templates,
    VQA_location_templates,
)
from hsenet_torch.data.term_dictionary import describe, term_dict
from hsenet_torch.utils.boxes import format_box, mask2box

IGNORE_INDEX = -100
IM_PATCH_TOKEN = "<im_patch>"
SPECIAL_TOKENS = ["<im_patch>", "<bx_start>", "<bx_end>", "[SEG]"]


class SimpleTokenizer:
    """Whitespace word-level tokenizer with HF-ish call semantics."""

    def __init__(self, vocab: Optional[List[str]] = None, vocab_size: int = 512):
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 3
        self.bos_token = "<s>"
        self.eos_token = "</s>"
        self.pad_token = "<pad>"
        self._tokens = ["<pad>", "<s>", "</s>", "<unk>"]
        self._ids = {t: i for i, t in enumerate(self._tokens)}
        self.vocab_limit = vocab_size
        if vocab:
            for w in vocab:
                self.add_token(w)

    def add_token(self, w: str) -> int:
        if w not in self._ids:
            self._ids[w] = len(self._tokens)
            self._tokens.append(w)
        return self._ids[w]

    def add_special_tokens(self, d: Dict[str, List[str]]):
        for w in d.get("additional_special_tokens", []):
            self.add_token(w)

    def convert_tokens_to_ids(self, tok: str) -> int:
        return self._ids.get(tok, self.unk_token_id)

    def __len__(self):
        return max(len(self._tokens), self.vocab_limit)

    def _split(self, text: str) -> List[str]:
        out = []
        # keep special tokens intact
        pattern = "|".join(re.escape(t) for t in self._tokens if t.startswith("<") or t.startswith("["))
        for part in re.split(f"({pattern})", text):
            if not part:
                continue
            if part in self._ids:
                out.append(part)
            else:
                out.extend(part.split())
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self._lookup(w) for w in self._split(text)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def _lookup(self, w: str) -> int:
        if w in self._ids:
            return self._ids[w]
        if len(self._tokens) < self.vocab_limit:
            return self.add_token(w)
        return self.unk_token_id

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i < len(self._tokens):
                t = self._tokens[i]
                if skip_special_tokens and i < 4:
                    continue
                words.append(t)
        return " ".join(words)

    def __call__(
        self,
        text: str,
        max_length: int = 128,
        truncation: bool = True,
        padding: str = "max_length",
        add_special_tokens: bool = True,
        return_tensors: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        if truncation:
            ids = ids[:max_length]
        mask = [1] * len(ids)
        if padding == "max_length":
            pad = max_length - len(ids)
            ids = ids + [self.pad_token_id] * pad
            mask = mask + [0] * pad
        return {
            "input_ids": np.asarray([ids], np.int32),
            "attention_mask": np.asarray([mask], np.int32),
        }


def clean_report_text(text: str) -> str:
    """Strip quotes and parentheses (multi_dataset.py:252-255)."""
    for ch in ('"', "'", "(", ")"):
        text = text.replace(ch, "")
    return text


def truncate_text_sentence_sampling(
    tokenizer, text: str, max_tokens: int, rng: random.Random
) -> str:
    """Random sentence-sampling truncation (multi_dataset.py:76-102):
    keep the first sentence, then add randomly chosen sentences while the
    token budget allows."""

    def count(t):
        return len(tokenizer.encode(t, add_special_tokens=True))

    if count(text) <= max_tokens:
        return text
    sentences = text.split(".")
    selected: List[str] = []
    current = 0
    if sentences:
        selected.append(sentences.pop(0))
    while current <= max_tokens and sentences:
        s = rng.choice(sentences)
        n = count(s)
        if current + n <= max_tokens and s not in selected:
            selected.append(s)
            current += n
        else:
            sentences.remove(s)
    return ".".join(selected)


def tokenize_qa_sample(
    tokenizer,
    question: str,
    answer: str,
    max_length: int,
) -> Dict[str, np.ndarray]:
    """The reference's caption/VQA packing (multi_dataset.py:471-501).

    Returns input_ids, attention_mask, labels (1D arrays, right-padded).
    """
    if getattr(tokenizer, "bos_token", None) is not None:
        question = tokenizer.bos_token + question
    full = tokenizer(
        question + " " + answer,
        max_length=max_length,
        truncation=True,
        padding="max_length",
        add_special_tokens=False,
    )
    input_ids = full["input_ids"][0].copy()
    attention_mask = full["attention_mask"][0].copy()
    valid_len = int(attention_mask.sum())
    if valid_len < len(input_ids):
        input_ids[valid_len] = tokenizer.eos_token_id

    q_only = tokenizer(
        question,
        max_length=max_length,
        truncation=True,
        padding="max_length",
        add_special_tokens=False,
    )
    question_len = int(q_only["attention_mask"][0].sum())

    labels = input_ids.astype(np.int64).copy()
    labels[:question_len] = IGNORE_INDEX
    if tokenizer.pad_token_id == tokenizer.eos_token_id:
        labels[labels == tokenizer.pad_token_id] = IGNORE_INDEX
        if valid_len < len(labels):
            labels[valid_len] = tokenizer.eos_token_id
    else:
        labels[labels == tokenizer.pad_token_id] = IGNORE_INDEX
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "question_len": question_len,
    }


@dataclass
class DataArgs:
    data_root: str = ""
    max_length: int = 512
    max_text_len: int = 128  # CLIP stages
    proj_out_num: int = 256
    val_limit: int = 512


class _RetryDataset:
    """__getitem__ retry-random-index-on-exception (multi_dataset.py:104-140)."""

    max_attempts = 100

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx):
        rng = random.Random(idx)
        for _ in range(self.max_attempts):
            try:
                return self.get(idx)
            except Exception as e:  # noqa: BLE001 — reference behavior
                print(f"Error in __getitem__ at index {idx}: {e}")
                idx = rng.randint(0, len(self) - 1)
        raise RuntimeError("dataset retry limit exceeded")


def _load_manifest(path: str, split: str, val_limit: int) -> List[dict]:
    with open(path) as f:
        data = json.load(f)[split]
    if split == "validation":
        data = data[:val_limit]
    return data


def _load_text(entry_text: str, data_root: str) -> str:
    """Manifest 'text' may be an inline string or a path to a .txt file."""
    p = os.path.join(data_root, entry_text)
    if entry_text.endswith(".txt") and os.path.exists(p):
        with open(p) as f:
            return f.read()
    return entry_text


def _slice_features(entry: dict, data_root: str) -> dict:
    """{"image_2d": the entry's (32, 768) BiomedCLIP features}, or {} for an
    entry without `biomedclip_features` (a manifest for a model that
    computes them in-graph, `VLMConfig.online_slice_features`)."""
    if "biomedclip_features" not in entry:
        return {}
    feats = np.load(os.path.join(data_root, entry["biomedclip_features"]))
    return {"image_2d": feats.astype(np.float32)}


class CTRateCLIPDataset(_RetryDataset):
    """Stage-1 pairs: {image, input_ids, attention_mask, text}
    (CT_RateDataset, multi_dataset.py:167-277). Sentence sampling draws
    from one `random.Random(0)` per instance, so a sample depends on the
    order of the `get` calls before it (the loader's order)."""

    clean_text = True  # strip quotes/parens (multi_dataset.py:252-255)

    def __init__(self, args: DataArgs, tokenizer, manifest: str, split="train"):
        self.args = args
        self.tokenizer = tokenizer
        self.split = split
        self.data_list = _load_manifest(manifest, split, args.val_limit)
        self._rng = random.Random(0)

    def get(self, idx):
        entry = self.data_list[idx]
        image = np.load(os.path.join(self.args.data_root, entry["image"]))
        text = _load_text(entry["text"], self.args.data_root)
        if self.clean_text:
            text = clean_report_text(text)
        text = truncate_text_sentence_sampling(
            self.tokenizer, text, self.args.max_text_len, self._rng
        )
        tok = self.tokenizer(
            text,
            max_length=self.args.max_text_len,
            truncation=True,
            padding="max_length",
        )
        return {
            "image": image.astype(np.float32),
            "input_ids": tok["input_ids"][0],
            "attention_mask": tok["attention_mask"][0],
            "text": text,
        }


class ITRDataset(CTRateCLIPDataset):
    """Image-text retrieval pairs over raw report .txt files (reference
    ITRDataset, multi_dataset.py:34-140): the CLIP dataset's pairs and
    truncation WITHOUT the quote/paren cleanup."""

    clean_text = False

    def get(self, idx):
        ret = super().get(idx)
        ret["question_type"] = "Image_text_retrieval"
        return ret


class CTRateCLIPStage2Dataset(CTRateCLIPDataset):
    """Stage-2 pairs add image_2d = (32, 768) BiomedCLIP features
    (CT_RateDataset_stage2, multi_dataset.py:280-394)."""

    def get(self, idx):
        ret = super().get(idx)
        entry = self.data_list[idx]
        feats = np.load(
            os.path.join(self.args.data_root, entry["biomedclip_features"])
        )
        ret["image_2d"] = feats.astype(np.float32)
        return ret


class CaptionDataset(_RetryDataset):
    """MRG samples (CapDataset_CT_Rate, multi_dataset.py:406-520): a
    manifest split of {image, biomedclip_features, text} entries, paths
    under `args.data_root`; the prompt is drawn from `templates`. An entry
    without `biomedclip_features` gives no `image_2d` (the JAX package's
    dataset needs it; the port's VLM can compute it in-graph)."""

    def __init__(
        self,
        args: DataArgs,
        tokenizer,
        manifest: str,
        split="train",
        templates: Optional[Sequence[str]] = None,
    ):
        self.args = args
        self.tokenizer = tokenizer
        self.split = split
        self.data_list = _load_manifest(manifest, split, args.val_limit)
        self.templates = list(templates or Caption_templates)
        self.image_tokens = IM_PATCH_TOKEN * args.proj_out_num
        self._rng = random.Random(0)

    def get(self, idx):
        entry = self.data_list[idx]
        image = np.load(os.path.join(self.args.data_root, entry["image"]))
        answer = clean_report_text(_load_text(entry["text"], self.args.data_root))
        prompt = self._rng.choice(self.templates)
        question = self.image_tokens + prompt
        tok = tokenize_qa_sample(
            self.tokenizer, question, answer, self.args.max_length
        )
        return {
            "image": image.astype(np.float32),
            **_slice_features(entry, self.args.data_root),
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": answer,
        }


class VQALocationDataset(_RetryDataset):
    """RadGenome location VQA (VQADataset_CT_Rate, multi_dataset.py:524-645):
    prompt template with {abnormality} substitution; answer = anatomy name.
    Slice features as in `CaptionDataset`."""

    def __init__(
        self,
        args: DataArgs,
        tokenizer,
        manifest: str,
        split="train",
        templates: Optional[Sequence[str]] = None,
    ):
        self.args = args
        self.tokenizer = tokenizer
        self.split = split
        self.data_list = _load_manifest(manifest, split, args.val_limit)
        self.templates = list(templates or VQA_location_templates)
        self.image_tokens = IM_PATCH_TOKEN * args.proj_out_num
        self._rng = random.Random(0)

    def get(self, idx):
        entry = self.data_list[idx]
        image = np.load(os.path.join(self.args.data_root, entry["image"]))
        template = self._rng.choice(self.templates)
        question_text = template.format(abnormality=entry["abnormality"])
        answer = entry["anatomy"]
        question = self.image_tokens + question_text
        tok = tokenize_qa_sample(
            self.tokenizer, question, answer, self.args.max_length
        )
        return {
            "image": image.astype(np.float32),
            **_slice_features(entry, self.args.data_root),
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": answer,
            "anatomy": answer,
            "abnormality": entry["abnormality"],
        }


class ClosedVQADataset(_RetryDataset):
    """Closed-ended VQA with lettered choices (reference `VQADataset`
    closed branch, multi_dataset.py:762-888: question + "Choices: A. ...")."""

    def __init__(self, args: DataArgs, tokenizer, manifest: str, split="train"):
        self.args = args
        self.tokenizer = tokenizer
        self.data_list = _load_manifest(manifest, split, args.val_limit)
        self.image_tokens = IM_PATCH_TOKEN * args.proj_out_num

    def get(self, idx):
        entry = self.data_list[idx]
        image = np.load(os.path.join(self.args.data_root, entry["image"]))
        choices = entry["choices"]  # list of strings
        letters = "ABCDEFGH"
        choice_str = " ".join(
            f"{letters[i]}. {c}." for i, c in enumerate(choices)
        )
        question = self.image_tokens + entry["question"] + " Choices: " + choice_str
        answer_idx = int(entry["answer_idx"])
        answer = f"{letters[answer_idx]}. {choices[answer_idx]}."
        tok = tokenize_qa_sample(
            self.tokenizer, question, answer, self.args.max_length
        )
        ret = {
            "image": image.astype(np.float32),
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": answer,
        }
        if "biomedclip_features" in entry:
            ret["image_2d"] = np.load(
                os.path.join(self.args.data_root, entry["biomedclip_features"])
            ).astype(np.float32)
        return ret


class YesNoVQADataset(ClosedVQADataset):
    """Closed yes/no VQA (reference `VQAYNDataset`, multi_dataset.py:891-999):
    a two-choice closed VQA; entries carry answer_idx over ["yes", "no"]
    (written back into `data_list` on first read) or explicit choices."""

    def get(self, idx):
        entry = self.data_list[idx]
        if "choices" not in entry:
            entry = dict(entry, choices=["yes", "no"])
            self.data_list[idx] = entry
        return super().get(idx)


class M3DCapDataset(_RetryDataset):
    """M3D-Cap caption finetune (reference CapDataset,
    multi_dataset.py:648-760): JSON with per-split entry lists; each entry's
    `text` is a path to a raw report .txt (no cleaning or sentence
    sampling), `image` a normalized npy; the prompt is drawn per sample
    from `random.Random(seed * 1_000_003 + idx)`."""

    def __init__(self, args: DataArgs, tokenizer, cap_data_path: str,
                 split="train", templates=None, seed=0):
        self.args = args
        self.tokenizer = tokenizer
        with open(cap_data_path) as f:
            self.data_list = json.load(f)[split]
        self.templates = list(templates or Caption_templates)
        self.image_tokens = IM_PATCH_TOKEN * args.proj_out_num
        self.seed = seed

    def get(self, idx):
        entry = self.data_list[idx]
        rng = random.Random(self.seed * 1_000_003 + idx)
        image = np.load(os.path.join(self.args.data_root, entry["image"]))
        with open(os.path.join(self.args.data_root, entry["text"])) as f:
            answer = f.read()
        question = self.image_tokens + rng.choice(self.templates)
        tok = tokenize_qa_sample(
            self.tokenizer, question, answer, self.args.max_length
        )
        return {
            "image": image.astype(np.float32),
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": answer,
            "question_type": "Caption",
        }


def _read_csv_rows(path: str, limit: Optional[int] = None) -> List[dict]:
    rows = []
    with open(path, newline="") as f:
        for i, row in enumerate(csv.DictReader(f)):
            if limit is not None and i >= limit:
                break
            rows.append(row)
    return rows


class M3DVQADataset(_RetryDataset):
    """M3D-VQA CSV variant (reference VQADataset, multi_dataset.py:762-888).

    CSV columns: `Image Path`, `Question`, `Choice A`..`Choice D`,
    `Answer Choice`, `Answer`, `Question Type`. Closed-ended builds the
    "Choices: A. .. B. .. C. .. D. .." string and answers
    "<letter>. <answer>"; open-ended answers the raw text. Validation reads
    the first `val_rows` rows (reference nrows=2048)."""

    question_type_key = "Question Type"

    def __init__(self, args: DataArgs, tokenizer, csv_path: str,
                 close_ended: bool = True, split="train", val_rows=2048,
                 seed=0):
        self.args = args
        self.tokenizer = tokenizer
        limit = val_rows if split == "validation" else None
        self.data_list = _read_csv_rows(csv_path, limit)
        self.close_ended = close_ended
        self.image_tokens = IM_PATCH_TOKEN * args.proj_out_num
        self.seed = seed

    def _qa(self, row):
        if self.close_ended:
            choices = "Choices: A. {} B. {} C. {} D. {}".format(
                row["Choice A"], row["Choice B"], row["Choice C"],
                row["Choice D"],
            )
            return (row["Question"] + " " + choices,
                    "{}. {}".format(row["Answer Choice"], row["Answer"]))
        return row["Question"], str(row["Answer"])

    def get(self, idx):
        row = self.data_list[idx]
        image = np.load(os.path.join(self.args.data_root, row["Image Path"]))
        question, answer = self._qa(row)
        question = self.image_tokens + " " + question
        tok = tokenize_qa_sample(
            self.tokenizer, question, answer, self.args.max_length
        )
        return {
            "image": image.astype(np.float32),
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": answer,
            "answer_choice": row.get("Answer Choice", ""),
            "question_type": row.get(self.question_type_key, ""),
        }


class M3DVQAYNDataset(M3DVQADataset):
    """M3D-VQA yes/no CSV variant (reference VQAYNDataset,
    multi_dataset.py:891-999): raw question, raw yes/no answer."""

    def __init__(self, args: DataArgs, tokenizer, csv_path: str,
                 split="train", val_rows=2048, seed=0):
        super().__init__(args, tokenizer, csv_path, close_ended=False,
                         split=split, val_rows=val_rows, seed=seed)

    def _qa(self, row):
        return row["Question"], str(row["Answer"])


class _GroundingDataset(_RetryDataset):
    """What the grounding sets share (reference multi_dataset.py:1003-1631):
    the manifest, the class list, plain or description mode, a random
    stream per sample, "no" answers for empty masks. Manifest entries carry
    image and seg paths and either a `target` name or a `cls_id` into
    `classes` (the registry's list for the corpus code)."""

    def __init__(self, args: DataArgs, tokenizer, manifest: str, split="train",
                 templates=None, classes: Optional[List[str]] = None,
                 description: bool = False, term_dictionary=None, seed=0):
        self.args = args
        self.tokenizer = tokenizer
        self.data_list = _load_manifest(manifest, split, args.val_limit)
        self.templates = dict(templates or self.default_templates())
        self.classes = classes
        self.description = description
        self.term_dictionary = term_dictionary
        self.image_tokens = IM_PATCH_TOKEN * args.proj_out_num
        self.seed = seed

    def default_templates(self):
        raise NotImplementedError

    def _target(self, entry) -> str:
        if "target" in entry:
            return entry["target"]
        if self.classes is None:
            raise ValueError("entry has cls_id but dataset got no classes")
        return self.classes[int(entry["cls_id"])]

    def _describe(self, target: str, rng: random.Random) -> str:
        return describe(target, rng, self.term_dictionary or term_dict)

    def _pick(self, group: str, rng: random.Random) -> str:
        return rng.choice(self.templates[group])

    def _rng(self, idx: int) -> random.Random:
        return random.Random(self.seed * 1_000_003 + idx)

    def _load_pair(self, entry):
        image = np.load(os.path.join(self.args.data_root, entry["image"]))
        seg = np.load(os.path.join(self.args.data_root, entry["seg"]))
        if seg.ndim == 3:
            seg = seg[None]
        return image.astype(np.float32), seg

    def _pack(self, image, question, answer, extra=None):
        tok = tokenize_qa_sample(self.tokenizer, question, answer,
                                 self.args.max_length)
        ret = {
            "image": image,
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": answer,
        }
        if extra:
            ret.update(extra)
        return ret


class PosRECDataset(_GroundingDataset):
    """Referring-expression comprehension: a target's name (or description)
    asked, its 3D box answered (reference PosRECDataset,
    multi_dataset.py:1003-1173); absent targets get "no" answers and no
    `box`."""

    question_type = "REC"

    def default_templates(self):
        return PosREC_templates

    def get(self, idx):
        entry = self.data_list[idx]
        rng = self._rng(idx)
        image, seg = self._load_pair(entry)
        target = self._target(entry)
        box = mask2box(seg[0])
        if self.description:
            question = self._pick("des_questions", rng).format(
                self._describe(target, rng))
        else:
            question = self._pick("cls_questions", rng).format(target)
        question = self.image_tokens + question
        extra = {}
        if box is not None:
            box_text = format_box(box)
            if self.description:
                answer = self._pick("des_answers", rng).format(target, box_text)
            else:
                answer = self._pick("cls_answers", rng).format(box_text)
            extra["box"] = box
        else:
            group = "des_no_answers" if self.description else "cls_no_answers"
            answer = self._pick(group, rng).format(target)
        return self._pack(image, question, answer, extra)


class PosREGDataset(_GroundingDataset):
    """Region grounding: a box asked, the target's name answered (with a
    term-dictionary description in description mode); absent targets get
    the name-slot "no" questions (reference PosREGDataset,
    multi_dataset.py:1176-1352)."""

    question_type = "REG"

    def default_templates(self):
        return PosREG_templates

    def get(self, idx):
        entry = self.data_list[idx]
        rng = self._rng(idx)
        image, seg = self._load_pair(entry)
        target = self._target(entry)
        box = mask2box(seg[0])
        if box is not None:
            box_text = format_box(box)
            if self.description:
                question = self._pick("des_questions", rng).format(box_text)
                answer = self._pick("des_answers", rng).format(
                    target, self._describe(target, rng))
            else:
                question = self._pick("cls_questions", rng).format(box_text)
                answer = self._pick("cls_answers", rng).format(target)
        elif self.description:
            question = self._pick("des_no_questions", rng).format(
                self._describe(target, rng))
            answer = self._pick("des_no_answers", rng).format(target)
        else:
            question = self._pick("cls_no_questions", rng).format(target)
            answer = self._pick("cls_no_answers", rng).format(target)
        return self._pack(image, self.image_tokens + question, answer)


class SegQADataset(_GroundingDataset):
    """Segmentation Q&A: [SEG]-token answers with the real masks
    (reference SegDataset / RefSegDataset, multi_dataset.py:1354-1631)."""

    question_type = "SEG"

    def default_templates(self):
        return Seg_templates

    def get(self, idx):
        entry = self.data_list[idx]
        rng = self._rng(idx)
        image, seg = self._load_pair(entry)
        target = self._target(entry)
        if self.description:
            question = self._pick("des_questions", rng).format(
                self._describe(target, rng))
        else:
            question = self._pick("cls_questions", rng).format(target)
        question = self.image_tokens + question
        if np.any(seg):
            answer = (self._pick("des_answers", rng).format(target)
                      if self.description else self._pick("cls_answers", rng))
        else:
            group = "des_no_answers" if self.description else "cls_no_answers"
            answer = self._pick(group, rng).format(target)
        return self._pack(image, question, answer,
                          {"seg": seg.astype(np.float32)})


class MixDataset:
    """Task mixer (reference UniDatasets / TextDatasets_CT_Rate,
    multi_dataset.py:1692-1809): concatenation of datasets, optionally with
    zero-filled `seg` masks so seg and non-seg tasks collate together
    (train_VLM.py:266-312 collator branch)."""

    def __init__(self, datasets: List, pad_seg_shape=None):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])
        self.pad_seg_shape = pad_seg_shape

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        sample = self.datasets[d][idx - int(self.offsets[d])]
        if self.pad_seg_shape is not None and "seg" not in sample:
            sample["seg"] = np.zeros(self.pad_seg_shape, np.float32)
        return sample


def build_task_mix(
    use_training_data: str,
    args: DataArgs,
    tokenizer,
    manifest: str,
    split: str = "train",
    pad_seg_shape=None,
):
    """Task-mix factory mirroring the reference's `use_training_data`
    selector (TextDatasets_CT_Rate / UniDatasets, multi_dataset.py:1692-1809):
    'caption' | 'openvqa' | 'closedvqa' | 'yn' | 'closedvqa_and_caption' |
    'caption_and_openvqa' | 'seg' | 'rec' | 'reg', '+'-combinable; an
    unknown task raises ValueError."""
    builders = {
        "caption": lambda: CaptionDataset(args, tokenizer, manifest, split),
        "openvqa": lambda: VQALocationDataset(args, tokenizer, manifest, split),
        "closedvqa": lambda: ClosedVQADataset(args, tokenizer, manifest, split),
        "yn": lambda: YesNoVQADataset(args, tokenizer, manifest, split),
        "seg": lambda: SegQADataset(args, tokenizer, manifest, split),
        "rec": lambda: PosRECDataset(args, tokenizer, manifest, split),
        "reg": lambda: PosREGDataset(args, tokenizer, manifest, split),
    }
    aliases = {
        "closedvqa_and_caption": "closedvqa+caption",
        "caption_and_openvqa": "caption+openvqa",
    }
    spec = aliases.get(use_training_data, use_training_data)
    parts = [p.strip() for p in spec.split("+") if p.strip()]
    unknown = [p for p in parts if p not in builders]
    if unknown:
        raise ValueError(f"unknown task '{unknown[0]}' (options: {sorted(builders)})")
    datasets = [builders[p]() for p in parts]
    if len(datasets) == 1 and pad_seg_shape is None:
        return datasets[0]
    return MixDataset(datasets, pad_seg_shape=pad_seg_shape)


_TENSOR_KEYS = {
    "image",
    "image_2d",
    "input_ids",
    "attention_mask",
    "labels",
    "seg",
    "box",
}


def collate(samples: List[dict]) -> Dict[str, np.ndarray]:
    """Stack tensor fields; keep string fields as lists. Keys missing from
    some samples (e.g. `box` on absent-target REC rows) are dropped — mixed
    task batches only share the common fields, like the reference's
    per-entry-point collators (train_VLM.py:266-312)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        if not all(key in s for s in samples):
            continue
        vals = [s[key] for s in samples]
        if key in _TENSOR_KEYS:
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Shuffling epoch iterator with drop_remainder batching (host side).

    Data-parallel shards (`num_shards` = dp, `shard_index` = the dp rank):
    every rank shuffles the same epoch order, drops the remainder that
    does not divide by `num_shards`, and takes every `num_shards`-th index
    from `shard_index`, as the JAX package's loader does; `batch_size` is
    then the rank's share of the global batch. A dataset whose tokenizer
    is the word-level `SimpleTokenizer` is read whole: that tokenizer
    numbers words as it first sees them, so each rank reads every row of
    the global batch in one process's order and keeps its own. Every
    rank then holds one process's vocabulary (and the datasets' sequential
    draws, such as the prompt templates, are one process's too); the host
    reads dp times the rows. The JAX package's thread-pool decoding comes
    with a later slice of the port."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        collate_fn: Callable = collate,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.collate_fn = collate_fn
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        self.read_whole = num_shards > 1 and isinstance(
            getattr(dataset, "tokenizer", None), SimpleTokenizer)

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        # the common length first, so every rank runs the same steps
        order = order[: len(order) - len(order) % self.num_shards]
        rows = self.batch_size * self.num_shards  # the global batch
        for start in range(0, len(order), rows):
            idxs = order[start:start + rows]
            own = idxs[self.shard_index::self.num_shards]
            if len(own) < self.batch_size and self.drop_remainder:
                return
            if self.read_whole:
                samples = [self.dataset[int(i)] for i in idxs]
                samples = samples[self.shard_index::self.num_shards]
            else:
                samples = [self.dataset[int(i)] for i in own]
            yield self.collate_fn(samples)


class SyntheticCTDataset(_RetryDataset):
    """In-memory synthetic volumes + toy reports, same sample dicts as the
    real datasets — lets every train path run without CT-RATE on disk.
    `reports`, when given, replaces the toy reports (one text per sample)."""

    def __init__(
        self,
        n: int = 32,
        shape=(1, 32, 256, 256),
        tokenizer=None,
        mode: str = "clip",  # clip | clip2 | caption | seg
        args: Optional[DataArgs] = None,
        num_slices: int = 32,
        slice_dim: int = 768,
        reports: Optional[Sequence[str]] = None,
    ):
        self.n = n
        self.shape = shape
        self.tokenizer = tokenizer or SimpleTokenizer()
        self.mode = mode
        self.args = args or DataArgs(proj_out_num=4, max_length=64, max_text_len=32)
        self.num_slices = num_slices
        self.slice_dim = slice_dim
        self.data_list = list(range(n))
        self._reports = list(reports) if reports is not None else [
            f"Synthetic report {i}. No acute abnormality. Lungs are clear."
            for i in range(n)
        ]

    def get(self, idx):
        rng = np.random.default_rng(idx)
        image = rng.random(self.shape, np.float32)
        text = self._reports[idx]
        if self.mode == "clip":
            tok = self.tokenizer(
                text, max_length=self.args.max_text_len, truncation=True,
                padding="max_length",
            )
            return {
                "image": image,
                "input_ids": tok["input_ids"][0],
                "attention_mask": tok["attention_mask"][0],
                "text": text,
            }
        image_2d = rng.random((self.num_slices, self.slice_dim), np.float32)
        if self.mode == "clip2":
            tok = self.tokenizer(
                text, max_length=self.args.max_text_len, truncation=True,
                padding="max_length",
            )
            return {
                "image": image,
                "image_2d": image_2d,
                "input_ids": tok["input_ids"][0],
                "attention_mask": tok["attention_mask"][0],
                "text": text,
            }
        if self.mode == "seg":
            # synthetic seg QA: a random box blob and a [SEG]-token answer
            # (reference SegDataset semantics, multi_dataset.py:1354-1516)
            seg = np.zeros(self.shape, np.float32)
            d, h, w = self.shape[-3:]
            z0 = int(rng.integers(0, max(d // 2, 1)))
            y0 = int(rng.integers(0, max(h // 2, 1)))
            x0 = int(rng.integers(0, max(w // 2, 1)))
            seg[..., z0:z0 + d // 2, y0:y0 + h // 2, x0:x0 + w // 2] = 1.0
            question = (IM_PATCH_TOKEN * self.args.proj_out_num
                        + "Can you segment the lesion in this image?")
            answer = "It is [SEG]."
            tok = tokenize_qa_sample(self.tokenizer, question, answer,
                                     self.args.max_length)
            return {
                "image": image,
                "image_2d": image_2d,
                "seg": seg,
                "input_ids": tok["input_ids"],
                "attention_mask": tok["attention_mask"],
                "labels": tok["labels"],
                "question": question,
                "answer": answer,
            }
        question = IM_PATCH_TOKEN * self.args.proj_out_num + "Describe the scan."
        tok = tokenize_qa_sample(
            self.tokenizer, question, text, self.args.max_length
        )
        return {
            "image": image,
            "image_2d": image_2d,
            "input_ids": tok["input_ids"],
            "attention_mask": tok["attention_mask"],
            "labels": tok["labels"],
            "question": question,
            "answer": text,
        }
