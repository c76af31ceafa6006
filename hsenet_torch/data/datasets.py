"""The part of the JAX package's data/datasets.py that the VLM finetune's
and the CLIP stages' batches need: the tokenization rule, the word-level
tokenizer of tests and synthetic runs, batching and the host loader, and
the synthetic CT dataset in caption, clip and clip2 modes. The host side is
plain numpy, as in the JAX package; the trainer moves each batch to the
device. The CT-RATE datasets come with the port's CLIP CLIs.

Reproduced semantics: question = [BOS] + "<im_patch>" * proj_out_num +
prompt; question + " " + answer tokenized right-padded, EOS patched at the
valid length, labels -100 over the question span and the padding.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

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
    The JAX package's thread-pool decoding and multi-host sharding come
    with later slices of the port."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        collate_fn: Callable = collate,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.collate_fn = collate_fn
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if len(idxs) < self.batch_size and self.drop_remainder:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idxs])


class SyntheticCTDataset(_RetryDataset):
    """In-memory synthetic volumes + toy reports, same sample dicts as the
    real datasets — lets every train path run without CT-RATE on disk.
    `reports`, when given, replaces the toy reports (one text per sample)."""

    def __init__(
        self,
        n: int = 32,
        shape=(1, 32, 256, 256),
        tokenizer=None,
        mode: str = "clip",  # clip | clip2 | caption (seg: a later slice)
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
        if self.mode not in ("clip", "clip2", "caption"):
            raise NotImplementedError(
                f"SyntheticCTDataset mode {self.mode!r} comes with a later "
                "slice of the port (the SEG stage)"
            )
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
