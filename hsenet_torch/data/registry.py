"""Segmentation-dataset code registry (the port's own copy of the JAX
package's data/registry.py, which imports no JAX).

The reference enumerates 26 M3D-Seg corpora as code -> class-name lists
(`dataset/dataset_info.py:2-96`) and fans Pos/Seg datasets out over every
(code, plain/description) combination (`multi_dataset.py:1633-1689`). This
module is the equivalent registry: a small built-in set covering the demo
anatomy, `register`/`load_registry` to install the full 26-code table (the
reference's `dataset_info` exported to JSON by
the JAX package's `scripts/export_reference_data.py`), and the fan-out factories.

On disk each code follows the reference layout: `<seg_root>/<code>/<code>.json`
is a manifest whose entries carry image/seg paths and `cls_id` indices into
the code's class list.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional

# Built-in starter registry (our own entries; replace with the full
# 26-code table via load_registry for reference-data runs).
DEFAULT_SEG_REGISTRY: Dict[str, List[str]] = {
    "0000": ["liver"],
    "0002": [
        "spleen", "right kidney", "left kidney", "gall bladder", "esophagus",
        "liver", "stomach", "aorta", "postcava", "pancreas",
        "right adrenal gland", "left adrenal gland", "duodenum", "bladder",
        "prostate or uterus",
    ],
    "0003": ["liver", "kidney", "spleen", "pancreas"],
}


def load_registry(path: str) -> Dict[str, List[str]]:
    """JSON {code: [class names]} -> registry dict."""
    with open(path) as f:
        reg = json.load(f)
    for code, classes in reg.items():
        if not isinstance(classes, list):
            raise ValueError(f"registry[{code}] must be a list of names")
    return reg


def get_registry(path: Optional[str] = None) -> Dict[str, List[str]]:
    if path:
        return load_registry(path)
    return copy.deepcopy(DEFAULT_SEG_REGISTRY)


def code_manifest_path(seg_root: str, code: str) -> str:
    """Reference data layout: seg_data_path/<tag>/<tag>.json
    (multi_dataset.py:1019-1038 load_decathlon_datalist)."""
    return os.path.join(seg_root, code, f"{code}.json")


def build_multi_pos_dataset(
    args, tokenizer, seg_root: str,
    registry: Optional[Dict[str, List[str]]] = None,
    split: str = "train",
    templates: Optional[dict] = None,
    term_dictionary: Optional[Dict[str, List[str]]] = None,
):
    """MultiPosDataset equivalent (multi_dataset.py:1652-1669): for every
    registered code, REC and REG datasets in both plain and description
    modes, concatenated. `templates` may carry 'posrec'/'posreg' group dicts
    (e.g. from scripts/export_reference_data.py)."""
    from hsenet_torch.data.datasets import MixDataset, PosRECDataset, PosREGDataset

    registry = registry or get_registry()
    templates = templates or {}
    parts = []
    for code in sorted(registry):
        manifest = code_manifest_path(seg_root, code)
        # reference order per code: REC plain, REC des, REG plain, REG des
        # (multi_dataset.py:1660-1663)
        for cls, tkey in ((PosRECDataset, "posrec"), (PosREGDataset, "posreg")):
            for description in (False, True):
                parts.append(cls(
                    args, tokenizer, manifest, split=split,
                    classes=registry[code], description=description,
                    templates=templates.get(tkey),
                    term_dictionary=term_dictionary,
                ))
    return MixDataset(parts)


def build_multi_seg_dataset(
    args, tokenizer, seg_root: str,
    registry: Optional[Dict[str, List[str]]] = None,
    split: str = "train",
    templates: Optional[dict] = None,
    term_dictionary: Optional[Dict[str, List[str]]] = None,
):
    """MultiSegDataset equivalent (multi_dataset.py:1633-1649)."""
    from hsenet_torch.data.datasets import MixDataset, SegQADataset

    registry = registry or get_registry()
    templates = templates or {}
    parts = []
    for code in sorted(registry):
        manifest = code_manifest_path(seg_root, code)
        for description in (False, True):
            parts.append(SegQADataset(
                args, tokenizer, manifest, split=split,
                classes=registry[code], description=description,
                templates=templates.get("seg"),
                term_dictionary=term_dictionary,
            ))
    return MixDataset(parts)


def build_pos_seg_datasets(
    args, tokenizer, seg_root: str,
    registry: Optional[Dict[str, List[str]]] = None,
    split: str = "train",
    pad_seg_shape=None,
    templates: Optional[dict] = None,
    term_dictionary: Optional[Dict[str, List[str]]] = None,
):
    """PosSegDatasets equivalent (multi_dataset.py:1673-1689): grounding +
    segmentation mixed; non-seg samples get zero-filled masks so the whole
    mix collates together (train_VLM.py:266-312)."""
    from hsenet_torch.data.datasets import MixDataset

    pos = build_multi_pos_dataset(
        args, tokenizer, seg_root, registry, split, templates, term_dictionary
    )
    seg = build_multi_seg_dataset(
        args, tokenizer, seg_root, registry, split, templates, term_dictionary
    )
    return MixDataset(
        pos.datasets + seg.datasets, pad_seg_shape=pad_seg_shape
    )
