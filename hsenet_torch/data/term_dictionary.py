"""Anatomy term dictionary for description-mode grounding/seg datasets (the
port's own copy of the JAX package's data/term_dictionary.py).

The reference ships a 4.5k-line `term_dictionary.py` mapping each anatomy
class name to natural-language description synonyms (used by the
description-mode Pos/Seg datasets, multi_dataset.py:1019-1173). This module
provides a starter dictionary for the chest-CT anatomy the pipelines
actually target, plus a loader for user-supplied JSON dictionaries (e.g. an
export of the reference's full dict for checkpoint-parity runs).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List

term_dict: Dict[str, List[str]] = {
    "left lung": [
        "the lung on the left side",
        "left pulmonary field",
        "the left-sided lung parenchyma",
    ],
    "right lung": [
        "the lung on the right side",
        "right pulmonary field",
        "the right-sided lung parenchyma",
    ],
    "heart": [
        "the cardiac silhouette",
        "the heart structure in the mediastinum",
        "the cardiac chambers",
    ],
    "mediastinum": [
        "the central thoracic compartment",
        "the space between the lungs",
    ],
    "trachea": [
        "the main airway",
        "the windpipe",
    ],
    "esophagus": [
        "the food pipe behind the trachea",
        "the esophageal tube",
    ],
    "aorta": [
        "the largest artery leaving the heart",
        "the aortic vessel",
    ],
    "pleura": [
        "the membrane lining the lungs",
        "the pleural surface",
    ],
    "liver": [
        "the large organ in the right upper abdomen",
        "the hepatic parenchyma",
    ],
    "spleen": [
        "the organ in the left upper abdomen",
        "the splenic tissue",
    ],
    "kidney": [
        "the paired retroperitoneal organ",
        "the renal structure",
    ],
    "stomach": [
        "the gastric organ",
        "the stomach cavity",
    ],
    "bones": [
        "the osseous structures",
        "the skeletal elements of the thorax",
    ],
    "thyroid": [
        "the gland at the base of the neck",
        "the thyroid tissue",
    ],
    "breast": [
        "the breast tissue",
        "the mammary region",
    ],
}


def load_term_dict(path: str) -> Dict[str, List[str]]:
    """Load a replacement dictionary (JSON: name -> list of descriptions)."""
    with open(path) as f:
        return json.load(f)


def describe(target: str, rng: random.Random,
             dictionary: Dict[str, List[str]] = term_dict) -> str:
    """Random description for a target; falls back to the name itself."""
    options = dictionary.get(target.lower())
    return rng.choice(options) if options else target
