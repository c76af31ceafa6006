"""Prompt templates for MRG / VQA finetuning and evaluation (the port's own
copy of the JAX package's data/prompts.py).

The reference ships 43 caption prompts and 50 location-VQA prompts
(`dataset/prompt_templates.py`). These are our own template sets with the
same roles and interface; checkpoint-parity runs can load the reference's
exact strings from a JSON file via `load_templates`.
"""

from __future__ import annotations

import json
from typing import Dict, List

Caption_templates: List[str] = [
    "Please describe the findings in this chest CT volume.",
    "Generate a radiology report for the given CT scan.",
    "What abnormalities can be identified in this CT image?",
    "Summarize the key observations of this thoracic CT study.",
    "Write the findings section of a report for this volume.",
    "Describe any pathological changes visible in this scan.",
    "Provide a detailed reading of this chest CT examination.",
    "Report the radiological findings of the displayed CT volume.",
    "What does this CT scan of the chest show?",
    "Compose a diagnostic report based on this 3D image.",
    "Interpret the imaging findings of this chest CT.",
    "List the notable findings present in this CT study.",
    "Give a comprehensive description of this CT volume.",
    "What is your impression of this thoracic CT scan?",
    "Draft the findings for this patient's chest CT.",
    "Analyze this CT image and describe all abnormalities.",
]

VQA_location_templates: List[str] = [
    "Where is the {abnormality} located in this image?",
    "In which anatomical region can the {abnormality} be found?",
    "Identify the location of the {abnormality} in this CT scan.",
    "Which part of the chest shows the {abnormality}?",
    "Point out the anatomical position of the {abnormality}.",
    "What region of this volume contains the {abnormality}?",
    "Locate the {abnormality} in the displayed CT image.",
    "Which anatomy is affected by the {abnormality}?",
    "Tell me where the {abnormality} appears in this scan.",
    "Specify the site of the {abnormality} in this CT study.",
    "The {abnormality} in this image is situated in which region?",
    "Name the anatomical structure where the {abnormality} is seen.",
]

# Grounding / segmentation template groups. Same six-group structure as the
# reference's PosREC/PosREG/Seg template dicts (prompt_templates.py:101-500):
# plain ("cls") and description-mode ("des") questions, answers for found
# targets, and no-answers for absent targets. All slots are positional "{}"
# like the reference, so `load_templates` can drop in the reference's exact
# exported strings unchanged. Strings here are our own.

PosREC_templates: Dict[str, List[str]] = {
    "cls_questions": [
        "Where is the {} in this volume? Answer with a bounding box.",
        "Give the 3D box coordinates of the {}.",
        "Locate the {} and reply with normalized coordinates.",
        "Find the {} and output its bounding box.",
        "Mark the extent of the {} with box coordinates.",
    ],
    "des_questions": [
        "Description: {} Name the structure and give its bounding box.",
        "Based on this description: {} — identify it and output the box.",
        "{} Which structure is this? Reply with its coordinates.",
        "Given the definition: {} locate it with a bounding box.",
    ],
    "cls_answers": [
        "It is at {}.",
        "The bounding box is {}.",
        "Coordinates: {}.",
        "You can find it at {}.",
    ],
    "des_answers": [
        "That is the {}, located at {}.",
        "It matches the {}; bounding box {}.",
        "The structure is the {} at {}.",
    ],
    "cls_no_answers": [
        "The {} is not visible in this volume.",
        "No {} can be found in this scan.",
        "This image does not contain the {}.",
    ],
    "des_no_answers": [
        "That would be the {}, but it is not present in this volume.",
        "It describes the {}, which does not appear in this scan.",
    ],
}

PosREG_templates: Dict[str, List[str]] = {
    "cls_questions": [
        "What is inside the region {}?",
        "Identify the structure within the bounding box {}.",
        "Which organ occupies the region {} of this volume?",
        "Name the target located at {}.",
        "What does the box {} contain?",
    ],
    "des_questions": [
        "Describe the structure inside the region {}.",
        "Give a description of what occupies the box {}.",
    ],
    # when the target is absent there is no box to ask about, so the
    # reference swaps in name-slot "no" questions (multi_dataset.py:1297-1303)
    "cls_no_questions": [
        "Is the {} visible in this volume?",
        "Can you find the {} here?",
    ],
    "des_no_questions": [
        "Description: {} Can you find this structure?",
        "{} Is a structure matching this description present?",
    ],
    "cls_answers": [
        "It is the {}.",
        "That region contains the {}.",
        "The structure there is the {}.",
    ],
    "des_answers": [
        "That is the {}: {}",
        "It is the {} — {}",
        "The structure is the {}; described as {}",
    ],
    "cls_no_answers": [
        "No, the {} is not visible here.",
        "The {} is absent from this volume.",
    ],
    "des_no_answers": [
        "That is the {}, but it does not appear in this volume.",
    ],
}

Seg_templates: Dict[str, List[str]] = {
    "cls_questions": [
        "Please segment the {} in this image.",
        "Can you segment the {}? Output the mask.",
        "Produce a segmentation mask for the {}.",
        "Outline the {} in this volume.",
        "Extract the {} as a mask, please.",
    ],
    "des_questions": [
        "Description: {} Identify it and segment it.",
        "{} Segment the structure matching this description.",
        "Given the definition: {} please answer and output the mask.",
    ],
    "cls_answers": [
        "It is [SEG].",
        "Here is the mask: [SEG].",
        "The segmentation result is [SEG].",
        "[SEG].",
    ],
    "des_answers": [
        "That is the {}; the mask is [SEG].",
        "The structure is the {}: [SEG].",
        "Identified as the {}, segmentation [SEG].",
    ],
    "cls_no_answers": [
        "The {} is not present, so no mask can be produced.",
        "This volume does not contain the {}.",
    ],
    "des_no_answers": [
        "That describes the {}, which is absent from this volume.",
    ],
}


def load_templates(path: str) -> Dict[str, object]:
    """Load replacement template sets (e.g. the reference's exact strings
    exported to JSON by scripts/export_reference_data.py) — keys: caption,
    vqa_location, posrec, posreg, seg (the last three are six-group dicts)."""
    with open(path) as f:
        return json.load(f)
