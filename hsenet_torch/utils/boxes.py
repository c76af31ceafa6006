"""3D box utilities for grounding (REC/REG) tasks (the port's own copy of
the JAX package's utils/boxes.py, which imports no JAX).

Reference: `LaMed/src/utils/utils.py` / duplicated `Bench/utils.py:4-54`:
mask2box (normalized z1y1x1z2y2x2 from a binary 3D mask), box extraction
from generated text, IoU for box evaluation.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np


def mask2box(
    mask: np.ndarray, reference_compatible: bool = False
) -> Optional[np.ndarray]:
    """Binary (D, H, W) mask -> normalized [z1, y1, x1, z2, y2, x2] box.

    Default uses the half-open convention (hi = max_index + 1), so a
    full-extent mask maps to [0, 1]. ``reference_compatible=True``
    reproduces the reference's `Bench/utils.py:4-28` exactly: hi =
    max_index / extent (closed upper corner) and every coordinate rounded
    to 3 decimals — needed for parity scoring against reference outputs.
    """
    nz = np.nonzero(mask)
    if len(nz[0]) == 0:
        return None
    dims = mask.shape
    lo = [int(n.min()) for n in nz]
    if reference_compatible:
        hi = [int(n.max()) for n in nz]
        vals = [round(v / d, 3) for v, d in zip(lo + hi, list(dims) * 2)]
        return np.asarray(vals, np.float32)
    hi = [int(n.max()) + 1 for n in nz]
    return np.array(
        [lo[0] / dims[0], lo[1] / dims[1], lo[2] / dims[2],
         hi[0] / dims[0], hi[1] / dims[1], hi[2] / dims[2]],
        np.float32,
    )


def format_box(box: Sequence[float], precision: int = 3) -> str:
    """Box -> answer string '<bx_start>[z1,y1,x1,z2,y2,x2]<bx_end>'
    (PosREC answer format, multi_dataset.py:1105-1117; the reference's
    mask2box rounds to 3 decimals, Bench/utils.py:19-26)."""
    nums = ",".join(f"{v:.{precision}f}" for v in box)
    return f"<bx_start>[{nums}]<bx_end>"


_BOX_RX = re.compile(r"\[([\d\.,\s-]+)\]")


def extract_box_from_text(text: str) -> Optional[np.ndarray]:
    """First [z1,y1,x1,z2,y2,x2] list found in generated text -> box array
    (Bench/utils.py extract_box_from_text)."""
    m = _BOX_RX.search(text)
    if not m:
        return None
    try:
        vals = [float(v) for v in m.group(1).split(",") if v.strip()]
    except ValueError:
        return None
    if len(vals) != 6:
        return None
    return np.asarray(vals, np.float32)


def box_iou_3d(
    a: np.ndarray, b: np.ndarray, reference_compatible: bool = False
) -> float:
    """IoU of two [z1,y1,x1,z2,y2,x2] boxes.

    Default is the standard IoU (intersection / union-of-volumes). The
    reference's `calculate_iou` (Bench/utils.py:38-54) instead divides by
    the product of per-axis *bounding extents* (max-min over both boxes) —
    a different, smaller-denominator formula that inflates scores for
    nested boxes and deflates for disjoint ones. Pass
    ``reference_compatible=True`` when scoring acc@{.25,.5} for parity
    against numbers produced by the reference harness.
    """
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    inter = float(np.prod(np.maximum(hi - lo, 0.0)))
    if reference_compatible:
        span = np.maximum(a[3:], b[3:]) - np.minimum(a[:3], b[:3])
        return inter / (float(np.prod(span)) + 1e-6)
    va = float(np.prod(np.maximum(a[3:] - a[:3], 0.0)))
    vb = float(np.prod(np.maximum(b[3:] - b[:3], 0.0)))
    union = va + vb - inter
    return inter / union if union > 0 else 0.0


def mask_to_rle(mask: np.ndarray) -> dict:
    """Run-length encode a boolean mask of any rank (reference
    `segment_anything_volumetric/utils/amg.py::mask_to_rle_pytorch`
    semantics, flattened C-order, counts alternating starting with the
    zero-run). Compact serialization for AMG proposals."""
    flat = np.asarray(mask, bool).reshape(-1)
    # positions where the value changes, bounded by the two ends
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts  # encoding always starts with a zero-run
    return {"size": list(mask.shape), "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Inverse of `mask_to_rle`."""
    total = int(np.prod(rle["size"])) if rle["size"] else 0
    flat = np.zeros(total, bool)
    pos, val = 0, False
    for c in rle["counts"]:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(rle["size"])
