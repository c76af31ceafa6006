"""Sliding-window volumetric inference and the cached-embedding predictor
for SegVol (the port of the JAX package's eval/sliding_window.py).

Clinical volumes are larger than SegVol's (32, 256, 256) ROI, so
`sliding_window_segment` tiles the volume at fixed window offsets and
blends the overlaps uniformly (MONAI's sliding_window_inference without
the Gaussian). `SegVolPredictor` is the reference's `SamPredictor` API: the
image encoder runs once per volume and each prompt pays only the prompt
encoder, the mask decoder and the upsample. `automatic_mask_generation`
prompts the decoder with a grid of points and keeps the confident masks
after a greedy 3D box NMS.

Every function takes the device of the tensors it is given; the models'
kernels run where the models live.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from hsenet_torch.data.preprocess import resize


def window_offsets(image_shape: Sequence[int], roi: Sequence[int],
                   overlap: float = 0.25) -> np.ndarray:
    """(N, 3) window start offsets covering the volume."""
    starts = []
    for dim, r in zip(image_shape, roi):
        if dim <= r:
            starts.append([0])
            continue
        step = max(1, int(r * (1 - overlap)))
        s = list(range(0, dim - r, step)) + [dim - r]
        starts.append(sorted(set(s)))
    return np.array(list(itertools.product(*starts)), np.int32)


@torch.no_grad()
def sliding_window_segment(predict_roi: Callable[[torch.Tensor], torch.Tensor],
                           volume: torch.Tensor, roi: Tuple[int, int, int],
                           overlap: float = 0.25) -> torch.Tensor:
    """Tile `volume` ((C, D, H, W)), run `predict_roi` ((1, C, *roi) ->
    (1, 1, *roi) logits) on each window and average the overlaps:
    (1, D, H, W) f32."""
    spatial = tuple(volume.shape[1:])
    logits = torch.zeros((1, *spatial), dtype=torch.float32,
                         device=volume.device)
    counts = torch.zeros(spatial, dtype=torch.float32, device=volume.device)
    for z, y, x in window_offsets(spatial, roi, overlap).tolist():
        win = (slice(z, z + roi[0]), slice(y, y + roi[1]), slice(x, x + roi[2]))
        out = predict_roi(volume[(slice(None), *win)][None])[0, 0]
        logits[(slice(None), *win)] += out.float()[None]
        counts[win] += 1.0
    return logits / counts.clamp_min(1.0)[None]


def make_segvol_predictor(model):
    """`predict(volume, text_embedding=None, boxes=None)`: SegVol's logits
    of one ROI, without gradients (the JAX function's unused
    `text_encoder` is left out)."""

    @torch.no_grad()
    def predict(volume, text_embedding=None, boxes=None):
        return model(volume, text_embedding, boxes)

    return predict


class ResizeTransform3D:
    """Volume and prompt coordinate transforms between a volume's own frame
    and the model's fixed (D, H, W) frame (the reference's
    `ResizeLongestSide`): each axis resizes on its own (the linear resize
    of the JAX package), and voxel prompts map to [0, 1] by a per-axis
    division by the original extent."""

    def __init__(self, target_size: Tuple[int, int, int]):
        self.target_size = tuple(int(s) for s in target_size)

    def apply_volume(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, C, D, H, W) at any resolution -> the model's."""
        if tuple(volume.shape[2:]) == self.target_size:
            return volume
        return resize(volume, (*volume.shape[:2], *self.target_size), "linear")

    def apply_coords(self, coords, original_size) -> np.ndarray:
        """Voxel (z, y, x) coordinates of the original frame -> [0, 1]."""
        return (np.asarray(coords, np.float32)
                / np.asarray(original_size, np.float32))

    def apply_boxes(self, boxes, original_size) -> np.ndarray:
        """Voxel (z1, y1, x1, z2, y2, x2) boxes -> [0, 1], corner by corner."""
        boxes = np.asarray(boxes, np.float32)
        shaped = self.apply_coords(boxes.reshape(*boxes.shape[:-1], 2, 3),
                                   original_size)
        return shaped.reshape(*boxes.shape[:-1], 6)


class SegVolPredictor:
    """The cached-embedding prompt loop (the reference's `SamPredictor`,
    predictor.py:17-262): `set_image` encodes a volume once at any
    resolution (resampled to the model's frame), `predict` decodes a prompt
    against the cached grid and returns logits at the volume's ORIGINAL
    resolution; `boxes_voxel` / `points_voxel` take prompts in the
    original frame's voxels."""

    def __init__(self, model):
        self._model = model
        self.transform = ResizeTransform3D(model.vision.image_size)
        self._features = None
        self._out_shape = None

    @torch.no_grad()
    def set_image(self, volume: torch.Tensor) -> None:
        self._out_shape = tuple(int(s) for s in volume.shape[2:])
        self._features = self._model.encode_image(
            self.transform.apply_volume(volume))

    @property
    def is_image_set(self) -> bool:
        return self._features is not None

    def get_image_embedding(self) -> torch.Tensor:
        if self._features is None:
            raise RuntimeError("set_image first (predictor.py:245-257)")
        return self._features

    def reset_image(self) -> None:
        self._features = None
        self._out_shape = None

    @torch.no_grad()
    def predict(self, text_embedding: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None, points=None,
                multimask_output: bool = False, boxes_voxel=None,
                points_voxel=None) -> torch.Tensor:
        if self._features is None:
            raise RuntimeError("set_image first (predictor.py:102-105)")
        device = self._features.device
        if boxes_voxel is not None:
            if boxes is not None:
                raise ValueError("pass boxes or boxes_voxel, not both")
            boxes = torch.as_tensor(
                self.transform.apply_boxes(boxes_voxel, self._out_shape),
                device=device)
        if points_voxel is not None:
            if points is not None:
                raise ValueError("pass points or points_voxel, not both")
            coords, labels = points_voxel
            points = (torch.as_tensor(
                self.transform.apply_coords(coords, self._out_shape),
                device=device), torch.as_tensor(labels, device=device))
        return self._model.decode(
            self._features, self._out_shape, text_embedding=text_embedding,
            boxes=boxes, points=points, multimask_output=multimask_output)


def _mask_box_3d(mask: np.ndarray):
    """Tight (z1, y1, x1, z2, y2, x2) voxel box of a boolean mask, or None
    for an empty one."""
    idx = np.argwhere(mask)
    if idx.size == 0:
        return None
    return np.concatenate([idx.min(axis=0), idx.max(axis=0) + 1])


def _box_iou_3d_np(a: np.ndarray, b: np.ndarray) -> float:
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    inter = float(np.prod(np.maximum(hi - lo, 0)))
    va = float(np.prod(a[3:] - a[:3]))
    vb = float(np.prod(b[3:] - b[:3]))
    return inter / max(va + vb - inter, 1e-9)


def nms_proposals(proposals, iou_thresh: float = 0.7, score_key="stability"):
    """Greedy 3D box NMS over mask proposals, best score first (the
    reference's AMG dedups at box_nms_thresh 0.7)."""
    kept = []
    for p in sorted(proposals, key=lambda p: -p[score_key]):
        box = p.get("box")
        if box is None:
            box = p["box"] = _mask_box_3d(p["mask"])
        if box is None:
            continue
        if all(_box_iou_3d_np(box, k["box"]) < iou_thresh for k in kept):
            kept.append(p)
    return kept


@torch.no_grad()
def automatic_mask_generation(model, volume: torch.Tensor,
                              points_per_side: int = 4,
                              stability_thresh: float = 0.0,
                              box_nms_thresh: Optional[float] = 0.7):
    """Prompt the decoder with a (points_per_side)^3 grid of positive points
    over a (1, 1, D, H, W) volume at the model's ROI; keep each non-empty
    mask whose stability (the share of its voxels above 0.7) clears
    `stability_thresh`, then greedy box NMS (None: no dedup). Returns
    {mask (D, H, W) bool, stability, point (3,), box} dicts. (The JAX
    function's `pred_iou_thresh` reads nothing and is left out.)"""
    lin = (np.arange(points_per_side) + 0.5) / points_per_side
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    labels = torch.ones((1, 1), dtype=torch.int32, device=volume.device)
    proposals = []
    for p in grid:
        coords = torch.as_tensor(p, dtype=torch.float32,
                                 device=volume.device)[None, None]
        logits = model(volume, None, None, (coords, labels))[0, 0]
        probs = 1.0 / (1.0 + np.exp(-logits.cpu().numpy()))
        mask = probs > 0.5
        if mask.sum() == 0:
            continue
        stability = (probs > 0.7).sum() / max(mask.sum(), 1)
        if stability < stability_thresh:
            continue
        proposals.append({"mask": mask, "stability": float(stability),
                          "point": p})
    if box_nms_thresh is not None:
        proposals = nms_proposals(proposals, box_nms_thresh)
    return proposals
