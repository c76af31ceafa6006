"""Weight converters of the port (the port of the JAX package's
utils/convert.py). So far: `quantize_clip_w8a8`, the one-call serving prep
of the W8A8 encode mode."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hsenet_torch.models.clip import CLIPModel
from hsenet_torch.models.lora import (
    calibrate_w8a8_act_scales,
    quantize_towers_w8a8,
)


def quantize_clip_w8a8(state: Dict[str, torch.Tensor], config, *,
                       volumes: Optional[np.ndarray] = None,
                       slice_features: Optional[np.ndarray] = None,
                       batch_size: int = 2, seed: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """A float CLIP state_dict -> the state of the W8A8 serving encode mode:
    the vision tower's block kernels int8 with per-output-channel scales,
    and each block dense's static activation scale calibrated by one bf16
    `encode_image` pass. Text and projection weights are returned as given.

    `volumes` default to unit-range noise from `seed` (preprocessed CT is
    min-max normalised to [0, 1], so noise bounds the input range); the
    2E3 tower's slice features likewise. The result loads strictly into
    `CLIPModel` with `vision=ViT3DConfig(quant_w8a8=True,
    quant_w8a8_static=True)`, on the device the state's tensors lie on.

    Unlike the JAX converter, the slice-guided cross-attention's `out_proj`
    stays float (there `quantize_kernels_int8` converts it by name, and the
    calibration pass then draws it anew)."""
    quantized = quantize_towers_w8a8(state, static=True)
    device = next(iter(state.values())).device
    vision = dataclasses.replace(config.vision, quant_w8a8=True,
                                 quant_w8a8_static=True)
    model = CLIPModel(dataclasses.replace(config, vision=vision),
                      dtype=torch.bfloat16, device=device)
    model.load_state_dict(quantized, strict=True)
    model.eval()
    rng = np.random.default_rng(seed)
    if volumes is None:
        volumes = rng.random(
            (batch_size, vision.in_channels, *vision.image_size), np.float32)
    batch = (torch.as_tensor(np.asarray(volumes, np.float32), device=device)
             .to(torch.bfloat16),)
    if vision.slice_guided:
        if slice_features is None:
            slice_features = rng.random(
                (batch[0].shape[0], vision.num_slices,
                 vision.slice_feature_dim), np.float32)
        batch += (torch.as_tensor(np.asarray(slice_features, np.float32),
                                  device=device),)
    calibrate_w8a8_act_scales(model, [batch], fn=model.encode_image)
    scales = {name: value.detach().clone()
              for name, value in model.state_dict().items()
              if name.endswith(".act_scale")}
    return {**quantized, **scales}
