"""Train-time augmentation on the device, batched (the port of the JAX
package's data/augment.py).

Reference augmentations (MONAI Compose, multi_dataset.py:45-56):
RandRotate90(prob .5, axes (1,2)) / RandFlip(prob .1, each of 3 axes) /
RandScaleIntensity(.1, prob .5) / RandShiftIntensity(.1, prob .5), per
sample on CPU workers there.

Here the draws and their application are apart. `draw_augment` makes each
sample's few numbers on a CPU `torch.Generator` (so the CPU and the card
draw the same augmentations from the same seed); `apply_augment` applies
them to the batch on its device, exactly: rot90 and flips are copies, the
intensity scale a multiply and the shift an add, in the JAX package's
order. The JAX package draws from a PRNG key; `apply_augment` at its draws
gives its `augment_batch` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hsenet_torch.configs import AugmentConfig


@dataclass
class AugmentDraws:
    """Per-sample draws, each a (B,) CPU tensor: quarter turns over (H, W)
    in {0..3}, a flip of each spatial axis (D, H, W), the intensity factor
    (1 where not scaled) and offset (0 where not shifted)."""

    rot90: torch.Tensor
    flip: torch.Tensor  # (B, 3) bool
    scale: torch.Tensor
    shift: torch.Tensor


def draw_augment(generator: torch.Generator, batch: int,
                 cfg: AugmentConfig = AugmentConfig()) -> AugmentDraws:
    """The draws for `batch` samples from a CPU `generator`: each
    transform happens with its probability; a rotation turns 1, 2 or 3
    quarters; the factor is 1 + U(-f, f) and the offset U(-o, o)."""

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    do_rot = uniform(batch) < cfg.rot90_prob
    turns = torch.randint(1, 4, (batch,), generator=generator)
    flip = uniform(batch, 3) < cfg.flip_prob
    do_scale = uniform(batch) < cfg.scale_intensity_prob
    factor = 1.0 + (2.0 * uniform(batch) - 1.0) * cfg.scale_intensity_factor
    do_shift = uniform(batch) < cfg.shift_intensity_prob
    offset = (2.0 * uniform(batch) - 1.0) * cfg.shift_intensity_offset
    return AugmentDraws(
        rot90=torch.where(do_rot, turns, 0),
        flip=flip,
        scale=torch.where(do_scale, factor, 1.0).float(),
        shift=torch.where(do_shift, offset, 0.0).float(),
    )


def apply_augment(volumes: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """volumes (B, C, D, H, W) -> the batch with each sample's draws
    applied: rot90 over (H, W), then the flips, then x * factor, then
    x + offset (a sample whose draw is off is left as it is)."""
    out = []
    for i, vol in enumerate(volumes):
        k = int(draws.rot90[i])
        if k:
            vol = torch.rot90(vol, k, dims=(2, 3))
        axes = [1 + a for a in range(3) if bool(draws.flip[i, a])]
        if axes:
            vol = torch.flip(vol, dims=axes)
        # f32 draws as Python floats: the same values, and no copy to the
        # device
        factor, offset = float(draws.scale[i]), float(draws.shift[i])
        if factor != 1.0:
            vol = vol * factor
        if offset != 0.0:
            vol = vol + offset
        out.append(vol)
    return torch.stack(out)


def augment_batch(volumes: torch.Tensor, generator: torch.Generator,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """`apply_augment(volumes, draw_augment(generator, len(volumes), cfg))`."""
    return apply_augment(volumes, draw_augment(generator, volumes.shape[0], cfg))
