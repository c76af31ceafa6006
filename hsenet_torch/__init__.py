"""hsenet_torch: the PyTorch/CUDA port of the HSENet JAX package
(hsenet-tpu) for NVIDIA Hopper.

The package mirrors the JAX package's module names (`ops/`, `models/`,
`eval/`, `train/`, `data/`) and holds every module against its JAX
counterpart in the tests. Entry points run on the CUDA card unless the
caller passes `device="cpu"`; there each hand-written kernel is replaced by
its plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent.

    The port never falls back to the CPU on its own: a caller who wants the
    plain versions on the CPU says `device="cpu"`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hsenet_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions"
        )
    return device
