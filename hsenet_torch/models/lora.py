"""LoRA dense layer (the port of the JAX package's
models/lora.py::LoRADense).

The base weight keeps the name `weight` (the Linear layout, (out, in)) and
the adapters are `lora_a` (in, r) and `lora_b` (r, out), in the JAX
package's layout. y = x W^T + b + (drop(x) A) B * alpha / r, with LoRA
dropout on the adapter's input only. Every weight is cast to the compute
dtype at use, so the adapters can be held as f32 masters for training over
a bf16 base. The int8 weight-only form comes with the serving slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import LoRAConfig
from hsenet_torch.models.layers import Dense, dropout


class LoRADense(Dense):
    """Dense with optional LoRA adapters, computing in `dtype`."""

    def __init__(self, in_dim: int, features: int, *, use_bias: bool = False,
                 lora: Optional[LoRAConfig] = None, quantized: bool = False,
                 dtype=torch.float32, device="cuda"):
        if quantized:
            raise NotImplementedError(
                "int8 LoRADense comes with the serving slice of the port"
            )
        device = resolve_device(device)
        super().__init__(in_dim, features, bias=use_bias, dtype=dtype,
                         device=device)
        self.lora = lora
        if lora is not None:
            self.lora_a = nn.Parameter(
                torch.zeros(in_dim, lora.rank, dtype=dtype, device=device)
            )
            self.lora_b = nn.Parameter(
                torch.zeros(lora.rank, features, dtype=dtype, device=device)
            )

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        y = super().forward(x)
        if self.lora is not None:
            dt = self.compute_dtype
            h = dropout(x, self.lora.dropout_rate, deterministic)
            y = y + (h @ self.lora_a.to(dt)) @ self.lora_b.to(dt) * self.lora.scale
        return y
