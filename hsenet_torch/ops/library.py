"""The port's forward kernels as registered PyTorch operators.

`torch.export` and the other graph tracers see a ctypes launch as opaque
Python; a registered operator is one node of the graph that runs its
kernel when the graph is called. Two operators live in the `hsenet_torch`
namespace:

  * `hsenet_torch::flash_fwd(q, k, v, kv_lens, q_offset, causal, sm_scale,
    with_lse) -> (out, lse)`, B1 (`ops/flash_attention.py`): q, k, v at the
    kernel width; out a (B, H, S, D) view of a (B, S, H, D) buffer; lse
    (B, H, S) f32, or an empty (0,) tensor without `with_lse`;
  * `hsenet_torch::quant_matvec(x, w_q, scale) -> y`, B5
    (`ops/quant_matvec.py`): x (M <= 8, K), w_q (N, K) int8, scale (N,) f32,
    y (M, N) in x's dtype.

Each has a CUDA implementation (the hand-written kernel, which counts its
launch), a CPU implementation (the kernel's plain version) and a fake one
(shapes and strides only, for tracing). The ops are registered through
`torch.library.Library` rather than `torch.library.custom_op`: the latter's
Python wrapper costs several times more host time a call, and the serving
decode step launches B5 224 times.

Neither op has an autograd formula: `_FlashAttention` carries the flash
gradient around the forward op, and B5 is taken only where no gradient is
recorded. The backward kernels (B3/B4) stay direct calls: no exported
program has a backward.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "hsenet_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable,
           fake: Callable) -> "torch._ops.OpOverload":
    """Define `hsenet_torch::<name><schema>` with its CUDA, CPU and fake
    implementations; returns the op's default overload."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
