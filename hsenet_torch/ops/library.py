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

Two more hold the train step's optimizer (`ops/multi_tensor.py`), so that a
profile puts their kernels under an operation (a ctypes launch outside any
operation is linked to none):

  * `hsenet_torch::multi_tensor_sum_squares(grads) -> sums`: each f32
    gradient's sum of squares, an (n,) f32 vector;
  * `hsenet_torch::multi_tensor_adamw_(params!, grads, mus!, nus!,
    grad_norm, hyper)`: the clip by global norm and AdamW in place (no CPU
    implementation: `AdamW.update_per_leaf` is its plain version).

Each has a CUDA implementation (the hand-written kernel, which counts its
launch), a CPU implementation (the kernel's plain version) unless said
otherwise above, and a fake one (shapes and strides only, for tracing).
The ops are registered through `torch.library.Library` rather than
`torch.library.custom_op`: the latter's Python wrapper costs several times
more host time a call, and the serving decode step launches B5 224 times.

No op has an autograd formula: `_FlashAttention` carries the flash
gradient around the forward op, and B5 is taken only where no gradient is
recorded. The backward kernels (B3/B4) stay direct calls: no exported
program has a backward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NAMESPACE = "hsenet_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, *, cuda: Callable, fake: Callable,
           cpu: Optional[Callable] = None) -> "torch._ops.OpOverload":
    """Define `hsenet_torch::<name><schema>` with its CUDA, CPU (if any) and
    fake implementations; returns the op's default overload."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    if cpu is not None:
        LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
