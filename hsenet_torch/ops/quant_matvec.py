"""int8 weight-only matvec: the hand-written Hopper kernel, its plain
PyTorch version and the dispatcher (the port of the JAX package's
ops/quant_matvec.py).

`quant_matvec_int8(x, w_q, scale)` computes (..., K) @ int8 W * scale ->
(..., N) for the decode-small row counts of the serving engine: each token
reads every live weight once, so the work is bound by the bytes of the
codes, and a plain `x @ w_q.to(dtype)` would write and re-read a
full-width copy of them.

The codes are stored `(N, K)`: one output channel is one contiguous row
of K codes, the layout the kernel reads (and the transpose of the JAX
package's `(K, N)` `kernel_q`, the same transpose `bridge.py` applies to a
float `kernel`).

Dispatch rule (the counterpart of the JAX function's, with this card's
alignment rule in place of the TPU's `_pick_block_n` tiling rule): the
kernel's function (f32 accumulate, f32 scale, one cast) is taken when

  * the row count M (the product of x's leading dimensions) is at most
    `MAX_KERNEL_ROWS`,
  * K is a multiple of `K_ALIGN` (16-byte loads of the codes),
  * x is bf16 or f32, and
  * autograd records no gradient for x (the kernel is forward-only);

every other call takes the model's plain expression
`(x @ W^T) * scale` in x's dtype, which is also the gradient path. Inside
the rule a CUDA tensor launches `csrc/quant_matvec.cu` and a CPU tensor
runs `quant_matvec_int8_reference`; the call never falls from one to the
other.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from hsenet_torch.ops import _build

KERNEL = "quant_matvec"
# rows above this are compute-shaped work for the library's matmul
MAX_KERNEL_ROWS = 8
# the kernel loads 16 codes (16 bytes) at a time
K_ALIGN = 16
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def quant_matvec_int8_reference(x: torch.Tensor, w_q: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its precision: the sum
    over K and the per-channel scale in f32, one cast to x's dtype.

    x (..., K); w_q (N, K) int8; scale (N,) f32."""
    acc = torch.matmul(x.float(), w_q.float().t())
    return (acc * scale.float()).to(x.dtype)


def plain_expression(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The model's expression (the JAX package's `LoRADense` line): the
    product and the scale in x's dtype."""
    return F.linear(x, w_q.to(x.dtype)) * scale.to(x.dtype)


def in_kernel_rule(x: torch.Tensor, w_q: torch.Tensor) -> bool:
    """Whether the dispatch rule gives this call to the kernel's function."""
    rows = math.prod(x.shape[:-1])
    return (
        1 <= rows <= MAX_KERNEL_ROWS
        and w_q.shape[1] % K_ALIGN == 0
        and x.dtype in KERNEL_DTYPES
        and not (torch.is_grad_enabled() and x.requires_grad)
    )


def _kernel():
    fn = _build.load(KERNEL).hsenet_quant_matvec
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def quant_matvec_kernel(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x (M <= 8, K) bf16 or f32,
    w_q (N, K) int8, scale (N,) f32 -> (M, N) in x's dtype. Raises on what
    the kernel does not take."""
    if x.device.type != "cuda":
        raise RuntimeError(
            f"the quant_matvec kernel runs on a CUDA device, x is on {x.device}"
        )
    if x.ndim != 2 or not 1 <= x.shape[0] <= MAX_KERNEL_ROWS:
        raise ValueError(f"x must be (M <= {MAX_KERNEL_ROWS}, K), got {tuple(x.shape)}")
    m, k = x.shape
    n = w_q.shape[0]
    if w_q.dtype != torch.int8 or w_q.shape != (n, k) or k % K_ALIGN:
        raise ValueError(
            f"w_q must be int8 (N, K = {k}) with K a multiple of {K_ALIGN}, "
            f"got {w_q.dtype} {tuple(w_q.shape)}"
        )
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"scale must be f32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous, 16-byte aligned and on {x.device}"
            )
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _kernel()(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quant_matvec kernel launch failed: CUDA error {err}")
    launches[KERNEL] += 1
    return y


def quant_matvec_int8(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """(..., K) @ int8 (N, K)^T * scale -> (..., N), by the dispatch rule
    of the module docstring."""
    if not in_kernel_rule(x, w_q):
        return plain_expression(x, w_q, scale)
    if x.device.type == "cpu":
        return quant_matvec_int8_reference(x, w_q, scale)
    lead = x.shape[:-1]
    y = quant_matvec_kernel(x.reshape(-1, x.shape[-1]).contiguous(), w_q, scale)
    return y.reshape(*lead, w_q.shape[0])


# kernel launches since the last reset; chip_smoke.py reads the count to
# show that the decode steps of the serving engine went through the kernel
launches = {KERNEL: 0}


def reset_launch_counts() -> None:
    launches[KERNEL] = 0
