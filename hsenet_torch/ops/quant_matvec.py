"""int8 weight-only matvec: the hand-written Hopper kernels, their plain
PyTorch version and the dispatcher (the port of the JAX package's
ops/quant_matvec.py).

`quant_matvec_int8(x, w_q, scale)` computes (..., K) @ int8 W * scale ->
(..., N) for the decode-small row counts of the serving engine: each token
reads every live weight once, so the work is bound by the bytes of the
codes, and a plain `x @ w_q.to(dtype)` would write and re-read a
full-width copy of them.

The codes are stored `(N, K)`: one output channel is one contiguous row
of K codes, the layout the kernels read (and the transpose of the JAX
package's `(K, N)` `kernel_q`, the same transpose `bridge.py` applies to a
float `kernel`).

Dispatch rule (the counterpart of the JAX function's, with this card's
alignment rule in place of the TPU's `_pick_block_n` tiling rule): the
kernel's function (f32 accumulate, f32 scale, one cast) is taken when

  * the row count M (the product of x's leading dimensions) is at most
    `MAX_KERNEL_ROWS`,
  * K is a multiple of `K_ALIGN` (16-byte loads of the codes),
  * x is bf16 or f32, and
  * autograd records no gradient for x (the kernels are forward-only);

every other call takes the model's plain expression
`(x @ W^T) * scale` in x's dtype, which is also the gradient path. Inside
the rule a CPU tensor runs `quant_matvec_int8_reference`, and a CUDA
tensor launches one entry of `csrc/quant_matvec.cu`: bf16 x the tensor-core
kernel (`hsenet_quant_matvec_mma`, cut as `mma_plan` states), f32 x
the CUDA-core kernel (`hsenet_quant_matvec_fma`, exact f32 products). The
call never falls from one to another. The CUDA-core kernel's bf16 build
(`quant_matvec_fma_kernel`) is the yardstick chip_smoke.py times the
tensor-core kernel against; no path launches it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from hsenet_torch.ops import _build

KERNEL = "quant_matvec"  # the source, and the count of its tensor-core entry
FMA = "quant_matvec_fma"  # the count of its CUDA-core entry
# rows above this are compute-shaped work for the library's matmul
MAX_KERNEL_ROWS = 8
# the kernels load 16 codes (16 bytes) at a time
K_ALIGN = 16
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# the tensor-core kernel's tiling (csrc/quant_matvec.cu)
MMA_TILE = 16  # output channels of a CTA (the mma's A rows)
MMA_CHUNK = 64  # codes of K one warp step covers: 4 lanes x 16 bytes
MMA_ROWS = 8  # x rows of one mma (B's columns); rows >= M are zeros
MMA_WARPS = 8  # warps a CTA, each a contiguous slice of K
MMA_STAGES = 4  # chunks a warp has in flight, in its ring in shared memory


def quant_matvec_int8_reference(x: torch.Tensor, w_q: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch, with their precision: the
    sum over K and the per-channel scale in f32, one cast to x's dtype.

    x (..., K); w_q (N, K) int8; scale (N,) f32."""
    acc = torch.matmul(x.float(), w_q.float().t())
    return (acc * scale.float()).to(x.dtype)


def plain_expression(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The model's expression (the JAX package's `LoRADense` line): the
    product and the scale in x's dtype."""
    return F.linear(x, w_q.to(x.dtype)) * scale.to(x.dtype)


def in_kernel_rule(x: torch.Tensor, w_q: torch.Tensor) -> bool:
    """Whether the dispatch rule gives this call to the kernels' function."""
    rows = math.prod(x.shape[:-1])
    return (
        1 <= rows <= MAX_KERNEL_ROWS
        and w_q.shape[1] % K_ALIGN == 0
        and x.dtype in KERNEL_DTYPES
        and not (torch.is_grad_enabled() and x.requires_grad)
    )


class MmaPlan(NamedTuple):
    """How the tensor-core kernel cuts one (M, K) x (N, K) product (the
    kernel computes the same cut itself).

    A CTA owns one tile of 16 output channels, and its 8 warps cut K into
    contiguous slices of `chunks_per_warp` chunks of 64 codes, in warp
    order (the last slices may be shorter or empty; K need only be a
    multiple of 16). The grid is `blocks` CTAs. Their partial sums meet in
    shared memory (`shared_bytes` a CTA, with the warps' rings), so no
    global scratch is allocated."""

    chunks_per_warp: int
    blocks: int

    @property
    def shared_bytes(self) -> int:
        # a ring of MMA_STAGES x 64 bytes (2 code rows, x) a lane a warp,
        # and the partial sums part[8 warps][8 rows][16] f32
        ring = MMA_WARPS * MMA_STAGES * 32 * 64
        return ring + 4 * MMA_WARPS * MMA_ROWS * MMA_TILE

    def k_slices(self, k: int) -> List[Tuple[int, int]]:
        """[k0, k1) of each warp's slice that holds codes, in warp order
        (the order the kernel sums them in)."""
        step = self.chunks_per_warp * MMA_CHUNK
        return [(w * step, min((w + 1) * step, k)) for w in range(MMA_WARPS)
                if w * step < k]

    def tiles(self, n: int) -> List[range]:
        """The output channels below n of each CTA, in grid order."""
        return [range(min(c0, n), min(c0 + MMA_TILE, n))
                for c0 in range(0, self.blocks * MMA_TILE, MMA_TILE)]


def mma_plan(m: int, k: int, n: int) -> MmaPlan:
    """The cut of the tensor-core kernel for x (m, k) and codes (n, k): a
    CTA a tile of 16 channels, K cut over its 8 warps. Cutting K over the
    CTAs of a cluster instead, so that every SM got a CTA at k,v, measured
    slower on an H100: its cluster barriers cost more than the SMs added
    (PERF.md)."""
    if not (1 <= m <= MAX_KERNEL_ROWS and k >= K_ALIGN and k % K_ALIGN == 0
            and n >= 1):
        raise ValueError(f"no plan for M {m}, K {k}, N {n}")
    chunks = -(-k // MMA_CHUNK)
    return MmaPlan(-(-chunks // MMA_WARPS), -(-n // MMA_TILE))


def fragment_k_order() -> List[List[int]]:
    """order[j][s]: the offset in a 64-code chunk of K that slot s (0..15)
    of mma j (0..3) holds, in A (the codes) and in B (x) alike.

    Lane t = lane % 4 holds slots 2t + {0, 1, 8, 9} of each mma; it loads
    the 16 codes at 16 t of its rows, and word j of that load (codes
    16 t + 4 j + {0, 1, 2, 3}) feeds mma j as the bf16 pairs (code 0,
    code 2) at slots (2t, 2t + 1) and (code 1, code 3) at (2t + 8, 2t + 9).
    Each mma sums 16 distinct offsets and the four cover the chunk once,
    so the sum over K is that of the plain product in another order."""
    order = []
    for j in range(4):
        slots = [0] * 16
        for t in range(4):
            base = 16 * t + 4 * j
            slots[2 * t], slots[2 * t + 1] = base, base + 2
            slots[2 * t + 8], slots[2 * t + 9] = base + 1, base + 3
        order.append(slots)
    return order


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry `hsenet_<name>` of csrc/quant_matvec.cu."""
    fn = getattr(_build.load(KERNEL), f"hsenet_{name}")
    ints = 4 if name == FMA else 3
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
           dtypes: tuple) -> Tuple[int, int, int]:
    """(M, K, N) of what the kernels take; raises on anything else."""
    if x.device.type != "cuda":
        raise RuntimeError(
            f"the quant_matvec kernels run on a CUDA device, x is on {x.device}"
        )
    if x.ndim != 2 or not 1 <= x.shape[0] <= MAX_KERNEL_ROWS:
        raise ValueError(f"x must be (M <= {MAX_KERNEL_ROWS}, K), got {tuple(x.shape)}")
    m, k = x.shape
    n = w_q.shape[0]
    if w_q.dtype != torch.int8 or w_q.shape != (n, k) or k % K_ALIGN or k == 0:
        raise ValueError(
            f"w_q must be int8 (N, K = {k}) with K a positive multiple of "
            f"{K_ALIGN}, got {w_q.dtype} {tuple(w_q.shape)}"
        )
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"scale must be f32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"x must be one of {dtypes}, got {x.dtype}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous, 16-byte aligned and on {x.device}"
            )
    return m, k, n


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def quant_matvec_mma_kernel(x: torch.Tensor, w_q: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Launch the tensor-core kernel on CUDA tensors: x (M <= 8, K) bf16,
    w_q (N, K) int8, scale (N,) f32 -> (M, N) bf16, cut as `mma_plan`
    states."""
    m, k, n = _check(x, w_q, scale, (torch.bfloat16,))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _raise_on(_entry("quant_matvec_mma")(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    ), KERNEL)
    launches[KERNEL] += 1
    return y


def quant_matvec_fma_kernel(x: torch.Tensor, w_q: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA-core kernel on CUDA tensors: x (M <= 8, K) bf16 or
    f32, w_q (N, K) int8, scale (N,) f32 -> (M, N) in x's dtype."""
    m, k, n = _check(x, w_q, scale, KERNEL_DTYPES)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _raise_on(_entry("quant_matvec_fma")(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    ), FMA)
    fma_launches[FMA] += 1
    return y


def quant_matvec_kernel(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of x's dtype on CUDA tensors: x (M <= 8, K) bf16
    (the tensor-core kernel) or f32 (the CUDA-core kernel), w_q (N, K)
    int8, scale (N,) f32 -> (M, N) in x's dtype. Raises on what the
    kernels do not take."""
    if x.dtype == torch.float32:
        return quant_matvec_fma_kernel(x, w_q, scale)
    return quant_matvec_mma_kernel(x, w_q, scale)


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


# launches since the last reset, by entry; chip_smoke.py reads them to show
# that the decode steps of the serving engine went through the tensor-core
# kernel (`launches`) and the f32 calls through the CUDA-core one
launches = {KERNEL: 0}
fma_launches = {FMA: 0}


def reset_launch_counts() -> None:
    launches[KERNEL] = 0
    fma_launches[FMA] = 0
