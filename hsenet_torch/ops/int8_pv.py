"""The P.V probe product: the hand-written Hopper kernel, its plain
PyTorch version and the dispatcher (the port of the JAX package's probe
kernel `make_kernel(mode)` in scripts/_probe_pallas_int8.py).

The probe asks what attention's P.V product costs in the W8A8 serving
encode mode if P and V go to int8. Per grid cell g it computes
P[g] (M, K) @ V[g] (K, N) with f32 output (G, M, N), in one of four modes:

  * `bf16`: P and V bf16, bf16 products summed in f32;
  * `int8_pre`: P and V int8 codes, exact integer sums, one conversion to
    f32;
  * `quant_then_int8`: P f32 (softmax probabilities in [0, 1]), V int8; P
    becomes the int8 code round_half_even(p * 127) (saturated at the int8
    range) as it is loaded, then as `int8_pre`;
  * `glue_only`: P f32; each row's sum of its quantised codes, broadcast
    to N columns (the quantisation's cost alone; V is not read).

`int8_pv(p, v, mode)` runs `csrc/int8_pv_wgmma.cu` (`int8_pv_wgmma_kernel`:
TMA tiles of P into a ring of stages, wgmma products, 192-row CTAs, 128
where P is f32; K a multiple of 64, N = 64, any M) on CUDA tensors and
`int8_pv_reference` on CPU tensors; the call never falls from one to the
other. `csrc/int8_pv.cu` (`int8_pv_kernel`: mma.sync from registers, the
first port's kernel) computes the same function and stays as the yardstick
that chip_smoke.py times the other against, in every mode on the same
card; no path launches it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hsenet_torch.ops import _build

KERNEL = "int8_pv_wgmma"  # the probe's kernel
YARDSTICK = "int8_pv"  # the mma.sync kernel it is timed against
MODES = ("bf16", "int8_pre", "quant_then_int8", "glue_only")
# dtypes of (P, V) in each mode, as the JAX probe feeds them
DTYPES = {
    "bf16": (torch.bfloat16, torch.bfloat16),
    "int8_pre": (torch.int8, torch.int8),
    "quant_then_int8": (torch.float32, torch.int8),
    "glue_only": (torch.float32, torch.int8),
}
K_TILE = 64  # the product modes walk K in tiles of 64
HEAD_DIM = 64  # the product modes' N
GLUE_K_ALIGN = 4  # int8_pv's glue_only reads P as 16-byte vectors of 4 f32


def row_tile(mode: str) -> int:
    """Rows of M per CTA of int8_pv_wgmma: three consumer warpgroups of 64
    rows where P has 2-byte or 1-byte elements, two where it is f32."""
    _check_mode(mode)
    return 128 if DTYPES[mode][0] == torch.float32 else 192


def quantize_p(p: torch.Tensor) -> torch.Tensor:
    """P -> int8 codes round_half_even(p * 127) in f32, saturated at the
    int8 range (the JAX probe's `jnp.round(p * 127).astype(int8)` on its
    [0, 1) inputs)."""
    return torch.round(p.float() * 127.0).clamp(-128, 127).to(torch.int8)


def int8_pv_reference(p: torch.Tensor, v: Optional[torch.Tensor],
                      mode: str) -> torch.Tensor:
    """The kernel's function in plain PyTorch. `bf16`: an f32 product of
    the bf16 values. Integer modes: exact integer sums (taken in f64,
    where every sum of at most 2^24 products of codes is exact, on any
    device), converted once to f32."""
    _check_mode(mode)
    if mode == "bf16":
        return torch.matmul(p.float(), v.float())
    codes = p if mode == "int8_pre" else quantize_p(p)
    if mode == "glue_only":
        g, m, _ = p.shape
        sums = codes.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        return sums.float()[..., None].expand(g, m, HEAD_DIM).contiguous()
    return torch.matmul(codes.double(), v.double()).to(torch.int32).float()


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _entry(name: str):
    """The C entry of kernel `name`: (p, v, out, mode, g, m, k, n, stream)."""
    fn = getattr(_build.load(name), f"hsenet_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_operands(p: torch.Tensor, v: Optional[torch.Tensor], mode: str,
                   k_align: int = K_TILE) -> Tuple[int, int, int]:
    """(G, M, K) of what the kernels take: p (G, M, K) and v (G, K, 64) in
    the mode's dtypes (v unused in `glue_only`), K a multiple of `k_align`,
    any M, both contiguous, 16-byte aligned and on one CUDA device. Raises
    on anything else (ValueError for dtypes and shapes, checked first;
    RuntimeError off the card)."""
    _check_mode(mode)
    p_dtype, v_dtype = DTYPES[mode]
    if p.dtype != p_dtype or p.ndim != 3:
        raise ValueError(f"{mode}: p must be (G, M, K) {p_dtype}, got "
                         f"{p.dtype} {tuple(p.shape)}")
    g, m, k = p.shape
    if k % k_align or k == 0:
        raise ValueError(f"{mode} takes K a positive multiple of {k_align}, got {k}")
    operands = [("p", p)]
    if mode != "glue_only":
        if v is None or v.dtype != v_dtype or v.shape != (g, k, HEAD_DIM):
            raise ValueError(
                f"{mode}: v must be ({g}, {k}, {HEAD_DIM}) {v_dtype}, got "
                f"{None if v is None else (v.dtype, tuple(v.shape))}")
        operands.append(("v", v))
    if p.device.type != "cuda":
        raise RuntimeError(
            f"the int8_pv kernels run on a CUDA device, p is on {p.device}")
    for name, t in operands:
        if t.device != p.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous, 16-byte aligned and on {p.device}")
    return g, m, k


def _launch(name: str, p, v, mode) -> torch.Tensor:
    g, m, k = p.shape
    out = torch.empty((g, m, HEAD_DIM), dtype=torch.float32, device=p.device)
    err = _entry(name)(
        p.data_ptr(), 0 if mode == "glue_only" else v.data_ptr(),
        out.data_ptr(), MODES.index(mode), g, m, k, HEAD_DIM,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name][mode] += 1
    return out


def int8_pv_wgmma_kernel(p: torch.Tensor, v: Optional[torch.Tensor],
                         mode: str) -> torch.Tensor:
    """Launch int8_pv_wgmma on CUDA tensors: p (G, M, K), v (G, K, 64) in
    the mode's dtypes -> (G, M, 64) f32. In the integer modes each CTA
    transposes V's tiles itself."""
    check_operands(p, v, mode)
    return _launch(KERNEL, p, v, mode)


def int8_pv_kernel(p: torch.Tensor, v: Optional[torch.Tensor],
                   mode: str) -> torch.Tensor:
    """Launch the mma.sync kernel int8_pv (the yardstick) on CUDA tensors:
    same operands and result as `int8_pv_wgmma_kernel`, K a multiple of 4
    in `glue_only`."""
    check_operands(p, v, mode, GLUE_K_ALIGN if mode == "glue_only" else K_TILE)
    return _launch(YARDSTICK, p, v, mode)


def int8_pv(p: torch.Tensor, v: Optional[torch.Tensor],
            mode: str) -> torch.Tensor:
    """P[g] @ V[g] -> (G, M, 64) f32 in `mode`: int8_pv_wgmma for CUDA
    tensors, the plain version for CPU tensors."""
    if p.device.type == "cpu":
        return int8_pv_reference(p, v, mode)
    return int8_pv_wgmma_kernel(p, v, mode)


# launches by kernel and mode since the last reset; chip_smoke.py reads
# them to show that the probe's run went through int8_pv_wgmma in every
# mode
launches = {name: {mode: 0 for mode in MODES} for name in (KERNEL, YARDSTICK)}


def reset_launch_counts() -> None:
    for counts in launches.values():
        for mode in MODES:
            counts[mode] = 0
