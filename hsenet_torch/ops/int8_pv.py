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

`int8_pv(p, v, mode)` runs `csrc/int8_pv.cu` for CUDA tensors and
`int8_pv_reference` for CPU tensors; the call never falls from one to the
other. The kernel takes K a multiple of 64 and N = 64 (the probe's head
dim) in the product modes, K a multiple of 4 in `glue_only`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hsenet_torch.ops import _build

KERNEL = "int8_pv"
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
GLUE_K_ALIGN = 4  # glue_only reads P as 16-byte vectors of 4 f32


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


def _kernel():
    fn = _build.load(KERNEL).hsenet_int8_pv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def int8_pv_kernel(p: torch.Tensor, v: Optional[torch.Tensor],
                   mode: str) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: p (G, M, K), v (G, K, 64) in the
    mode's dtypes (v unused in `glue_only`) -> (G, M, 64) f32. Raises on
    what the kernel does not take."""
    _check_mode(mode)
    if p.device.type != "cuda":
        raise RuntimeError(
            f"the int8_pv kernel runs on a CUDA device, p is on {p.device}")
    p_dtype, v_dtype = DTYPES[mode]
    if p.dtype != p_dtype or p.ndim != 3:
        raise ValueError(f"{mode}: p must be (G, M, K) {p_dtype}, got "
                         f"{p.dtype} {tuple(p.shape)}")
    g, m, k = p.shape
    operands = [("p", p)]
    if mode == "glue_only":
        if k % GLUE_K_ALIGN:
            raise ValueError(f"glue_only takes K a multiple of {GLUE_K_ALIGN}, got {k}")
    else:
        if k % K_TILE:
            raise ValueError(f"{mode} takes K a multiple of {K_TILE}, got {k}")
        if v is None or v.dtype != v_dtype or v.shape != (g, k, HEAD_DIM):
            raise ValueError(
                f"{mode}: v must be ({g}, {k}, {HEAD_DIM}) {v_dtype}, got "
                f"{None if v is None else (v.dtype, tuple(v.shape))}")
        operands.append(("v", v))
    for name, t in operands:
        if t.device != p.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous, 16-byte aligned and on {p.device}")
    out = torch.empty((g, m, HEAD_DIM), dtype=torch.float32, device=p.device)
    err = _kernel()(
        p.data_ptr(), 0 if mode == "glue_only" else v.data_ptr(),
        out.data_ptr(), MODES.index(mode), g, m, k, HEAD_DIM,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_pv kernel launch failed: CUDA error {err}")
    launches[mode] += 1
    return out


def int8_pv(p: torch.Tensor, v: Optional[torch.Tensor],
            mode: str) -> torch.Tensor:
    """P[g] @ V[g] -> (G, M, 64) f32 in `mode`: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if p.device.type == "cpu":
        return int8_pv_reference(p, v, mode)
    return int8_pv_kernel(p, v, mode)


# kernel launches by mode since the last reset; chip_smoke.py reads them to
# show that the probe's run went through the kernel in every mode
launches = {mode: 0 for mode in MODES}


def reset_launch_counts() -> None:
    for mode in MODES:
        launches[mode] = 0
