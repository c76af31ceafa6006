"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

`flash_attention` computes what the JAX package's `_flash_kernel` computes:
softmax(sm_scale * Q K^T) V per (batch, head), keeping the columns below
`kv_lens[b]` and, under `causal`, those at or left of `row + q_offset[b]`,
with the softmax in f32 and a row that has no valid column giving 0. On a
CUDA tensor it launches `csrc/flash_fwd.cu` (bf16, head_dim 64 or 128);
on a CPU tensor it runs `flash_attention_reference`. It never falls from
one to the other.

The kernel reads Q, K and V through their (batch, head, row) strides, so
the head-split views that `rearrange(..., "b s (n d) -> b n s d")` gives
are taken without a copy; rows must be contiguous and 16-byte aligned.
Its output is laid out as (B, S, H, D) and returned as the (B, H, S, D)
view, so merging the heads back is a view too.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from hsenet_torch.ops import _build

_LIB_NAME = "flash_fwd"
SUPPORTED_HEAD_DIMS = (64, 128)


def _per_row(x, batch: int, device) -> torch.Tensor:
    """An int or a (B,) tensor -> (B,) int32 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(batch)
    return torch.full((batch,), int(x), dtype=torch.int32, device=device)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset=0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in f32.

    Same masking as the kernel; a row with no valid column gives 0 (where
    `ops.attention.sdpa_reference` gives the mean of V)."""
    batch, _, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kv = (
        torch.full((batch,), skv, dtype=torch.int32, device=q.device)
        if kv_lens is None
        else _per_row(kv_lens, batch, q.device)
    )
    q_off = _per_row(q_offset, batch, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    col = torch.arange(skv, device=q.device)
    mask = col[None, None, None, :] < kv[:, None, None, None]
    if causal:
        row = torch.arange(sq, device=q.device)[None, None, :, None]
        mask = mask & (col[None, None, None, :] <= row + q_off[:, None, None, None])
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # exactly 0 on masked columns
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.where(
        denom > 0, denom, torch.ones_like(denom)
    )
    return out.to(q.dtype)


def _check_cuda_operands(q, k, v):
    batch, heads, sq, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bfloat16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: rows must start on 16-byte boundaries "
                f"(strides {t.stride()})"
            )
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    if k.shape[:2] != (batch, heads) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}:"
            " expand GQA heads before the call"
        )


def _library():
    lib = _build.load(_LIB_NAME)
    fn = lib.hsenet_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset=0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over (B, H, S, D) tensors.

    Args:
      q: (B, H, Sq, D) queries.
      k, v: (B, H, Skv, D); GQA heads are expanded by the caller
        (`ops.attention.multi_head_attention`).
      kv_lens: optional (B,) valid KV lengths; defaults to Skv.
      causal: lower-triangular mask offset by `q_offset`.
      q_offset: int or (B,) per-row causal query offset.
      sm_scale: softmax scale, default 1/sqrt(D).
    """
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, kv_lens=kv_lens, causal=causal, q_offset=q_offset,
            sm_scale=sm_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, k, v)
    batch, heads, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kv = (
        torch.full((batch,), skv, dtype=torch.int32, device=q.device)
        if kv_lens is None
        else _per_row(kv_lens, batch, q.device).contiguous()
    )
    q_off = _per_row(q_offset, batch, q.device).contiguous()
    out = torch.empty(
        (batch, sq, heads, d), dtype=q.dtype, device=q.device
    ).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    err = _library()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv.data_ptr(), q_off.data_ptr(),
        batch, heads, sq, skv, d, *strides,
        int(causal), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_head_dim[d] += 1
    return out


# kernel launches since the last reset, in all and by head dim (64 in the
# ViT towers, 128 in LLM prefill); chip_smoke.py reads them to show that
# the main path went through the kernel, and at which shapes
def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_by_head_dim = dict.fromkeys(SUPPORTED_HEAD_DIMS, 0)


reset_launch_counts()
