"""Attention entry points: the plain sdpa and the flash-kernel dispatch.

`multi_head_attention` is the one attention call of every port model (ViT
towers, Phi LLM). It expands GQA heads, then runs the flash kernel
(`ops.flash_attention`) or the plain `sdpa_reference`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hsenet_torch.ops.flash_attention import flash_attention

# Flash dispatch policy:
#   "auto"  — the flash kernel whenever the query has more than one row;
#   "never" — sdpa_reference only (numerics A/B checks).
# The JAX package's "always" is this "auto": its device-count condition
# exists for XLA's SPMD partitioner and has no counterpart here.
_FLASH_MODE = "auto"


def set_flash_mode(mode: str) -> None:
    """Set the flash dispatch policy: "auto" | "never"."""
    if mode not in ("auto", "never"):
        raise ValueError(f"flash mode must be 'auto' or 'never', got {mode!r}")
    global _FLASH_MODE
    _FLASH_MODE = mode


def sdpa_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset=0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain scaled-dot-product attention over (B, H, S, D); softmax in f32.

    Masked scores are set to -1e30 as in the JAX package, so a row with
    no valid column gives the mean of V. `q_offset` is an int or a (B,)
    tensor of per-row causal offsets."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    sq, skv = q.shape[2], k.shape[2]
    col = torch.arange(skv, device=q.device)[None, None, None, :]
    if kv_lens is not None:
        s = s.masked_fill(col >= kv_lens.to(q.device)[:, None, None, None], -1e30)
    if causal:
        row = torch.arange(sq, device=q.device)[None, None, :, None]
        q_off = torch.as_tensor(q_offset, dtype=torch.int32, device=q.device)
        q_off = q_off.expand(q.shape[0])[:, None, None, None]
        s = s.masked_fill(col > row + q_off, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset=0,
    sm_scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Attention over (B, H|Hkv, S, D) with GQA expansion and flash dispatch.

    `use_flash=None` follows the policy set by `set_flash_mode`."""
    heads, kv_heads = q.shape[1], k.shape[1]
    if kv_heads != heads:
        if heads % kv_heads:
            raise ValueError(f"{heads} query heads over {kv_heads} kv heads")
        rep = heads // kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if use_flash is None:
        use_flash = _FLASH_MODE == "auto" and q.shape[2] > 1
    attend = flash_attention if use_flash else sdpa_reference
    return attend(
        q, k, v, kv_lens=kv_lens, causal=causal, q_offset=q_offset,
        sm_scale=sm_scale,
    )
