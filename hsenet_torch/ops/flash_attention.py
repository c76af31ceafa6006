"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain PyTorch versions.

`flash_attention` computes what the JAX package's `_flash_kernel` computes:
softmax(sm_scale * Q K^T) V per (batch, head), keeping the columns below
`kv_lens[b]` and, under `causal`, those at or left of `row + q_offset[b]`,
with the softmax in f32 and a row that has no valid column giving 0. On a
CUDA tensor it launches `csrc/flash_fwd.cu` (bf16, head_dim 64 or 128);
on a CPU tensor it runs `flash_attention_reference`. It never falls from
one to the other.

When autograd needs its gradient (grad mode on and an input that requires
grad), the call goes through `_FlashAttention`, the counterpart of the JAX
package's `_flash_attention_core` and its custom VJP: the forward also
writes each row's log-sum-exp, and the backward launches the two kernels
of `_bwd_dq_kernel` and `_bwd_dkv_kernel` (`csrc/flash_bwd_dq.cu`,
`csrc/flash_bwd_dkv.cu`), or on the CPU runs their plain version
`flash_attention_backward_reference`. Autograd through
`flash_attention_reference` itself is the JAX package's recompute route
(`use_pallas_bwd=False`); nothing on the port's paths takes it.

The same three kernels serve the JAX package's streaming kernels too
(B2 `_flash_kernel_stream`, B4 `_bwd_dq_kernel_stream` and
`_bwd_dkv_kernel_stream`), which it takes when a (batch, head)'s K/V or
Q/dO would not fit its VMEM budget (above 2304 tokens at head_dim 64): each
CUDA kernel streams the other side through shared memory in 64-row tiles at
any length, and ends its loop at kv_len and at the diagonal.

The kernels read Q, K, V and dO through their (batch, head, row) strides,
so the head-split views that `rearrange(..., "b s (n d) -> b n s d")` gives
are taken without a copy; rows must be contiguous and 16-byte aligned.
Outputs are laid out as (B, S, H, D) and returned as (B, H, S, D) views, so
merging the heads back is a view too.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

from hsenet_torch.ops import _build

SUPPORTED_HEAD_DIMS = (64, 128)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the log-sum-exp of a row with no valid column (the JAX package's -NEG_INF)
EMPTY_ROW_LSE = 1e30


def _per_row(x, batch: int, device) -> torch.Tensor:
    """An int or a (B,) tensor -> (B,) int32 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(batch)
    return torch.full((batch,), int(x), dtype=torch.int32, device=device)


def _row_args(q, k, kv_lens, q_offset, sm_scale):
    """(kv_lens, q_offset) as contiguous (B,) int32 and the softmax scale."""
    batch, d = q.shape[0], q.shape[-1]
    kv = (
        torch.full((batch,), k.shape[2], dtype=torch.int32, device=q.device)
        if kv_lens is None
        else _per_row(kv_lens, batch, q.device).contiguous()
    )
    q_off = _per_row(q_offset, batch, q.device).contiguous()
    return kv, q_off, 1.0 / math.sqrt(d) if sm_scale is None else sm_scale


def _valid(q, k, kv, q_off, causal) -> torch.Tensor:
    """(B, 1, Sq, Skv) mask of the (row, column) pairs the kernels keep."""
    col = torch.arange(k.shape[2], device=q.device)
    mask = col[None, None, None, :] < kv[:, None, None, None]
    if causal:
        row = torch.arange(q.shape[2], device=q.device)[None, None, :, None]
        mask = mask & (col[None, None, None, :] <= row + q_off[:, None, None, None])
    return mask


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset=0,
    sm_scale: Optional[float] = None,
    with_lse: bool = False,
):
    """The forward kernel's function in plain PyTorch, computed in f32.

    Same masking as the kernel; a row with no valid column gives 0 (where
    `ops.attention.sdpa_reference` gives the mean of V). With `with_lse`
    it returns (out, lse), lse the (B, H, Sq) f32 log-sum-exp of the
    scaled scores, 1e30 for a row with no valid column."""
    kv, q_off, sm_scale = _row_args(q, k, kv_lens, q_offset, sm_scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~_valid(q, k, kv, q_off, causal), -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # exactly 0 on masked columns
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.where(
        denom > 0, denom, torch.ones_like(denom)
    )
    out = out.to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(denom > 0, m + torch.log(denom), EMPTY_ROW_LSE)
    return out, lse[..., 0]


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    q_offset=0,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, computed in f32:
    P = exp(sm_scale Q K^T - lse) on the valid pairs (0 elsewhere),
    delta = rowsum(dO * O), dS = P (dO V^T - delta) sm_scale, and
    dQ = dS K, dK = dS^T Q, dV = P^T dO, returned in the inputs' dtypes."""
    kv, q_off, sm_scale = _row_args(q, k, kv_lens, q_offset, sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    p = torch.where(
        _valid(q, k, kv, q_off, causal),
        torch.exp(s - lse.float()[..., None]),
        0.0,
    )
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"flash kernels take bfloat16, {name} is {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(
            f"{name}: rows must start on 16-byte boundaries (strides {t.stride()})"
        )


def _check_cuda_operands(q, k, v):
    batch, heads, _, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t, q.device)
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim 64 or 128, got {d}")
    if k.shape[:2] != (batch, heads) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}:"
            " expand GQA heads before the call"
        )


_ARGTYPES = {  # pointers, then ints (batch, heads, sq, skv, d), strides
    "flash_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12,
    "flash_bwd_dq": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15,
    "flash_bwd_dkv": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 18,
}


def _kernel(name: str):
    fn = getattr(_build.load(name), f"hsenet_{name}_bf16")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, pointers, dims, strided, causal, sm_scale, device,
            kind: Optional[str] = None) -> None:
    """Launch kernel `name` on the current stream and count the launch, by
    kernel and by (`kind`, batch, heads, sq, skv, head_dim)."""
    strides = [s for t in strided for s in t.stride()[:3]]
    err = _kernel(name)(
        *pointers, *dims, *strides, int(causal), float(sm_scale),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    shape_launches[(kind or name, *dims)] += 1


def _bshd(batch, seq, heads, d, like) -> torch.Tensor:
    """An empty (B, H, S, D) view of a (B, S, H, D) buffer."""
    return torch.empty(
        (batch, seq, heads, d), dtype=like.dtype, device=like.device
    ).permute(0, 2, 1, 3)


def _forward_kernel(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """Launch flash_fwd: (out, lse or None)."""
    _check_cuda_operands(q, k, v)
    batch, heads, sq, d = q.shape
    out = _bshd(batch, sq, heads, d, q)
    lse = (torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        _launch(
            "flash_fwd",
            [t.data_ptr() for t in (q, k, v, out)]
            + [None if lse is None else lse.data_ptr(), kv.data_ptr(),
               q_off.data_ptr()],
            (batch, heads, sq, k.shape[2], d), (q, k, v, out), causal,
            sm_scale, q.device, "flash_fwd_lse" if with_lse else "flash_fwd",
        )
        fwd_launches[(d, with_lse)] += 1
    return out, lse


def _check_do(q, do):
    try:
        _check_kernel_operand("do", do, q.device)
    except ValueError:
        do = do.contiguous()
        _check_kernel_operand("do", do, q.device)
    return do


def _bwd_dq_kernel(q, k, v, do, lse, delta, kv, q_off, causal, sm_scale):
    """Launch flash_bwd_dq: dq. `lse` and `delta` are contiguous (B, H, Sq)
    f32."""
    batch, heads, sq, d = q.shape
    dq = _bshd(batch, sq, heads, d, q)
    if dq.numel():
        _launch(
            "flash_bwd_dq",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq, kv, q_off)],
            (batch, heads, sq, k.shape[2], d), (q, k, v, do, dq), causal,
            sm_scale, q.device,
        )
    return dq


def _bwd_dkv_kernel(q, k, v, do, lse, delta, kv, q_off, causal, sm_scale):
    """Launch flash_bwd_dkv: (dk, dv)."""
    batch, heads, sq, d = q.shape
    skv = k.shape[2]
    dk = _bshd(batch, skv, heads, d, k)
    dv = _bshd(batch, skv, heads, d, v)
    if dk.numel():
        _launch(
            "flash_bwd_dkv",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv, kv, q_off)],
            (batch, heads, sq, skv, d), (q, k, v, do, dk, dv), causal,
            sm_scale, q.device,
        )
    return dk, dv


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    q_offset=0,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` at output `o` with log-sum-exp
    `lse` (from the forward) and output gradient `do`. On CUDA tensors it
    computes delta = rowsum(dO * O) in f32, as the JAX package does outside
    its kernels, and launches flash_bwd_dq and flash_bwd_dkv; on CPU
    tensors it runs `flash_attention_backward_reference`."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, kv_lens, q_offset, causal, sm_scale
        )
    kv, q_off, sm_scale = _row_args(q, k, kv_lens, q_offset, sm_scale)
    _check_cuda_operands(q, k, v)
    do = _check_do(q, do)
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    lse = lse.contiguous()
    args = (q, k, v, do, lse, delta, kv, q_off, causal, sm_scale)
    return (_bwd_dq_kernel(*args), *_bwd_dkv_kernel(*args))


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's
    `_flash_attention_core` with its custom VJP). The forward saves q, k, v,
    the output, the log-sum-exp, kv_lens and q_offset; the backward runs the
    dQ and dK/dV kernels on the card and their plain version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, kv, q_off, causal, sm_scale):
        if q.device.type == "cuda":
            out, lse = _forward_kernel(q, k, v, kv, q_off, causal, sm_scale, True)
        else:
            out, lse = flash_attention_reference(
                q, k, v, kv_lens=kv, causal=causal, q_offset=q_off,
                sm_scale=sm_scale, with_lse=True,
            )
        ctx.save_for_backward(q, k, v, out, lse, kv, q_off)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv, q_off = ctx.saved_tensors
        grads = flash_attention_backward(
            q, k, v, out, lse, do, kv, q_off, ctx.causal, ctx.sm_scale
        )
        return (*grads, None, None, None, None)


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
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    kv, q_off, sm_scale = _row_args(q, k, kv_lens, q_offset, sm_scale)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FlashAttention.apply(q, k, v, kv, q_off, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, kv_lens=kv, causal=causal, q_offset=q_off,
            sm_scale=sm_scale,
        )
    return _forward_kernel(q, k, v, kv, q_off, causal, sm_scale, False)[0]


# kernel launches since the last reset: by kernel; the forward's by (head
# dim, whether it wrote the log-sum-exp); and every launch by (kind, batch,
# heads, sq, skv, head_dim), kind "flash_fwd", "flash_fwd_lse" (the forward
# that autograd records), "flash_bwd_dq" or "flash_bwd_dkv". chip_smoke.py
# reads them to show that the main path went through the kernels, and at
# which shapes (the towers, BERT, the LLM, the fine-patch tower).
launches = dict.fromkeys(KERNELS, 0)
fwd_launches = {(d, lse): 0 for d in SUPPORTED_HEAD_DIMS for lse in (False, True)}
shape_launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    for counts in (launches, fwd_launches):
        for key in counts:
            counts[key] = 0
    shape_launches.clear()
