"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain PyTorch versions.

`flash_attention` computes what the JAX package's `_flash_kernel` computes:
softmax(sm_scale * Q K^T) V per (batch, head), keeping the columns below
`kv_lens[b]` and, under `causal`, those at or left of `row + q_offset[b]`,
with the softmax in f32 and a row that has no valid column giving 0. On a
CUDA tensor it launches `csrc/flash_fwd_wgmma.cu` (bf16 and f16: wgmma,
TMA and a producer warpgroup, 64- or 128-row query tiles chosen by
`forward_query_tile`) or `csrc/flash_fwd.cu` (f32: TF32 mma.sync); on a
CPU tensor it runs `flash_attention_reference`. It never falls from one to
the other.

The kernels take bf16, f16 or f32 operands (one dtype for q, k, v; f32
runs TF32 products, see `csrc/flash_common.cuh`) at any head_dim. Their
native widths are 64, 128 and, in bf16 and f16, 256; above those (bf16
and f16 above 256, f32 above 128) the wide route runs: the `_wide` entries
of `csrc/flash_fwd.cu`, `flash_bwd_dq.cu` and `flash_bwd_dkv.cu`, at any
multiple of 64, one CTA per 64 output columns with S (and dP) summed over
64-column chunks. `with_head_dim_padded` gives q, k, v (and o, dO) zero
columns up to `kernel_head_dim` (the next native width, or above them the
next multiple of 64) and slices the outputs back, with the softmax scale
of the true width; the CPU route pads the same way, so the CPU tests hold
the padded route to the JAX kernels (which pad any width to a multiple of
128: zero columns change nothing, so the two agree). float64 and mixed
dtypes raise: the JAX package runs with x64 off and has no float64 arrays.

When autograd needs its gradient (grad mode on and an input that requires
grad), the call goes through `_FlashAttention`, the counterpart of the JAX
package's `_flash_attention_core` and its custom VJP: the forward also
writes each row's log-sum-exp, and the backward launches `csrc/flash_bwd.cu`
in bf16 and f16 up to head_dim 128 (one wgmma/TMA kernel for dQ, dK and
dV, the port of `_bwd_dq_kernel` and `_bwd_dkv_kernel`; dQ is summed across
key tiles by f32 reduce-adds, so it is not bit-reproducible run to run) or
the two mma.sync kernels `csrc/flash_bwd_dq.cu` and `csrc/flash_bwd_dkv.cu`
(in f32, in bf16 and f16 at head_dim 256, and their `_wide` entries above
the native widths), or on the CPU runs their plain version
`flash_attention_backward_reference`.
Autograd through `flash_attention_reference` itself is the JAX package's
recompute route (`use_pallas_bwd=False`); nothing on the port's paths takes
it.

The same kernels serve the JAX package's streaming kernels too (B2
`_flash_kernel_stream`, B4 `_bwd_dq_kernel_stream` and
`_bwd_dkv_kernel_stream`), which it takes when a (batch, head)'s K/V or
Q/dO would not fit its VMEM budget (above 2304 tokens at head_dim 64): each
CUDA kernel streams the other side through shared memory at any length,
and ends its loop at kv_len and at the diagonal.

The kernels read Q, K, V and dO through their (batch, head, row) strides,
so the head-split views that `rearrange(..., "b s (n d) -> b n s d")` gives
are taken without a copy; rows must be contiguous and 16-byte aligned.
Outputs are laid out as (B, S, H, D) and returned as (B, H, S, D) views, so
merging the heads back is a view too.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from hsenet_torch.ops import _build

SUPPORTED_HEAD_DIMS = (64, 128, 256)  # the native widths of bf16 and f16
F32_HEAD_DIMS = (64, 128)  # the native widths of f32; above them, wide
WIDE_STEP = 64  # the wide route's widths: multiples of 64
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# flash_fwd_wgmma is the bf16 and f16 forward, flash_fwd the f32 one (and
# chip_smoke.py's bf16 yardstick); flash_bwd is the bf16 and f16 backward up
# to head_dim 128, flash_bwd_dq and flash_bwd_dkv the f32 one and the bf16
# and f16 one at 256. These are the sources; the wide route's kernels
# (`WIDE`) are entries of the libraries of flash_fwd, flash_bwd_dq and
# flash_bwd_dkv.
KERNELS = ("flash_fwd", "flash_fwd_wgmma", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv")
WIDE = {"flash_fwd_wide": "flash_fwd", "flash_bwd_dq_wide": "flash_bwd_dq",
        "flash_bwd_dkv_wide": "flash_bwd_dkv"}
# H100 SXM's streaming multiprocessors, when no card is there to ask
DEFAULT_SMS = 132
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


def native_head_dims(dtype: torch.dtype) -> Tuple[int, ...]:
    """The widths the kernels of `dtype` run natively: 64, 128 and 256 in
    bf16 and f16, 64 and 128 in f32."""
    return F32_HEAD_DIMS if dtype == torch.float32 else SUPPORTED_HEAD_DIMS


def kernel_head_dim(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The kernel width a head dim `d` of `dtype` is padded to: the next
    native width (64, 128, and 256 in bf16 and f16), and above the native
    ones the next multiple of 64, the wide route's width (the JAX kernels
    pad to a multiple of 128; zero columns change nothing, so both give the
    same result)."""
    if d < 1:
        raise ValueError(f"flash kernels take head_dim >= 1, got {d}")
    native = native_head_dims(dtype)
    if d > native[-1]:
        return -(-d // WIDE_STEP) * WIDE_STEP
    return next(w for w in native if d <= w)


def is_wide(width: int, dtype: torch.dtype) -> bool:
    """Whether a kernel width of `dtype` runs the wide route."""
    return width > native_head_dims(dtype)[-1]


def forward_query_tile(batch: int, heads: int, sq: int, head_dim: int,
                       sms: int = DEFAULT_SMS) -> int:
    """Query rows per CTA of `flash_fwd_wgmma` at kernel width `head_dim`.

    At 64 and 128 always 64: a 64-row CTA (one consumer warpgroup) leaves
    room for a second on its SM, and two CTAs interleave one's softmax with
    the other's products, where one 128-row CTA's two warpgroups wait on the
    same tiles and run their softmax together (chip_smoke.py times both
    tiles at every forward shape; PERF.md has the numbers). At 256 a CTA
    takes the SM's shared memory either way: 128 rows (two warpgroups
    sharing each K/V tile) when that grid gives every one of the card's
    `sms` SMs a CTA, else 64, so that a small grid spreads over the card."""
    if head_dim <= 128:
        return 64
    return 128 if batch * heads * -(-sq // 128) >= sms else 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def with_head_dim_padded(fn, *args, sm_scale: float, **kw):
    """`fn(*args, sm_scale=sm_scale, **kw)` at the kernel width: every 4-D
    tensor among `args` (q, k, v, and o and dO in the backward; their last
    axis is the head dim d) gets zero columns up to `kernel_head_dim(d)`,
    and every 4-D tensor `fn` returns (the output; dQ, dK, dV) is sliced
    back to d. A zero column adds nothing to a score, so the softmax, the
    log-sum-exp and delta are those of the true width; `sm_scale` must be
    the true width's (1/sqrt(d), not 1/sqrt of the padded width), so the
    caller passes it. At a kernel width nothing is copied."""
    d = args[0].shape[-1]
    width = kernel_head_dim(d, args[0].dtype)
    if width == d:
        return fn(*args, sm_scale=sm_scale, **kw)
    pad = [
        torch.nn.functional.pad(a, (0, width - d))
        if isinstance(a, torch.Tensor) and a.dim() == 4 else a
        for a in args
    ]
    out = fn(*pad, sm_scale=sm_scale, **kw)

    def cut(t):
        return t[..., :d] if isinstance(t, torch.Tensor) and t.dim() == 4 else t

    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


def check_operands(q, k, v) -> None:
    """What the CUDA route takes, checked before the head dim is padded: q,
    k and v on one device, of one dtype, bfloat16, float16 or float32
    (float64, which the JAX package does not have with x64 off, other and
    mixed dtypes raise), any head_dim of at least 1, GQA heads expanded."""
    batch, heads, _, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(
                f"flash kernels take bfloat16, float16 or float32, {name} is "
                f"{t.dtype}"
            )
        if t.dtype != q.dtype:
            raise ValueError(
                f"{name} is {t.dtype}, q is {q.dtype}: one dtype for all"
            )
    kernel_head_dim(d, q.dtype)
    if k.shape[:2] != (batch, heads) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}:"
            " expand GQA heads before the call"
        )


def _check_layout(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    """An operand as a kernel reads it: q's device and dtype, rows
    contiguous and starting on 16-byte boundaries."""
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, q {q.dtype} on {q.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
        raise ValueError(
            f"{name}: rows must start on 16-byte boundaries (strides {t.stride()})"
        )


def _check_cuda_operands(q, k, v):
    """The kernels' operands after padding: `check_operands`, a kernel
    width (a native one, or above them a multiple of 64), and the row
    layout."""
    check_operands(q, k, v)
    d = q.shape[-1]
    if d != kernel_head_dim(d, q.dtype):
        raise ValueError(
            f"the {q.dtype} kernels run at head_dim "
            f"{native_head_dims(q.dtype)} or above them a multiple of "
            f"{WIDE_STEP}, got {d}: pad through with_head_dim_padded"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t, q)


_ARGTYPES = {  # pointers, then ints (batch, heads, sq, skv, d, ...), strides
    "flash_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12,
    # and the query tile
    "flash_fwd_wgmma": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12,
    "flash_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 21,
    "flash_bwd_dq": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15,
    "flash_bwd_dkv": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 18,
}
_ARGTYPES.update({wide: _ARGTYPES[lib] for wide, lib in WIDE.items()})
_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}


def _kernel(name: str, dtype: torch.dtype):
    lib = _build.load(WIDE.get(name, name))
    fn = getattr(lib, f"hsenet_{name}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, pointers, dims, strided, causal, sm_scale, q,
            kind: Optional[str] = None, extra=()) -> None:
    """Launch kernel `name` at q's dtype on the current stream (`extra`:
    ints after the dims) and count the launch: by kernel, by (`kind`,
    batch, heads, sq, skv, head_dim), and an f32 launch also by (kernel,
    head_dim)."""
    strides = [s for t in strided for s in t.stride()[:3]]
    err = _kernel(name, q.dtype)(
        *pointers, *dims, *extra, *strides, int(causal), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    shape_launches[(kind or name, *dims)] += 1
    if q.dtype == torch.float32:
        f32_launches[(name, dims[-1])] += 1


def _bshd(batch, seq, heads, d, like) -> torch.Tensor:
    """An empty (B, H, S, D) view of a (B, S, H, D) buffer."""
    return torch.empty(
        (batch, seq, heads, d), dtype=like.dtype, device=like.device
    ).permute(0, 2, 1, 3)


def _fwd_launch(name, q, k, v, kv, q_off, causal, sm_scale, with_lse, extra=()):
    """Launch forward kernel `name`: (out, lse or None)."""
    _check_cuda_operands(q, k, v)
    batch, heads, sq, d = q.shape
    out = _bshd(batch, sq, heads, d, q)
    lse = (torch.empty((batch, heads, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() and not k.shape[2]:  # no keys: every row is empty
        out.zero_()
        if lse is not None:
            lse.fill_(EMPTY_ROW_LSE)
    elif out.numel():
        _launch(
            name,
            [t.data_ptr() for t in (q, k, v, out)]
            + [None if lse is None else lse.data_ptr(), kv.data_ptr(),
               q_off.data_ptr()],
            (batch, heads, sq, k.shape[2], d), (q, k, v, out), causal,
            sm_scale, q, "flash_fwd_lse" if with_lse else "flash_fwd", extra,
        )
        fwd_launches[(d, with_lse)] = fwd_launches.get((d, with_lse), 0) + 1
    return out, lse


def _fwd_wgmma_kernel(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """Launch flash_fwd_wgmma (bf16, f16) at the query tile the grid asks
    for: (out, lse or None)."""
    batch, heads, sq, d = q.shape
    tile = forward_query_tile(batch, heads, sq, d, _sm_count(q.device.index))
    return _fwd_launch("flash_fwd_wgmma", q, k, v, kv, q_off, causal, sm_scale,
                       with_lse, (tile,))


def _fwd_mma_kernel(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """Launch flash_fwd (mma.sync; bf16 or f32, head_dim 64 or 128): (out,
    lse or None). The f32 route; its bf16 build, which no path launches, is
    the yardstick that chip_smoke.py times flash_fwd_wgmma against."""
    return _fwd_launch("flash_fwd", q, k, v, kv, q_off, causal, sm_scale,
                       with_lse)


def _fwd_wide_kernel(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """Launch flash_fwd's wide route (bf16, f16, f32 at a multiple of 64
    above the native widths): (out, lse or None)."""
    return _fwd_launch("flash_fwd_wide", q, k, v, kv, q_off, causal, sm_scale,
                       with_lse)


def _forward_kernel(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """The forward kernel of q's dtype and width: (out, lse or None)."""
    if is_wide(q.shape[-1], q.dtype):
        fn = _fwd_wide_kernel
    elif q.dtype == torch.float32:
        fn = _fwd_mma_kernel
    else:
        fn = _fwd_wgmma_kernel
    return fn(q, k, v, kv, q_off, causal, sm_scale, with_lse)


def _check_do(q, do):
    try:
        _check_layout("do", do, q)
    except ValueError:
        do = do.contiguous()
        _check_layout("do", do, q)
    return do


def _bwd_kernel(q, k, v, do, lse, delta, kv, q_off, causal, sm_scale):
    """Launch flash_bwd (bf16, f16; head_dim 64 or 128): (dq, dk, dv). `lse`
    and `delta` are contiguous (B, H, Sq) f32. The kernel adds dQ across key tiles into a
    zeroed f32 (B, H, Sq, D) buffer allocated here, and a second kernel of
    the same source converts it into dq."""
    batch, heads, sq, d = q.shape
    skv = k.shape[2]
    dq = _bshd(batch, sq, heads, d, q)
    dk = _bshd(batch, skv, heads, d, k)
    dv = _bshd(batch, skv, heads, d, v)
    if dq.numel() and dk.numel():
        dq_acc = torch.zeros((batch, heads, sq, d), dtype=torch.float32,
                             device=q.device)
        _launch(
            "flash_bwd",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq_acc, dq, dk, dv,
                                    kv, q_off)],
            (batch, heads, sq, skv, d), (q, k, v, do, dq, dk, dv), causal,
            sm_scale, q,
        )
    elif dq.numel() or dk.numel():  # no keys or no queries: no gradient
        for t in (dq, dk, dv):
            t.zero_()
    return dq, dk, dv


def _bwd_dq_kernel(q, k, v, do, lse, delta, kv, q_off, causal, sm_scale,
                   name="flash_bwd_dq"):
    """Launch flash_bwd_dq (or its wide route, `name` flash_bwd_dq_wide): dq.
    `lse` and `delta` are contiguous (B, H, Sq) f32."""
    batch, heads, sq, d = q.shape
    dq = _bshd(batch, sq, heads, d, q)
    if dq.numel():
        _launch(
            name,
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq, kv, q_off)],
            (batch, heads, sq, k.shape[2], d), (q, k, v, do, dq), causal,
            sm_scale, q,
        )
    return dq


def _bwd_dkv_kernel(q, k, v, do, lse, delta, kv, q_off, causal, sm_scale,
                    name="flash_bwd_dkv"):
    """Launch flash_bwd_dkv (or its wide route, `name` flash_bwd_dkv_wide):
    (dk, dv)."""
    batch, heads, sq, d = q.shape
    skv = k.shape[2]
    dk = _bshd(batch, skv, heads, d, k)
    dv = _bshd(batch, skv, heads, d, v)
    if dk.numel():
        _launch(
            name,
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv, kv, q_off)],
            (batch, heads, sq, skv, d), (q, k, v, do, dk, dv), causal,
            sm_scale, q,
        )
    return dk, dv


def _backward_kernels(q, k, v, o, lse, do, kv, q_off, causal, sm_scale):
    """(dq, dk, dv) by the kernels at the kernel width: flash_bwd in bf16 and
    f16 up to head_dim 128, flash_bwd_dq and flash_bwd_dkv in f32 and at
    head_dim 256, their wide route above the native widths. delta =
    rowsum(dO * O) in f32, as the JAX package computes it outside its
    kernels."""
    _check_cuda_operands(q, k, v)
    do = _check_do(q, do)
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    args = (q, k, v, do, lse.contiguous(), delta, kv, q_off, causal, sm_scale)
    if is_wide(q.shape[-1], q.dtype):
        return (_bwd_dq_kernel(*args, name="flash_bwd_dq_wide"),
                *_bwd_dkv_kernel(*args, name="flash_bwd_dkv_wide"))
    if q.dtype != torch.float32 and q.shape[-1] <= 128:
        return _bwd_kernel(*args)
    return (_bwd_dq_kernel(*args), *_bwd_dkv_kernel(*args))


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
    launches the backward kernels (`_backward_kernels`), on CPU tensors it
    runs `flash_attention_backward_reference`, both at the kernel width
    (`with_head_dim_padded`)."""
    kv, q_off, sm_scale = _row_args(q, k, kv_lens, q_offset, sm_scale)
    fn = (_backward_kernels if q.device.type == "cuda"
          else flash_attention_backward_reference)
    return with_head_dim_padded(
        fn, q, k, v, o, lse, do, kv, q_off, causal, sm_scale=sm_scale
    )


def _plain_forward(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """`flash_attention_reference` with `_forward_kernel`'s signature."""
    out = flash_attention_reference(
        q, k, v, kv_lens=kv, causal=causal, q_offset=q_off, sm_scale=sm_scale,
        with_lse=with_lse,
    )
    return out if with_lse else (out, None)


def _forward(q, k, v, kv, q_off, causal, sm_scale, with_lse):
    """(out, lse or None) at the kernel width: the forward kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if q.device.type == "cuda":
        check_operands(q, k, v)
        fn = _forward_kernel
    else:
        fn = _plain_forward
    return with_head_dim_padded(
        fn, q, k, v, kv, q_off, causal, sm_scale=sm_scale, with_lse=with_lse
    )


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's
    `_flash_attention_core` with its custom VJP). The forward saves q, k, v,
    the output, the log-sum-exp, kv_lens and q_offset, and the true width's
    sm_scale; the backward runs the backward kernels on the card and their
    plain version on the CPU, both at the kernel width."""

    @staticmethod
    def forward(ctx, q, k, v, kv, q_off, causal, sm_scale):
        out, lse = _forward(q, k, v, kv, q_off, causal, sm_scale, True)
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
    return _forward(q, k, v, kv, q_off, causal, sm_scale, False)[0]


# kernel launches since the last reset: by kernel (a bf16 or f16 forward is
# "flash_fwd_wgmma", an f32 one "flash_fwd", one above the native widths
# "flash_fwd_wide"; the wide backward "flash_bwd_dq_wide" and
# "flash_bwd_dkv_wide"); the forward's by (kernel head dim, whether it wrote
# the log-sum-exp); every launch by (kind, batch, heads, sq, skv, kernel
# head dim), kind "flash_fwd", "flash_fwd_lse" (the forward that autograd
# records; any forward kernel), "flash_bwd" (bf16, f16), "flash_bwd_dq" or
# "flash_bwd_dkv" (f32; bf16, f16 at 256), "flash_bwd_dq_wide" or
# "flash_bwd_dkv_wide"; and the f32 launches by (kernel, kernel head dim).
# chip_smoke.py reads them to show that the main path went through the
# kernels, and at which shapes (the towers, BERT, the LLM, the fine-patch
# tower, the synthetic CLI's padded widths).
launches = dict.fromkeys((*KERNELS, *WIDE), 0)
fwd_launches = {(d, lse): 0 for d in SUPPORTED_HEAD_DIMS for lse in (False, True)}
shape_launches: collections.Counter = collections.Counter()
f32_launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    for counts in (launches, fwd_launches):
        for key in counts:
            counts[key] = 0
    shape_launches.clear()
    f32_launches.clear()
