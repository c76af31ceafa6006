"""The flash kernels' float16 operands and head dims up to 256 (ROADMAP C2)
against the JAX package, on the CPU.

The port's CUDA route takes bf16, f16 and f32 at native kernel widths 64,
128 and 256 (f32: 64 and 128) and above them at multiples of 64 (the wide
route, `test_torch_flash_wide.py`); `with_head_dim_padded` gives every
other width zero columns up to its kernel width. Here the plain versions run that route at the padded
width, through `flash_attention` and its autograd Function, and the JAX
kernels (`hsenet_tpu/ops/flash_attention.py`, which pad to a multiple of
128 themselves) run in interpret mode on the same inputs, drawn from a seed
with numpy and handed to both in the dtype under test. Ragged kv_lens on
every case; causal cases put each batch row at its own query offset.

Tolerances, each element against the largest |value| of its tensor:
- f32: 2e-5 for the forward, 1e-4 for the gradients (both sides in f32,
  sums in another order), as in `test_torch_flash_pad.py`; log-sum-exp
  2e-5 absolute.
- f16: both sides round each output to f16 (2^-11 of a value), and the JAX
  kernel also rounds the scaled Q (single-block path) and P, and in the
  backward dS, to f16 where the plain versions keep f32; those roundings
  add up to a few f16 units (read: 3e-4 to 8.3e-4). Forward and gradients
  2e-3, log-sum-exp 1e-3 absolute (the scores carry the f16 rounding of
  the scaled Q where sm_scale is not a power of two; read: up to 2.5e-4).

The query-tile dispatch of the wgmma forward is a pure function of the
grid and the kernel width; the last tests pin it at the shapes that
`chip_smoke.py` drives, as `PERF.md` records them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.flash_attention as jfa
import hsenet_torch.ops.flash_attention as tfa
from hsenet_torch.ops.flash_attention import (
    check_operands,
    flash_attention,
    forward_query_tile,
    kernel_head_dim,
    with_head_dim_padded,
)

torch.set_num_threads(1)

B, H, SQ, SKV = 2, 2, 40, 70
KV_LENS = np.asarray([70, 45], np.int32)
Q_OFFSET = np.asarray([30, 12], np.int32)

# (forward, gradients, log-sum-exp) tolerances by dtype: the first two as a
# share of the tensor's largest |value|, the log-sum-exp absolute
TOL = {"float32": (2e-5, 1e-4, 2e-5), "float16": (2e-3, 2e-3, 1e-3)}
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "float16": (np.float16, torch.float16, jnp.float16)}
# f16 at the kernels' own widths, and the padded route at 160 and 192
# (padded to 256 in f16; to 192 and 256 in f32, the wide route) and at 256
# itself, in f32 and f16
CASES = [("float16", 64), ("float16", 128)] + [
    (dt, d) for d in (160, 192, 256) for dt in ("float32", "float16")]


def _inputs(seed, d, dtype):
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype][0]
    q = rng.standard_normal((B, H, SQ, d)).astype(np_dt)
    k, v = (rng.standard_normal((B, H, SKV, d)).astype(np_dt) for _ in range(2))
    do = rng.standard_normal((B, H, SQ, d)).astype(np_dt)
    return (q, k, v), do


def _row_kw(causal):
    return dict(kv_lens=KV_LENS, causal=causal, q_offset=Q_OFFSET if causal else 0)


def _torch_kw(kw):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _close(got, want, share):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= share * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize(
    "dtype,d,causal",
    [(dt, d, True) for dt, d in CASES]
    + [("float16", 64, False), ("float16", 128, False), ("float16", 256, False)])
def test_forward_and_lse_match_jax(dtype, d, causal):
    """`flash_attention`'s forward (the plain version at the padded width)
    and the log-sum-exp its autograd route writes, against the JAX forward
    kernel with its log-sum-exp."""
    arrays, _ = _inputs(0, d, dtype)
    kw = _row_kw(causal)
    q, k, v = (jnp.asarray(a) for a in arrays)
    want_out, want_lse = jfa._flash_forward(
        q, k, v, jnp.asarray(KV_LENS),
        jnp.broadcast_to(jnp.asarray(kw["q_offset"], jnp.int32), (B,)),
        causal=causal, sm_scale=d ** -0.5, block_q=128, block_k=128,
        interpret=True, with_lse=True,
    )
    tq, tk, tv = (torch.as_tensor(a) for a in arrays)
    out = flash_attention(tq, tk, tv, **_torch_kw(kw))
    _, lse = with_head_dim_padded(
        tfa.flash_attention_reference, tq, tk, tv, sm_scale=d ** -0.5,
        with_lse=True, **_torch_kw(kw))
    fwd_tol, _, lse_tol = TOL[dtype]
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, SQ, d)
    _close(out.float().numpy(), np.asarray(want_out[:, :, :SQ, :d]), fwd_tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse[:, :, :SQ, 0]),
                               atol=lse_tol, rtol=0)


@pytest.mark.parametrize("dtype,d", CASES)
def test_grads_match_jax(dtype, d, monkeypatch):
    """Forward and dQ, dK, dV through `_FlashAttention` (causal rows at
    per-row offsets, ragged kv_lens), whose backward runs the plain version
    at the kernel width (the spy sees it), against `jax.vjp` of the JAX
    kernels."""
    arrays, do = _inputs(2, d, dtype)
    kw = _row_kw(True)
    widths = []
    plain_bwd = tfa.flash_attention_backward_reference

    def spy(q, *args, **kwargs):
        widths.append(q.shape[-1])
        return plain_bwd(q, *args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention_backward_reference", spy)
    want_out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, **_jax_kw(kw)),
        *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(do))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = flash_attention(*leaves, **_torch_kw(kw))
    got = torch.autograd.grad(out, leaves, torch.as_tensor(do))
    fwd_tol, grad_tol, _ = TOL[dtype]
    assert widths == [kernel_head_dim(d, DTYPES[dtype][1])]
    _close(out.detach().float().numpy(), np.asarray(want_out), fwd_tol)
    for g, w, n in zip(got, want, (SQ, SKV, SKV)):
        assert g.dtype == DTYPES[dtype][1] and g.shape == (B, H, n, d)
        _close(g.float().numpy(), np.asarray(w), grad_tol)


def test_keys_past_kv_len_get_zero_gradients_at_256():
    """dK and dV are exactly 0 at keys past kv_len on the padded route."""
    arrays, do = _inputs(3, 192, "float16")
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = flash_attention(*leaves, **_torch_kw(_row_kw(True)))
    _, dk, dv = torch.autograd.grad(out, leaves, torch.as_tensor(do))
    for g in (dk, dv):
        assert torch.count_nonzero(g[1, :, KV_LENS[1]:]) == 0
        assert torch.count_nonzero(g[1, :, :KV_LENS[1]]) > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [130, 160, 192, 256])
def test_operand_check_takes_16_bit_up_to_256(dtype, d):
    q, k, v = (torch.zeros((2, 3, n, d), dtype=dtype) for n in (5, 7, 7))
    check_operands(q, k, v)
    assert kernel_head_dim(d) == 256


@pytest.mark.parametrize("d", [160, 256])
def test_operand_check_f32_stops_at_128(d):
    """Above 128, the f32 (TF32 mma.sync) kernels' widest native width, f32
    takes the wide route at the next multiple of 64 (ROADMAP C2, closed);
    the plain version on the CPU pads to the same width and runs."""
    q, k, v = (torch.zeros((1, 2, 4, d)) for _ in range(3))
    check_operands(q, k, v)
    assert kernel_head_dim(d, torch.float32) == {160: 192, 256: 256}[d]
    assert tfa.is_wide(kernel_head_dim(d, torch.float32), torch.float32)
    assert flash_attention(q, k, v).shape == q.shape


# (batch, heads, query rows, kernel head dim) of every forward launch that
# chip_smoke.py drives or times through flash_fwd_wgmma, and the query tile
# PERF.md records for it: 64 rows at head dim 64 and 128 (two CTAs an SM);
# at 256, 128 rows where the 128-row grid covers the 132 SMs
PATH_SHAPES = {
    "tower": ((2, 12, 2049, 64), 64),
    "encode_tower": ((8, 12, 2049, 64), 64),
    "clip_tower": ((24, 12, 2049, 64), 64),
    "clip_bert": ((24, 12, 128, 64), 64),
    "clip_bert_batch2": ((2, 12, 128, 64), 64),
    "clip_long": ((2, 12, 16385, 64), 64),
    "prefill": ((2, 24, 320, 128), 64),
    "train": ((3, 24, 800, 128), 64),
    "serve_prefill": ((1, 24, 512, 128), 64),
    "serve_prefix_hit": ((1, 24, 255, 128), 64),
    "llm_long_4096": ((1, 24, 4096, 128), 64),
    "d256_long": ((4, 16, 2048, 256), 128),
    "d256_padded_d160": ((2, 16, 1024, 256), 128),
    "d256_small": ((2, 3, 70, 256), 64),
}


@pytest.mark.parametrize("name", sorted(PATH_SHAPES))
def test_forward_query_tile_at_path_shapes(name):
    (b, h, s, d), tile = PATH_SHAPES[name]
    assert forward_query_tile(b, h, s, d) == tile


def test_forward_query_tile_follows_the_sm_count():
    """At 256 the grid against the card's SMs decides: 33 128-row CTAs
    cover a card of 33 SMs, not one of 132."""
    assert forward_query_tile(1, 11, 384, 256, sms=33) == 128
    assert forward_query_tile(1, 11, 384, 256, sms=132) == 64
