"""The flash kernels' wide route (ROADMAP C2, closed) against the JAX
package, on the CPU: bf16 and f16 above head dim 256, f32 above 128.

Above the native widths (64, 128 and, in bf16 and f16, 256) the port pads
the head dim to the next multiple of 64 and runs the `_wide` entries of
`csrc/flash_fwd.cu`, `flash_bwd_dq.cu` and `flash_bwd_dkv.cu` on the card.
Here the plain versions run that route at the padded width, through
`flash_attention` and its autograd Function, and the JAX kernels
(`hsenet_tpu/ops/flash_attention.py`, which pad to a multiple of 128
themselves) run in interpret mode on the same inputs, drawn from a seed
with numpy and rounded to the dtype under test on both sides. Ragged
kv_lens on every case; causal cases put each batch row at its own query
offset.

Tolerances, each element against the largest |value| of its tensor, as in
`test_torch_flash_c2.py`: f32 2e-5 forward, 1e-4 gradients, log-sum-exp
2e-5 absolute; f16 2e-3, 2e-3 and 1e-3. bf16 keeps 3 fewer mantissa bits
than f16 (a unit is 2^-8 of a value, not 2^-11), and the JAX kernel rounds
the scaled Q, P and dS to bf16 where the plain versions keep f32: 8 times
f16's limits, 1.6e-2, 1.6e-2 and 8e-3.
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
    kernel_head_dim,
    with_head_dim_padded,
)

torch.set_num_threads(1)

B, H, SQ, SKV = 2, 2, 40, 70
KV_LENS = np.asarray([70, 45], np.int32)
Q_OFFSET = np.asarray([30, 12], np.int32)

# (forward, gradients, log-sum-exp) tolerances by dtype: the first two as a
# share of the tensor's largest |value|, the log-sum-exp absolute
TOL = {"float32": (2e-5, 1e-4, 2e-5), "float16": (2e-3, 2e-3, 1e-3),
       "bfloat16": (1.6e-2, 1.6e-2, 8e-3)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the wide route at 320 and 512 in every dtype, f32 at 192 and 256, and two
# widths that are not multiples of 64 (bf16 300 -> 320, f32 200 -> 256)
CASES = [(dt, d) for d in (320, 512) for dt in ("bfloat16", "float16", "float32")
         ] + [("float32", 192), ("float32", 256), ("bfloat16", 300),
              ("float32", 200)]


def _inputs(seed, d):
    """(q, k, v) and dO in f32, to be rounded to the dtype under test."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, SQ, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, SKV, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, H, SQ, d)).astype(np.float32)
    return (q, k, v), do


def _torch(a, dtype, grad=False):
    return torch.tensor(a).to(DTYPES[dtype][0]).requires_grad_(grad)


def _jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


def _row_kw(causal, kv_lens=KV_LENS):
    return dict(kv_lens=kv_lens, causal=causal, q_offset=Q_OFFSET if causal else 0)


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


@pytest.mark.parametrize("dtype,d", CASES)
def test_wide_widths_take_the_wide_route(dtype, d):
    """The operand check takes the width, the kernel width is the next
    multiple of 64 above the native ones, and it runs the wide kernels."""
    q = torch.zeros((1, 2, 4, d), dtype=DTYPES[dtype][0])
    check_operands(q, q, q)
    width = kernel_head_dim(d, q.dtype)
    assert width == -(-d // 64) * 64 and tfa.is_wide(width, q.dtype)


@pytest.mark.parametrize("dtype,d", CASES)
def test_forward_and_lse_match_jax(dtype, d):
    """`flash_attention`'s forward (the plain version at the padded width)
    and the log-sum-exp its autograd route writes, against the JAX forward
    kernel with its log-sum-exp; causal rows at per-row offsets."""
    arrays, _ = _inputs(0, d)
    kw = _row_kw(True)
    want_out, want_lse = jfa._flash_forward(
        *(_jax(a, dtype) for a in arrays), jnp.asarray(KV_LENS),
        jnp.asarray(Q_OFFSET), causal=True, sm_scale=d ** -0.5, block_q=128,
        block_k=128, interpret=True, with_lse=True,
    )
    tq, tk, tv = (_torch(a, dtype) for a in arrays)
    out = flash_attention(tq, tk, tv, **_torch_kw(kw))
    _, lse = with_head_dim_padded(
        tfa.flash_attention_reference, tq, tk, tv, sm_scale=d ** -0.5,
        with_lse=True, **_torch_kw(kw))
    fwd_tol, _, lse_tol = TOL[dtype]
    assert out.dtype == DTYPES[dtype][0] and out.shape == (B, H, SQ, d)
    _close(out.float().numpy(), np.asarray(want_out[:, :, :SQ, :d], np.float32),
           fwd_tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse[:, :, :SQ, 0]),
                               atol=lse_tol, rtol=0)


@pytest.mark.parametrize("dtype,d", CASES)
def test_grads_match_jax(dtype, d, monkeypatch):
    """Forward and dQ, dK, dV through `_FlashAttention` (causal rows at
    per-row offsets, ragged kv_lens), whose backward runs the plain version
    at the wide kernel width (the spy sees it), against `jax.vjp` of the JAX
    kernels."""
    arrays, do = _inputs(2, d)
    kw = _row_kw(True)
    widths = []
    plain_bwd = tfa.flash_attention_backward_reference

    def spy(q, *args, **kwargs):
        widths.append(q.shape[-1])
        return plain_bwd(q, *args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention_backward_reference", spy)
    want_out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, **_jax_kw(kw)),
        *(_jax(a, dtype) for a in arrays))
    want = vjp(_jax(do, dtype))
    leaves = [_torch(a, dtype, grad=True) for a in arrays]
    out = flash_attention(*leaves, **_torch_kw(kw))
    got = torch.autograd.grad(out, leaves, _torch(do, dtype))
    fwd_tol, grad_tol, _ = TOL[dtype]
    assert widths == [-(-d // 64) * 64]
    _close(out.detach().float().numpy(), np.asarray(want_out, np.float32), fwd_tol)
    for g, w, n in zip(got, want, (SQ, SKV, SKV)):
        assert g.dtype == DTYPES[dtype][0] and g.shape == (B, H, n, d)
        _close(g.float().numpy(), np.asarray(w, np.float32), grad_tol)


@pytest.mark.parametrize("dtype,d", [("bfloat16", 320), ("float32", 192)])
def test_kv_len_zero_gives_zero_gradients(dtype, d):
    """A batch row with kv_len 0 has no valid key: its output and its dQ,
    dK and dV are exactly 0 on the wide route, and its sibling's are not;
    keys past the sibling's kv_len get exactly 0."""
    arrays, do = _inputs(3, d)
    kv_lens = np.asarray([0, 45], np.int32)
    leaves = [_torch(a, dtype, grad=True) for a in arrays]
    out = flash_attention(*leaves, **_torch_kw(_row_kw(True, kv_lens)))
    grads = torch.autograd.grad(out, leaves, _torch(do, dtype))
    for t in (out, *grads):
        assert torch.count_nonzero(t[0]) == 0
        assert torch.count_nonzero(t[1]) > 0
    for g in grads[1:]:
        assert torch.count_nonzero(g[1, :, 45:]) == 0
