"""The flash kernels' head-dim padding against the JAX package, on the CPU
in f32.

The port's kernels run at head_dim 64, 128 and 256 (f32: 64 and 128) and
above them at multiples of 64; `with_head_dim_padded` gives every other
width zero columns up to the next of those, calls the
attention function it is handed (the kernel launchers on the card, the
plain versions here) with the true width's softmax scale, and slices the
outputs back. This file holds the widths up to 128 (widths above 128 and
f16 are `test_torch_flash_c2.py`'s). The JAX kernels pad such widths to
128 themselves
(`hsenet_tpu/ops/flash_attention.py`, `_flash_forward` and
`_flash_backward`), run here in interpret mode. Widths 8 and 16 are the
synthetic CLI's (towers, LLM), 96 is QFormer's. Tolerances as in
`test_torch_attention.py`: 2e-5 for the forward and the log-sum-exp,
1e-4 for the gradients (both sides in f32, sums in another order).
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
    flash_attention_reference,
    kernel_head_dim,
    with_head_dim_padded,
)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

B, H, SQ, SKV = 2, 2, 40, 70
KV_LENS = np.asarray([70, 45], np.int32)
# causal: the rows are a chunk of a longer prompt, each batch row at its
# own offset
Q_OFFSET = np.asarray([30, 12], np.int32)
PAD_CASES = [(d, causal) for d in (8, 16, 96) for causal in (False, True)]


def _inputs(seed, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, SQ, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, SKV, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, H, SQ, d)).astype(np.float32)
    return (q, k, v), do


def _row_kw(causal):
    return dict(kv_lens=KV_LENS, causal=causal, q_offset=Q_OFFSET if causal else 0)


def _torch_kw(kw):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_forward(arrays, kw):
    """(out, lse) of the JAX forward kernel in interpret mode."""
    q, k, v = (jnp.asarray(a) for a in arrays)
    d = q.shape[-1]
    out, lse = jfa._flash_forward(
        q, k, v, jnp.asarray(kw["kv_lens"]),
        jnp.broadcast_to(jnp.asarray(kw["q_offset"], jnp.int32), (B,)),
        causal=kw["causal"], sm_scale=d ** -0.5, block_q=128, block_k=128,
        interpret=True, with_lse=True,
    )
    return np.asarray(out), np.asarray(lse[:, :, :SQ, 0])


def _padded_forward(arrays, kw, sm_scale):
    q, k, v = (torch.as_tensor(a) for a in arrays)
    return with_head_dim_padded(
        flash_attention_reference, q, k, v, sm_scale=sm_scale, with_lse=True,
        **_torch_kw(kw),
    )


@pytest.mark.parametrize("d,causal", PAD_CASES)
def test_padded_forward_and_lse_match_jax(d, causal):
    arrays, _ = _inputs(0, d)
    kw = _row_kw(causal)
    want_out, want_lse = _jax_forward(arrays, kw)
    out, lse = _padded_forward(arrays, kw, d ** -0.5)
    assert out.shape == (B, H, SQ, d) and lse.shape == (B, H, SQ)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("d", [8, 96])
def test_sm_scale_of_the_padded_width_misses(d):
    """The limit's power: the softmax scale taken from the padded width
    (1/sqrt(64) or 1/sqrt(128)) instead of the true one must fail it,
    against the plain version at the true width (which the tests above
    hold to the JAX kernels)."""
    arrays, _ = _inputs(1, d)
    kw = _row_kw(False)
    want_out, want_lse = flash_attention_reference(
        *(torch.as_tensor(a) for a in arrays), with_lse=True, **_torch_kw(kw))
    out, lse = _padded_forward(arrays, kw, kernel_head_dim(d) ** -0.5)
    assert not np.allclose(out.numpy(), want_out.numpy(), **TOL)
    assert not np.allclose(lse.numpy(), want_lse.numpy(), **TOL)


@pytest.mark.parametrize("d,causal", PAD_CASES)
def test_padded_grads_match_jax(d, causal, monkeypatch):
    """Forward and dQ, dK, dV through `_FlashAttention`, whose forward and
    backward run the plain versions at the padded width (the spy sees the
    kernel width), against `jax.vjp` of the JAX kernels."""
    arrays, do = _inputs(2, d)
    kw = _row_kw(causal)
    widths = []
    plain_bwd = tfa.flash_attention_backward_reference

    def spy(q, *args, **kwargs):
        widths.append(q.shape[-1])
        return plain_bwd(q, *args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention_backward_reference", spy)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, **{k: jnp.asarray(x) if isinstance(
            x, np.ndarray) else x for k, x in kw.items()})

    want_out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(do))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = flash_attention(*leaves, **_torch_kw(kw))
    got = torch.autograd.grad(out, leaves, torch.as_tensor(do))
    assert widths == [kernel_head_dim(d)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    for g, w in zip(got, want):
        assert g.shape == (B, H, SQ if g is got[0] else SKV, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_kernel_widths_pass_through_without_a_copy():
    q = torch.zeros((1, 2, 8, 64))
    seen = []
    with_head_dim_padded(lambda *a, sm_scale: seen.append(a[0]), q, q, q,
                         sm_scale=0.125)
    assert seen[0] is q


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 16, 64, 96, 128])
def test_operand_check_takes_bf16_and_f32_up_to_128(dtype, d):
    q, k, v = (torch.zeros((2, 3, n, d), dtype=dtype) for n in (5, 7, 7))
    check_operands(q, k, v)
    assert kernel_head_dim(d) == (64 if d <= 64 else 128)


@pytest.mark.parametrize("what", ["float64", "mixed", "d257", "d320"])
def test_operand_check_raises(what):
    """A dtype the kernels do not take (float64: the JAX package has none
    with x64 off) and mixed dtypes raise. Widths above 256 are taken since
    ROADMAP C2 closed: the wide route pads 257 and 320 to 320."""
    d = {"d257": 257, "d320": 320}.get(what, 64)
    dtype = torch.float64 if what == "float64" else torch.bfloat16
    q, k, v = (torch.zeros((1, 2, 4, d), dtype=dtype) for _ in range(3))
    if what == "mixed":
        k = k.to(torch.float16)
    if what.startswith("d"):
        check_operands(q, k, v)
        assert kernel_head_dim(d, dtype) == 320
        return
    with pytest.raises(ValueError, match="dtype|float"):
        check_operands(q, k, v)
