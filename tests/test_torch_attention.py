"""The port's attention against the JAX package's, on the CPU in f32.

On a CPU tensor the port's `flash_attention` runs its plain version
(`flash_attention_reference`); the JAX `flash_attention` runs its Pallas
kernel in interpret mode. Both get the same numpy inputs. Tolerance 2e-5
absolute and relative: both sides compute in f32 and differ only in the
order of their sums.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.attention as jattn
import hsenet_tpu.ops.flash_attention as jfa
from hsenet_torch.ops import _build
from hsenet_torch.ops import attention as tattn
from hsenet_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, sq, d)).astype(np.float32),
        rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
        rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
    )


def _both(fn_jax, fn_torch, arrays, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = np.asarray(fn_jax(*(jnp.asarray(a) for a in arrays), **jkw))
    got = fn_torch(*(torch.as_tensor(a) for a in arrays), **tkw).numpy()
    return got, want


FLASH_CASES = [
    # (causal, sq, skv, d, kv_lens, q_offset)
    (False, 100, 100, 64, [100, 37], 0),  # ViT-like, padded keys
    (True, 96, 96, 64, [96, 80], 0),  # plain causal, ragged rows
    (True, 40, 96, 128, [96, 70], [56, 20]),  # chunked prefill, per row
    (False, 33, 70, 128, [70, 70], 0),  # Sq != Skv, no padding
]


@pytest.mark.parametrize("causal,sq,skv,d,kv_lens,q_off", FLASH_CASES)
def test_flash_matches_jax_kernel(causal, sq, skv, d, kv_lens, q_off):
    arrays = _inputs(0, 2, 3, 3, sq, skv, d)
    kv = np.asarray(kv_lens, np.int32)
    off = np.asarray(q_off, np.int32) if isinstance(q_off, list) else q_off
    got, want = _both(
        jfa.flash_attention, flash_attention, arrays,
        kv_lens=kv, causal=causal, q_offset=off,
    )
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_empty_row_is_zero():
    """kv_len 0 leaves no valid column: the kernel gives 0 (sdpa would give
    the mean of V)."""
    arrays = _inputs(1, 2, 2, 2, 16, 16, 64)
    kv = np.asarray([0, 9], np.int32)
    got, want = _both(jfa.flash_attention, flash_attention, arrays, kv_lens=kv)
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal,sq,skv,d,kv_lens,q_off", FLASH_CASES[1:3])
def test_flash_matches_jax_streaming_kernel(causal, sq, skv, d, kv_lens, q_off):
    """The JAX package's long-sequence kernel computes the same function;
    small blocks make it stream several K/V blocks."""
    arrays = _inputs(2, 2, 2, 2, sq, skv, d)
    kv = np.asarray(kv_lens, np.int32)
    off = np.asarray(q_off, np.int32) if isinstance(q_off, list) else q_off
    try:
        jfa._FORCE_STREAM = True
        got, want = _both(
            lambda *a, **k: jfa.flash_attention(*a, block_q=128, block_k=128, **k),
            flash_attention, arrays, kv_lens=kv, causal=causal, q_offset=off,
        )
    finally:
        jfa._FORCE_STREAM = None
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_gqa_multi_head_attention(use_flash):
    """24q/8kv-style grouping at toy size: 6 query heads over 2 kv heads."""
    arrays = _inputs(3, 2, 6, 2, 70, 80, 64)
    kv = np.asarray([80, 51], np.int32)
    off = np.asarray([10, 0], np.int32)
    got, want = _both(
        jattn.multi_head_attention, tattn.multi_head_attention, arrays,
        kv_lens=kv, causal=True, q_offset=off, use_flash=use_flash,
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "causal,kv_lens,q_off",
    [(False, None, 0), (False, [24, 5], 0), (True, [24, 20], [4, 0]),
     (True, None, 3)],
)
def test_sdpa_reference_matches_jax(causal, kv_lens, q_off):
    arrays = _inputs(4, 2, 2, 2, 20, 24, 16)
    kw = dict(causal=causal,
              q_offset=np.asarray(q_off, np.int32) if isinstance(q_off, list) else q_off)
    if kv_lens is not None:
        kw["kv_lens"] = np.asarray(kv_lens, np.int32)
    got, want = _both(jattn.sdpa_reference, tattn.sdpa_reference, arrays, **kw)
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_mode_never_takes_sdpa():
    """'never' routes multi-token queries to sdpa_reference, which keeps
    the JAX package's mean-of-V answer for an empty row."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(5, 1, 2, 2, 8, 8, 64))
    kv = torch.tensor([0], dtype=torch.int32)
    try:
        tattn.set_flash_mode("never")
        out = tattn.multi_head_attention(q, k, v, kv_lens=kv)
    finally:
        tattn.set_flash_mode("auto")
    torch.testing.assert_close(out, v.mean(dim=2, keepdim=True).expand_as(out))
    flash = tattn.multi_head_attention(q, k, v, kv_lens=kv)
    assert torch.count_nonzero(flash) == 0
    with pytest.raises(ValueError):
        tattn.set_flash_mode("always")


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.as_tensor(a) for a in _inputs(6, 1, 2, 2, 9, 9, 64))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    torch.testing.assert_close(
        out, flash_attention_reference(q, k, v, causal=True), rtol=0, atol=0
    )


def test_flash_rejects_devices_without_a_kernel():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc is installed here; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("flash_fwd")
