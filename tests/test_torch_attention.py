"""The port's attention against the JAX package's, on the CPU in f32.

On a CPU tensor the port's `flash_attention` runs its plain version
(`flash_attention_reference`); the JAX `flash_attention` runs its Pallas
kernel in interpret mode. Both get the same numpy inputs. Tolerance 2e-5
absolute and relative: both sides compute in f32 and differ only in the
order of their sums.

Gradients: the port's autograd Function (whose CPU backward is the plain
version of the dQ and dK/dV kernels, `flash_attention_backward_reference`)
against `jax.vjp` of the JAX `flash_attention` through each of its three
backward routes: the resident Pallas kernels (B3), the streaming ones (B4,
forced with small blocks) and the recompute route (`use_pallas_bwd=False`
here; in the port autograd through `flash_attention_reference`).
Tolerance 1e-4 absolute and relative in f32: the backward sums over up to
100 keys or queries in another order.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.attention as jattn
import hsenet_tpu.ops.flash_attention as jfa
import hsenet_torch.ops.flash_attention as tfa
from hsenet_torch.ops import _build
from hsenet_torch.ops import attention as tattn
from hsenet_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_reference,
)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("kv_len,q_off", [(60, 0), (512, 0), (330, 257)])
def test_flash_matches_jax_production_streaming_dispatch(kv_len, q_off):
    """A serving engine with a 2048-token output budget prefills over a
    2576-slot cache row (prompt cap 512 + 2048 + chunk 16). At that key
    length and head_dim 128 the JAX package's own dispatch (`_needs_stream`
    with the default blocks, no test hook) picks its streaming kernel; the
    port's one tiled forward must compute the same function there. One
    head and 96 query rows keep interpret mode quick (about a second);
    S_kv is not cut. kv_len 60 cuts the causal rows short, 512 does not, and
    offset 257 is a KV-prefix hit's question chunk."""
    skv, d = 2576, 128
    assert jfa._FORCE_STREAM is None
    assert jfa._needs_stream(
        jfa._round_up(skv, jfa.DEFAULT_BLOCK_K), d, jfa.DEFAULT_BLOCK_Q,
        jfa.DEFAULT_BLOCK_K, 4)
    assert not jfa._needs_stream(  # the CLI's default 1040-slot row does not
        jfa._round_up(1040, jfa.DEFAULT_BLOCK_K), d, jfa.DEFAULT_BLOCK_Q,
        jfa.DEFAULT_BLOCK_K, 4)
    arrays = _inputs(6, 1, 1, 1, 96, skv, d)
    got, want = _both(
        jfa.flash_attention, flash_attention, arrays,
        kv_lens=np.asarray([kv_len], np.int32), causal=True, q_offset=q_off,
    )
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
    before = dict(tfa.launches)
    out = flash_attention(q, k, v, causal=True)
    assert tfa.launches == before
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


def _jax_vjp(arrays, do, route, **kw):
    """(out, (dq, dk, dv)) of the JAX flash_attention through `route`:
    "resident" (B3), "stream" (B4 with small blocks), "recompute", or
    "production" (the default blocks, no hook: `_needs_stream` decides)."""
    blocks = dict(block_q=128, block_k=128) if route == "stream" else {}

    def f(q, k, v):
        return jfa.flash_attention(
            q, k, v, use_pallas_bwd=route != "recompute", **blocks, **kw
        )

    try:
        jfa._FORCE_STREAM = True if route == "stream" else None
        out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
        grads = vjp(jnp.asarray(do))
    finally:
        jfa._FORCE_STREAM = None
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(arrays, do, attend=flash_attention, **kw):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = attend(*leaves, **kw)
    return out, torch.autograd.grad(out, leaves, torch.as_tensor(do))


def _row_kw(kv_lens, q_off, causal):
    off = np.asarray(q_off, np.int32) if isinstance(q_off, list) else q_off
    return dict(kv_lens=np.asarray(kv_lens, np.int32), causal=causal, q_offset=off)


@pytest.mark.parametrize("route", ["resident", "stream", "recompute"])
@pytest.mark.parametrize("causal,sq,skv,d,kv_lens,q_off", FLASH_CASES)
def test_flash_grads_match_jax(route, causal, sq, skv, d, kv_lens, q_off):
    arrays = _inputs(7, 2, 3, 3, sq, skv, d)
    do = np.random.default_rng(8).standard_normal((2, 3, sq, d)).astype(np.float32)
    kw = _row_kw(kv_lens, q_off, causal)
    want_out, want = _jax_vjp(arrays, do, route, **kw)
    out, got = _port_grads(
        arrays, do,
        attend=flash_attention_reference if route == "recompute" else flash_attention,
        **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()},
    )
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def _bwd_blocks(sq, skv, d):
    """The JAX backward's padded lengths and blocks at its default blocks."""
    block_q = min(jfa.DEFAULT_BLOCK_Q, jfa._round_up(sq, 128), 512)
    block_k = min(jfa.DEFAULT_BLOCK_K, jfa._round_up(skv, 128))
    return (jfa._round_up(sq, block_q), jfa._round_up(skv, block_k), d,
            block_q, block_k)


@pytest.mark.parametrize("kv_len,causal", [(3200, False), (2000, False),
                                           (2500, True)])
def test_flash_grads_match_jax_production_streaming_dispatch(kv_len, causal):
    """At 3200 tokens of one f32 head at d 64 the JAX package's own
    dispatch (`_needs_stream` with the default blocks, no test hook) picks
    both streaming backward kernels (B4: dQ streams K/V, dK/dV streams Q
    and dO), as it does for the fine-patch tower's 16,385 bf16 tokens; at
    the production tower's 2049 it picks neither. The port's one tiled
    backward must give the same gradients there. A few seconds in
    interpret mode."""
    s, d = 3200, 64
    assert jfa._FORCE_STREAM is None
    sq_pad, skv_pad, _, bq, bk = _bwd_blocks(s, s, d)
    assert jfa._needs_stream(skv_pad, d, bq, bk, 4)  # dQ streams K/V
    assert jfa._needs_stream(sq_pad, d, bq, bk, 4)  # dK/dV streams Q/dO
    sq_pad, skv_pad, _, bq, bk = _bwd_blocks(2049, 2049, d)
    assert not jfa._needs_stream(skv_pad, d, bq, bk, 2)
    assert not jfa._needs_stream(sq_pad, d, bq, bk, 2)
    arrays = _inputs(14, 1, 1, 1, s, s, d)
    do = np.random.default_rng(15).standard_normal((1, 1, s, d)).astype(np.float32)
    kw = _row_kw([kv_len], 0, causal)
    want_out, want = _jax_vjp(arrays, do, "production", **kw)
    out, got = _port_grads(arrays, do, kv_lens=torch.as_tensor(kw["kv_lens"]),
                           causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_flash_grads_of_an_empty_row_are_zero(route):
    """kv_len 0: the row's output is 0 whatever Q, K and V are, so all its
    gradients are exactly 0 (the JAX kernels agree; its recompute route
    differentiates the mean of V instead and is left out)."""
    arrays = _inputs(9, 2, 2, 2, 16, 16, 64)
    do = np.random.default_rng(10).standard_normal((2, 2, 16, 64)).astype(np.float32)
    kv = np.asarray([0, 9], np.int32)
    _, want = _jax_vjp(arrays, do, route, kv_lens=kv)
    _, got = _port_grads(arrays, do, kv_lens=torch.as_tensor(kv))
    for g, w in zip(got, want):
        assert torch.count_nonzero(g[0]) == 0
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("causal,sq,skv,d,kv_lens,q_off", FLASH_CASES[1:3])
def test_backward_reference_matches_jax_kernels(causal, sq, skv, d, kv_lens, q_off):
    """The plain version alone, fed the JAX forward's output and log-sum-exp."""
    arrays = _inputs(11, 2, 2, 2, sq, skv, d)
    do = np.random.default_rng(12).standard_normal((2, 2, sq, d)).astype(np.float32)
    kw = _row_kw(kv_lens, q_off, causal)
    out, lse = _jax_lse(arrays, **kw)
    _, want = _jax_vjp(arrays, do, "resident", **kw)
    got = flash_attention_backward_reference(
        *(torch.as_tensor(a) for a in arrays), torch.as_tensor(out),
        torch.as_tensor(lse), torch.as_tensor(do), torch.as_tensor(kw["kv_lens"]),
        torch.as_tensor(kw["q_offset"]), causal,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def _jax_lse(arrays, *, kv_lens, causal, q_offset):
    q, k, v = (jnp.asarray(a) for a in arrays)
    batch, _, sq, d = q.shape
    skv = k.shape[2]
    out, lse = jfa._flash_forward(
        q, k, v, jnp.asarray(kv_lens),
        jnp.broadcast_to(jnp.asarray(q_offset, jnp.int32), (batch,)),
        causal=causal, sm_scale=d ** -0.5,
        block_q=min(jfa.DEFAULT_BLOCK_Q, -(-sq // 128) * 128),
        block_k=min(jfa.DEFAULT_BLOCK_K, -(-skv // 128) * 128),
        interpret=True, with_lse=True,
    )
    return np.array(out), np.array(lse[:, :, :sq, 0])


@pytest.mark.parametrize(
    "causal,sq,skv,d,kv_lens,q_off",
    FLASH_CASES + [(False, 16, 16, 64, [0, 9], 0)],
)
def test_lse_matches_jax_forward(causal, sq, skv, d, kv_lens, q_off):
    """The log-sum-exp the backward reads, 1e30 on a row with no valid
    column, against the JAX forward's `with_lse=True` output."""
    arrays = _inputs(13, 2, 2, 2, sq, skv, d)
    kw = _row_kw(kv_lens, q_off, causal)
    want_out, want = _jax_lse(arrays, **kw)
    out, lse = flash_attention_reference(
        *(torch.as_tensor(a) for a in arrays), with_lse=True,
        **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()},
    )
    assert lse.shape == (2, 2, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def test_gqa_grads_sum_over_kv_heads():
    """24q/8kv-style grouping at toy size: the expanded K/V gradients sum
    back onto the 2 kv heads, as in the JAX package."""
    arrays = _inputs(14, 2, 6, 2, 70, 80, 128)
    do = np.random.default_rng(15).standard_normal((2, 6, 70, 128)).astype(np.float32)
    kv = np.asarray([80, 51], np.int32)
    off = np.asarray([10, 0], np.int32)

    def f(q, k, v):
        return jattn.multi_head_attention(
            q, k, v, kv_lens=jnp.asarray(kv), causal=True,
            q_offset=jnp.asarray(off), use_flash=True,
        )

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(do))
    _, got = _port_grads(
        arrays, do, attend=tattn.multi_head_attention,
        kv_lens=torch.as_tensor(kv), causal=True, q_offset=torch.as_tensor(off),
        use_flash=True,
    )
    assert got[1].shape == (2, 2, 80, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_no_grad_path_records_no_graph():
    """Without grad (the towers under stop_tower_gradients, inference) the
    forward returns a plain tensor; with it, a differentiable one."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(16, 1, 2, 2, 9, 9, 64))
    assert flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q, k, v).grad_fn is not None
