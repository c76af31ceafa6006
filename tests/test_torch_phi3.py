"""The port's Phi decoder against the JAX package's, on the CPU in f32.

The JAX side runs with flash mode "always" and prompts of 70 tokens, so
its prefill and full forward go through the Pallas kernel (interpret
mode), as on the TPU. Tolerance 1e-4 absolute and relative on logits of
order 1: two decoder layers in f32 over a bf16 KV cache that both sides
round the same way.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.attention as jattn
from hsenet_tpu.models.phi3 import KVCache as JaxCache
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_torch.models.phi3 import KVCache, Phi3ForCausalLM
from test_torch_common import (
    TINY_LLM,
    fill_zero_inits,
    load_flax,
    to_np,
    to_torch_config,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 70
# LongRoPE: a cache longer than original_max_position_embeddings picks the
# long factors and the sqrt(1 + ln(4)/ln(16)) cos/sin scaling
LONGROPE = dataclasses.replace(
    TINY_LLM,
    original_max_position_embeddings=16,
    max_position_embeddings=64,
    rope_short_factor=(1.0, 1.5, 2.0),
    rope_long_factor=(2.0, 3.0, 4.5),
)
# an untied LM head and q/k/v/o biases, without LoRA
UNTIED_BIAS = dataclasses.replace(
    TINY_LLM, tie_word_embeddings=False, attention_bias=True, lora=None
)
CONFIGS = {"phi4mini-toy": TINY_LLM, "longrope": LONGROPE,
           "untied-bias": UNTIED_BIAS}



@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


def _models(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (2, SEQ))
    jm = JaxLM(cfg, dtype=jnp.float32)
    params = fill_zero_inits(
        jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(ids)), seed
    )
    tm = load_flax(
        Phi3ForCausalLM(to_torch_config(cfg), dtype=torch.float32, device="cpu"),
        params,
    )
    # jitted: the interpret-mode Pallas kernel runs far faster compiled
    japply = jax.jit(jm.apply, static_argnames=("last_token_only",))
    return ids, japply, params, tm


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_forward_logits(name):
    ids, japply, params, tm = _models(CONFIGS[name])
    kv = np.asarray([SEQ, 52], np.int32)
    with jax_flash_always():
        want, _ = japply(params, jnp.asarray(ids), kv_lens=jnp.asarray(kv))
    got, _ = tm(torch.as_tensor(ids), kv_lens=torch.as_tensor(kv))
    valid = np.arange(SEQ)[None, :] < kv[:, None]  # padded rows are junk
    np.testing.assert_allclose(
        to_np(got)[valid], np.asarray(want)[valid], **TOL
    )


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_cached_decode(name):
    cfg = CONFIGS[name]
    ids, japply, params, tm = _models(cfg, seed=1)
    kv = np.asarray([61, SEQ], np.int32)
    capacity = SEQ + 3
    jcache = JaxCache.create(cfg, 2, capacity)
    tcache = KVCache.create(to_torch_config(cfg), 2, capacity, device="cpu")
    with jax_flash_always():
        want, jcache = japply(params, jnp.asarray(ids), kv_lens=jnp.asarray(kv),
                              cache=jcache, last_token_only=True)
        got, tcache = tm(torch.as_tensor(ids), kv_lens=torch.as_tensor(kv),
                         cache=tcache, last_token_only=True)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        rng = np.random.default_rng(2)
        for _ in range(3):
            token = rng.integers(3, cfg.vocab_size, (2, 1))
            want, jcache = japply(params, jnp.asarray(token), cache=jcache)
            got, tcache = tm(torch.as_tensor(token), cache=tcache)
            np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    # both sides round their f32 keys to bf16: where the two f32 values
    # straddle a rounding boundary they differ by one bf16 unit (2^-7
    # relative), and such a flip in one layer moves the next layer's keys
    # by up to ~1e-3 absolute
    np.testing.assert_allclose(
        to_np(tcache.k), np.asarray(jcache.k.astype(jnp.float32)),
        rtol=2.0 ** -7, atol=1e-3,
    )


# int8 weight-only projections and embedding, as the serving CLI's
# --quant-int8 configures the LLM (no LoRA)
QUANT = dataclasses.replace(TINY_LLM, lora=None, quant_int8=True,
                            quant_int8_embed=True)


def _quant_models(seed):
    """Float weights from the JAX init, quantised by the JAX package's
    converters, bridged into the port's int8 model."""
    from hsenet_tpu.models.lora import quantize_embed_int8, quantize_kernels_int8

    rng = np.random.default_rng(seed)
    ids = rng.integers(3, QUANT.vocab_size, (2, SEQ))
    float_cfg = dataclasses.replace(QUANT, quant_int8=False,
                                    quant_int8_embed=False)
    float_params = jax.tree.map(np.asarray, jax.jit(
        JaxLM(float_cfg, dtype=jnp.float32).init
    )(jax.random.PRNGKey(seed), jnp.asarray(ids)))
    params = quantize_embed_int8(quantize_kernels_int8(float_params))
    jm = JaxLM(QUANT, dtype=jnp.float32)
    tm = load_flax(
        Phi3ForCausalLM(to_torch_config(QUANT), dtype=torch.float32, device="cpu"),
        params,
    )
    japply = jax.jit(jm.apply, static_argnames=("last_token_only",))
    return ids, japply, params, tm


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_int8_weights_prefill_then_decode(cache_dtype):
    """`quant_int8` + `quant_int8_embed`: prefill logits (70 rows: the
    layer's expression) and 8 decode steps (2 rows: the matvec's function)
    against the JAX model, over a bf16 and an int8 KV cache. Logits 1e-4;
    the int8 cache's codes after prefill equal but for keys whose f32
    value lands within rounding noise of a half step (at most one unit, in
    under 1 code of 1000), scales 1e-5 relative."""
    ids, japply, params, tm = _quant_models(seed=3)
    assert {b.dtype for b in tm.buffers()} == {torch.int8, torch.float32}
    assert not any("proj.weight" in n or "embed.weight" in n
                   for n, _ in tm.named_parameters())
    kv = np.asarray([61, SEQ], np.int32)
    capacity = SEQ + 8
    jcache = JaxCache.create(QUANT, 2, capacity, dtype=getattr(jnp, cache_dtype))
    tcache = KVCache.create(to_torch_config(QUANT), 2, capacity,
                            dtype=getattr(torch, cache_dtype), device="cpu")
    assert tcache.quantized == (cache_dtype == "int8")
    with jax_flash_always(), torch.no_grad():
        want, jcache = japply(params, jnp.asarray(ids), kv_lens=jnp.asarray(kv),
                              cache=jcache, last_token_only=True)
        got, tcache = tm(torch.as_tensor(ids), kv_lens=torch.as_tensor(kv),
                         cache=tcache, last_token_only=True)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        if cache_dtype == "int8":
            assert tcache.k.dtype == torch.int8
            assert tcache.k_scale.shape == (QUANT.num_layers, 2,
                                            QUANT.num_kv_heads, capacity)
            for name in ("k", "v"):
                diff = np.abs(getattr(tcache, name).numpy().astype(np.int32)
                              - np.asarray(getattr(jcache, name)).astype(np.int32))
                assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, name
                np.testing.assert_allclose(
                    getattr(tcache, name + "_scale").numpy(),
                    np.asarray(getattr(jcache, name + "_scale")),
                    rtol=1e-5, atol=1e-9)
        rng = np.random.default_rng(4)
        for _ in range(8):
            token = rng.integers(3, QUANT.vocab_size, (2, 1))
            want, jcache = japply(params, jnp.asarray(token), cache=jcache)
            got, tcache = tm(torch.as_tensor(token), cache=tcache)
            np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))


def test_int8_cache_create():
    cfg = to_torch_config(TINY_LLM)
    c = KVCache.create(cfg, 3, 20, dtype=torch.int8, device="cpu")
    assert c.quantized and c.k.dtype == torch.int8 and c.v.dtype == torch.int8
    assert c.k_scale.shape == (cfg.num_layers, 3, cfg.num_kv_heads, 20)
    assert c.k_scale.dtype == torch.float32
    assert c.k_scale.data_ptr() != c.v_scale.data_ptr()
    b = KVCache.create(cfg, 3, 20, device="cpu")
    assert not b.quantized and b.k_scale is None and b.v_scale is None
