"""The port's VLM slice against the JAX package's, on the CPU in f32:
packer, splice, prefill logits and greedy tokens.

The JAX side runs with flash mode "always" and 70-token prompts so both
towers and the prefill go through the Pallas kernel (interpret mode).
Tolerance 1e-4 absolute and relative on f32 activations and logits; the
greedy tokens must be equal, token for token.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.attention as jattn
from hsenet_tpu.eval.generate import make_greedy_generate as jax_generate
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.mllm import splice_image_embeds as jax_splice
from hsenet_tpu.models.phi3 import KVCache as JaxCache
from hsenet_tpu.models.projector import VisualPacker as JaxPacker
from hsenet_torch.eval.generate import make_greedy_generate
from hsenet_torch.models.mllm import HSENetVLM, splice_image_embeds
from hsenet_torch.models.phi3 import KVCache
from hsenet_torch.models.projector import VisualPacker
from test_torch_common import (
    TINY_PACKER,
    TINY_VLM,
    fill_zero_inits,
    load_flax,
    to_np,
    to_torch_config,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 70


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


@pytest.fixture(scope="module")
def vlm():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, TINY_VLM.llm.vocab_size, (2, SEQ))
    ids[:, 0] = 1  # BOS
    ids[:, 1:1 + TINY_VLM.num_image_tokens] = 4  # image placeholders
    vol = rng.random((2, 1, 4, 16, 16), np.float32)
    sl = rng.standard_normal((2, 2, 16)).astype(np.float32)
    kv = np.asarray([SEQ, 57], np.int32)
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    params = fill_zero_inits(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(vol),
        jnp.asarray(sl)), 0)
    tm = load_flax(
        HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32, device="cpu"),
        params,
    )
    return dict(ids=ids, vol=vol, sl=sl, kv=kv, jm=jm, params=params, tm=tm)


def test_visual_packer():
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((2, 8, 16)).astype(np.float32)
    jm = JaxPacker(TINY_PACKER)
    params = fill_zero_inits(jm.init(jax.random.PRNGKey(3), jnp.asarray(tokens)), 3)
    want = jm.apply(params, jnp.asarray(tokens))
    tm = load_flax(
        VisualPacker(to_torch_config(TINY_PACKER), device="cpu"), params
    )
    got = tm(torch.as_tensor(tokens))
    assert got.shape == (2, TINY_PACKER.proj_out_num, TINY_PACKER.out_dim)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_splice_image_embeds():
    rng = np.random.default_rng(4)
    embeds = rng.standard_normal((2, 10, 4)).astype(np.float32)
    img = rng.standard_normal((2, 3, 4)).astype(np.float32)
    want = np.asarray(jax_splice(jnp.asarray(embeds), jnp.asarray(img)))
    got = splice_image_embeds(torch.as_tensor(embeds), torch.as_tensor(img))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_logits(vlm):
    jcache = JaxCache.create(TINY_VLM.llm, 2, SEQ + 4)
    with jax_flash_always():
        want, jcache = jax.jit(functools.partial(
            vlm["jm"].apply, method=JaxVLM.prefill
        ))(
            vlm["params"], jnp.asarray(vlm["ids"]), jnp.asarray(vlm["vol"]),
            jnp.asarray(vlm["sl"]), jcache, jnp.asarray(vlm["kv"]),
        )
    tcache = KVCache.create(to_torch_config(TINY_VLM.llm), 2, SEQ + 4,
                            device="cpu")
    with torch.inference_mode():
        got, tcache = vlm["tm"].prefill(
            torch.as_tensor(vlm["ids"]), torch.as_tensor(vlm["vol"]),
            torch.as_tensor(vlm["sl"]), tcache, torch.as_tensor(vlm["kv"]),
        )
    assert got.shape == (2, TINY_VLM.llm.vocab_size)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tcache.lengths.numpy(), vlm["kv"])


def test_greedy_tokens_equal_jax(vlm):
    args = [vlm["ids"], vlm["kv"], vlm["vol"], vlm["sl"]]
    # EOS is the first token row 0 emits after its first, so row 0
    # freezes to pad mid-way and row 1 runs on: both branches are covered
    with jax_flash_always():
        probe = np.asarray(jax_generate(
            vlm["jm"], max_new_tokens=8, eos_token_id=-1,
        )(vlm["params"], *map(jnp.asarray, args)))
        eos = int(probe[0, 2])
        want = np.asarray(jax_generate(
            vlm["jm"], max_new_tokens=8, eos_token_id=eos, pad_token_id=0,
        )(vlm["params"], *map(jnp.asarray, args)))
    got = make_greedy_generate(
        vlm["tm"], max_new_tokens=8, eos_token_id=eos, pad_token_id=0,
    )(*map(torch.as_tensor, args))
    assert got.shape == (2, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 3:] == 0).all()  # row 0 froze after its EOS


def _port_prefill(vlm, method, *args):
    cache = KVCache.create(to_torch_config(TINY_VLM.llm), 2, SEQ + 4,
                           device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        return getattr(vlm["tm"], method)(*args, cache, torch.as_tensor(vlm["kv"]))


def test_split_admission_equals_prefill(vlm):
    """The serving engine's split admission: `encode_images_only` +
    `prefill_with_features` computes what `prefill` computes (the same
    operations: equal to 1e-5 in f32), and both agree with the JAX
    package's methods to 1e-4."""
    ids, vol, sl = (torch.as_tensor(vlm[k]) for k in ("ids", "vol", "sl"))
    whole, _ = _port_prefill(vlm, "prefill", ids, vol, sl)
    with torch.inference_mode():
        feats = vlm["tm"].encode_images_only(vol, sl)
    assert feats.shape == (2, TINY_VLM.num_image_tokens, TINY_VLM.llm.hidden_size)
    split, cache = _port_prefill(vlm, "prefill_with_features", ids, feats)
    np.testing.assert_allclose(to_np(split), to_np(whole), atol=1e-5, rtol=1e-5)

    jm, params = vlm["jm"], vlm["params"]
    with jax_flash_always():
        jfeats = jax.jit(functools.partial(
            jm.apply, method=JaxVLM.encode_images_only
        ))(params, jnp.asarray(vlm["vol"]), jnp.asarray(vlm["sl"]))
        want, _ = jax.jit(functools.partial(
            jm.apply, method=JaxVLM.prefill_with_features
        ))(params, jnp.asarray(vlm["ids"]), jfeats,
           JaxCache.create(TINY_VLM.llm, 2, SEQ + 4, dtype=jnp.float32),
           jnp.asarray(vlm["kv"]))
    np.testing.assert_allclose(to_np(feats), np.asarray(jfeats), **TOL)
    np.testing.assert_allclose(to_np(split), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), vlm["kv"])


def test_prefill_continue_equals_full_prefill(vlm):
    """A question chunk prefilled over a cache that already holds the BOS +
    image-block keys and values (sliced out of a full prefill, as the
    engine's KV-prefix cache does) gives the full prefill's logits (1e-5)
    and cache, and the JAX package's `prefill_continue` logits (1e-4)."""
    n = 1 + TINY_VLM.num_image_tokens
    ids, vol, sl = (torch.as_tensor(vlm[k]) for k in ("ids", "vol", "sl"))
    whole, full = _port_prefill(vlm, "prefill", ids, vol, sl)
    cfg = to_torch_config(TINY_VLM.llm)
    cache = KVCache.create(cfg, 2, SEQ + 4, device="cpu", dtype=torch.float32)
    cache.k[:, :, :, :n] = full.k[:, :, :, :n]
    cache.v[:, :, :, :n] = full.v[:, :, :, :n]
    cache.lengths.fill_(n)
    q_len = vlm["kv"] - n
    with torch.inference_mode():
        got, cache = vlm["tm"].prefill_continue(
            ids[:, n:], cache, torch.as_tensor(q_len))
    np.testing.assert_allclose(to_np(got), to_np(whole), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(cache.lengths.numpy(), vlm["kv"])
    for row, valid in enumerate(vlm["kv"]):
        np.testing.assert_allclose(
            to_np(cache.k[:, row, :, :valid]), to_np(full.k[:, row, :, :valid]),
            atol=1e-5, rtol=1e-5)

    jm, params = vlm["jm"], vlm["params"]
    with jax_flash_always():
        _, jfull = jax.jit(functools.partial(jm.apply, method=JaxVLM.prefill))(
            params, jnp.asarray(vlm["ids"]), jnp.asarray(vlm["vol"]),
            jnp.asarray(vlm["sl"]),
            JaxCache.create(TINY_VLM.llm, 2, SEQ + 4, dtype=jnp.float32),
            jnp.asarray(vlm["kv"]))
        seeded = JaxCache.create(TINY_VLM.llm, 2, SEQ + 4, dtype=jnp.float32)
        seeded = seeded.replace(
            k=seeded.k.at[:, :, :, :n].set(jfull.k[:, :, :, :n]),
            v=seeded.v.at[:, :, :, :n].set(jfull.v[:, :, :, :n]),
            lengths=jnp.full((2,), n, jnp.int32))
        want, _ = jax.jit(functools.partial(
            jm.apply, method=JaxVLM.prefill_continue
        ))(params, jnp.asarray(vlm["ids"][:, n:]), seeded, jnp.asarray(q_len))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


TOP_P_LOGITS = {
    "random": np.random.default_rng(9).standard_normal((3, 50)).astype(np.float32) * 3,
    # ties at the cutoff: the kept prefix is cut by rank, not by value
    "ties": np.asarray([[2.0, 1.0, 1.0, 1.0, 1.0, 0.0, -1.0, 1.0],
                        [0.5] * 8,
                        [3.0, 3.0, 3.0, -2.0, -2.0, 0.0, 0.0, 0.0]], np.float32),
}


@pytest.mark.parametrize("top_p", [0.05, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("case", list(TOP_P_LOGITS))
def test_apply_top_p_matches_jax(case, top_p):
    from hsenet_tpu.eval.generate import apply_top_p as jax_top_p
    from hsenet_torch.eval.generate import apply_top_p

    logits = TOP_P_LOGITS[case]
    want = np.asarray(jax_top_p(jnp.asarray(logits), top_p))
    got = apply_top_p(torch.as_tensor(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))  # exact mask
    np.testing.assert_array_equal(got, want)
    assert (~np.isinf(got)).sum(axis=-1).min() >= 1


@pytest.mark.parametrize("temperature,top_p", [(0.7, None), (1.3, 0.8), (2.0, 1.0)])
def test_warp_logits_matches_jax(temperature, top_p):
    from hsenet_tpu.eval.generate import warp_logits as jax_warp
    from hsenet_torch.eval.generate import warp_logits

    logits = TOP_P_LOGITS["random"]
    want = np.asarray(jax_warp(jnp.asarray(logits), temperature, top_p))
    got = warp_logits(torch.as_tensor(logits), temperature, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)
