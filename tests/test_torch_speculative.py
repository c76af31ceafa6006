"""The port's prompt-lookup speculative decoding against the JAX package's,
on the CPU at toy size in f32: the mock-model rounds of
tests/test_speculative.py, the LLM-only and VLM generators against the JAX
generators and against greedy decoding, the serving engine with
`speculative=True` against the JAX engine (float and int8 KV cache), and
the serving CLI's `--speculative`.

Tokens must be equal, token for token, and so must the number of verify
rounds and the committed-token counts: both sides run the same f32
arithmetic on tiny models, and an argmax flips only at a near-tie of two
logits, which these seeds do not hit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsenet_tpu.eval.speculative import _pld_decode_loop as jax_pld_loop
from hsenet_tpu.eval.speculative import make_pld_generate as jax_pld_vlm
from hsenet_tpu.eval.speculative import make_pld_generate_llm_only as jax_pld_llm
from hsenet_tpu.models.phi3 import KVCache as JaxKVCache
from hsenet_tpu.serving import ServingEngine as JaxEngine
from hsenet_torch.cli import serve as tserve
from hsenet_torch.eval.generate import (
    make_greedy_generate,
    make_greedy_generate_llm_only,
)
from hsenet_torch.eval.speculative import (
    _pld_decode_loop,
    make_pld_generate,
    make_pld_generate_llm_only,
    pld_round,
)
from hsenet_torch.models.phi3 import KVCache
from hsenet_torch.serving import ServingEngine
from test_torch_common import to_torch_config
from test_torch_serving import (  # noqa: F401  (module-scoped fixtures)
    CACHES,
    LLM,
    LLM_KW,
    PAD,
    VLM_KW,
    _drain_vlm,
    llm,
    vlm,
)

torch.set_num_threads(1)

MAX_NEW = 16
MOCK_VOCAB = 8


def _mock_verify_jax(period):
    def verify(tokens, c):
        return jax.nn.one_hot((tokens + 1) % period, MOCK_VOCAB), c
    return verify


def _mock_verify_torch(period):
    def verify(tokens, c):
        nxt = ((tokens.long() + 1) % period)
        return torch.nn.functional.one_hot(nxt, MOCK_VOCAB).float(), c
    return verify


@pytest.mark.parametrize(
    "prompt,pending,eos,max_new,period,expect",
    [([0, 1, 2, 3], 4, 100, 20, 7, [(4 + i) % 7 for i in range(20)]),
     ([2, 3, 4, 5, 6, 2, 3], 4, 5, 10, 7, [4, 5] + [0] * 8),
     ([0, 1, 2, 0, 1, 2, 0, 1], 2, 100, 3, 3, [2, 0, 1])],
    ids=["cyclic", "eos-inside-window", "budget-cut"],
)
def test_mock_rounds_match_jax(prompt, pending, eos, max_new, period, expect):
    """A mock model whose greedy continuation is (t + 1) % period: drafting,
    acceptance, the EOS and budget cuts, the context append and the output
    writes, without a transformer."""
    draft_len = 4
    plen = len(prompt)
    cfg = LLM
    jcache = JaxKVCache.create(cfg, 1, plen + max_new + draft_len + 1,
                               dtype=jnp.float32)
    jcache = jcache.replace(lengths=jnp.full((1,), plen, jnp.int32))
    jtok, (jrounds, jemitted) = jax_pld_loop(
        _mock_verify_jax(period), jnp.asarray([pending], jnp.int32), jcache,
        jnp.asarray([prompt], jnp.int32), jnp.full((1,), plen, jnp.int32),
        max_new_tokens=max_new, eos_token_id=eos, pad_token_id=0,
        draft_len=draft_len, ngram=2, collect_stats=True)
    tcache = KVCache.create(to_torch_config(cfg), 1,
                            plen + max_new + draft_len + 1,
                            dtype=torch.float32, device="cpu")
    tcache.lengths.fill_(plen)
    tok, rounds, emitted = _pld_decode_loop(
        _mock_verify_torch(period), torch.tensor([pending], dtype=torch.int32),
        tcache, torch.tensor([prompt]), torch.tensor([plen]),
        max_new_tokens=max_new, eos_token_id=eos, pad_token_id=0,
        draft_len=draft_len, ngram=2)
    assert tok[0].tolist() == expect == np.asarray(jtok[0]).tolist()
    assert rounds == int(jrounds) and emitted.tolist() == np.asarray(jemitted).tolist()
    if period == 7 and eos == 100:
        assert rounds <= 10  # the cycle compresses 20 greedy steps


def test_speculative_sampling_waits_for_its_slice():
    with pytest.raises(NotImplementedError, match="sampling"):
        pld_round(None, None, None, None, None, None, None, None, draft_len=2,
                  ngram=2, eos_token_id=2, pad_token_id=0, sample=(0, 1.0, None))


def _repetitive_prompts(rng, vocab):
    """A ragged batch with strong n-gram structure (a repeated phrase), the
    regime prompt lookup targets, beside a random prompt."""
    phrase = rng.integers(3, vocab, size=5)
    rep = np.concatenate([phrase, phrase, phrase[:3]])
    rand = rng.integers(3, vocab, size=len(rep))
    return np.stack([rep, rand]), np.array([len(rep), len(rep) - 4])


@pytest.mark.parametrize("draft_len,ngram", [(4, 2), (7, 3)])
@pytest.mark.parametrize("cache", list(CACHES))
def test_llm_only_generate_equals_jax_and_greedy(llm, cache, draft_len, ngram):
    jdtype, tdtype = CACHES[cache]
    ids, lens = _repetitive_prompts(np.random.default_rng(draft_len), LLM.vocab_size)
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=2, pad_token_id=PAD,
              draft_len=draft_len, ngram=ngram)
    want, jrounds, jemitted = jax_pld_llm(
        llm["jm"], cache_dtype=jdtype, collect_stats=True, **kw)(
            llm["params"], jnp.asarray(ids), jnp.asarray(lens, jnp.int32))
    got, rounds, emitted = make_pld_generate_llm_only(
        llm["tm"], cache_dtype=tdtype, collect_stats=True, **kw)(
            torch.as_tensor(ids), torch.as_tensor(lens))
    greedy = make_greedy_generate_llm_only(
        llm["tm"], max_new_tokens=MAX_NEW, eos_token_id=2, pad_token_id=PAD,
        cache_dtype=tdtype)(torch.as_tensor(ids), torch.as_tensor(lens))
    assert got.dtype == torch.int32 and got.shape == (2, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    assert rounds == int(jrounds)
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(jemitted))
    # a per-call budget
    short = make_pld_generate_llm_only(llm["tm"], cache_dtype=tdtype, **kw)(
        torch.as_tensor(ids), torch.as_tensor(lens), num_tokens=5)
    np.testing.assert_array_equal(short[:, :5].numpy(), greedy[:, :5].numpy())
    assert bool((short[:, 5:] == PAD).all())


def test_vlm_generate_equals_jax_and_greedy(vlm):
    (p0, v0), (p1, v1) = vlm["traffic"][:2]
    width = max(len(p0), len(p1))
    ids = np.zeros((2, width), np.int64)
    ids[0, :len(p0)], ids[1, :len(p1)] = p0, p1
    lens = np.array([len(p0), len(p1)])
    vols = np.concatenate([vlm["volumes"][v0], vlm["volumes"][v1]])
    sls = np.concatenate([vlm["slices"][v0], vlm["slices"][v1]])
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=2, pad_token_id=PAD,
              draft_len=4, ngram=2)
    want = jax_pld_vlm(vlm["jm"], cache_dtype=jnp.float32, **kw)(
        vlm["params"], jnp.asarray(ids), jnp.asarray(lens, jnp.int32),
        jnp.asarray(vols), jnp.asarray(sls))
    args = (torch.as_tensor(ids), torch.as_tensor(lens), torch.as_tensor(vols),
            torch.as_tensor(sls))
    got = make_pld_generate(vlm["tm"], cache_dtype=torch.float32, **kw)(*args)
    greedy = make_greedy_generate(
        vlm["tm"], max_new_tokens=MAX_NEW, eos_token_id=2, pad_token_id=PAD,
        cache_dtype=torch.float32)(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())


SPEC = dict(speculative=True, draft_len=3, ngram=2)


@pytest.mark.parametrize("cache", list(CACHES))
def test_engine_equals_jax_engine_llm_only(llm, cache):
    """Five requests with their own budgets through two slots: tokens,
    verify rounds and committed tokens equal the JAX engine's, and the
    tokens equal the greedy engine's."""
    jdtype, tdtype = CACHES[cache]
    budgets = [12, 9, 5, 12, 7]
    jeng = JaxEngine(llm["jm"], llm["params"], eos_token_id=2,
                     cache_dtype=jdtype, **LLM_KW, **SPEC)
    teng = ServingEngine(llm["tm"], eos_token_id=2, cache_dtype=tdtype,
                         device="cpu", **LLM_KW, **SPEC)
    plain = ServingEngine(llm["tm"], eos_token_id=2, cache_dtype=tdtype,
                          device="cpu", **LLM_KW)
    results = []
    for eng in (jeng, teng, plain):
        uids = [eng.submit(p, b) for p, b in zip(llm["prompts"], budgets)]
        out = eng.run_until_drained()
        results.append([out[u] for u in uids])
    want, got, greedy = results
    assert got == want == greedy
    assert teng.capacity == 16 + 12 + 2 * 4
    assert teng.verify_rounds_used == jeng.verify_rounds_used > 0
    assert teng.tokens_committed == jeng.tokens_committed == sum(map(len, got))
    assert teng.mean_accepted == pytest.approx(jeng.mean_accepted)
    assert teng.steps_run == jeng.steps_run
    np.testing.assert_array_equal(teng._cache.lengths.numpy(),
                                  np.asarray(jeng._cache.lengths))


@pytest.mark.parametrize("cache", list(CACHES))
def test_engine_equals_jax_engine_multimodal(vlm, cache):
    """The VLM engine with both admission caches on: each admission seeds
    the slot's context with the whole prompt, whichever cache served it."""
    jdtype, tdtype = CACHES[cache]
    lru = dict(volume_cache_size=2, kv_prefix_cache_size=2)
    jeng = JaxEngine(vlm["jm"], vlm["params"], eos_token_id=2,
                     cache_dtype=jdtype, **VLM_KW, **lru, **SPEC)
    teng = ServingEngine(vlm["tm"], eos_token_id=2, cache_dtype=tdtype,
                         device="cpu", **VLM_KW, **lru, **SPEC)
    want, got = _drain_vlm(jeng, vlm), _drain_vlm(teng, vlm)
    assert got == want
    assert teng.mean_accepted == pytest.approx(jeng.mean_accepted)
    assert (teng.prefix_misses, teng.prefix_hits) == (2, 3)


def test_engine_speculative_sampling_raises(llm):
    with pytest.raises(NotImplementedError, match="sampling"):
        ServingEngine(llm["tm"], eos_token_id=2, device="cpu", do_sample=True,
                      **SPEC)


@pytest.mark.parametrize("llm_only", [True, False], ids=["llm-only", "vlm"])
def test_cli_speculative(capsys, llm_only):
    flags = ["--synthetic", "--speculative", "--draft-len", "3", "--num-requests",
             "4", "--slots", "2", "--chunk", "4", "--max-new-tokens", "8"]
    flags += ["--llm-only", "--prompt-cap", "32"] if llm_only else [
        "--prompt-cap", "80", "--distinct-volumes", "2", "--kv-prefix-cache", "2"]
    summary = tserve.main(flags, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and summary["requests"] == 4
    assert 1.0 <= summary["mean_committed_per_round"] <= 4.0
    assert 4 * 4 <= summary["tokens"] <= 8 * 4
