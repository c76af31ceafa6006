"""The port's sampling against the JAX package's, on the CPU at toy size in
f32: the sampler's law beside `jax.random.categorical`, sampled and
dynamic-budget generation, speculative sampling's law, the sampling
serving engine (greedy and speculative) and the CLIs' `--do-sample`.

The port's random stream is its own (`fold_seed` over `torch.Generator`s),
so sampled tokens are held against JAX only where the law pins them: a
nucleus of one token (`top_p=1e-9`) must give the JAX package's greedy
tokens bit for bit, and frequencies over many draws must match the exact
law. Every generator is seeded, so nothing here is flaky.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.cli.evaluate as jeval
from hsenet_tpu.eval.generate import make_greedy_generate as jax_generate
from hsenet_tpu.eval.generate import make_greedy_generate_llm_only as jax_generate_llm
from hsenet_tpu.eval.generate import warp_logits as jax_warp
from hsenet_tpu.eval.speculative import pld_round as jax_pld_round
from hsenet_tpu.models.phi3 import KVCache as JaxKVCache
from hsenet_tpu.serving import ServingEngine as JaxEngine
from hsenet_torch.cli import evaluate as teval
from hsenet_torch.cli import serve as tserve
from hsenet_torch.eval.generate import (
    _make_next_token,
    categorical,
    fold_seed,
    make_greedy_generate,
    make_greedy_generate_llm_only,
    seeded_generator,
    warp_logits,
)
from hsenet_torch.eval.speculative import pld_round
from hsenet_torch.models.phi3 import KVCache
from hsenet_torch.serving import ServingEngine
from test_torch_common import TINY_LLM, to_torch_config
from test_torch_serving import (  # noqa: F401  (module-scoped fixtures)
    CLI_SMALL,
    LLM_KW,
    PAD,
    VLM_KW,
    _drain_vlm,
    llm,
    vlm,
)

torch.set_num_threads(1)

MAX_NEW = 8
HOT = 10.0  # a temperature at which every token of the toy vocab is drawn
COLLAPSE = 1e-9  # a nucleus of one token: the argmax


def test_fold_seed_is_a_fixed_mix():
    assert fold_seed(7, 3) == fold_seed(7, 3)
    seeds = {fold_seed(s, i) for s in range(4) for i in range(64)}
    assert len(seeds) == 4 * 64
    assert fold_seed(7, 1, 2) == fold_seed(fold_seed(7, 1), 2) != fold_seed(7, 2, 1)
    assert all(0 <= s < 2 ** 64 for s in seeds)


@pytest.mark.parametrize("top_p", [0.9, None], ids=["nucleus", "full"])
def test_sampler_law_beside_jax_categorical(top_p):
    """20,000 draws of the port's sampler (over folded seeds) and 20,000 of
    `jax.random.categorical` on the JAX `warp_logits`, at V = 16, T 0.7:
    both within 0.02 of the exact law of each token, nothing outside the
    nucleus. The two warps are the same function."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(16) * 2).astype(np.float32)
    t = 0.7
    wl = np.asarray(jax_warp(jnp.asarray(logits), t, top_p))
    np.testing.assert_array_equal(
        warp_logits(torch.as_tensor(logits), t, top_p).numpy(), wl)
    law = np.asarray(jax.nn.softmax(jnp.asarray(wl)))
    outside = ~np.isfinite(wl)
    assert outside.any() == (top_p is not None)

    n, rows = 20_000, 1000
    sample = _make_next_token(True, t, top_p)
    batch = torch.as_tensor(logits).expand(rows, -1)
    port = torch.cat([sample(batch, fold_seed(5, i)) for i in range(n // rows)])
    ref = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), jnp.broadcast_to(jnp.asarray(wl), (n, 16))))
    for draws in (port.numpy(), ref):
        freq = np.bincount(draws, minlength=16) / n
        assert freq[outside].sum() == 0
        np.testing.assert_allclose(freq, law, atol=0.02)
    # one seed, one draw; a -inf logit is never drawn
    assert torch.equal(sample(batch, 11), sample(batch, 11))
    masked = torch.full((rows, 16), -torch.inf)
    masked[:, 3] = 0.0
    assert (categorical(masked, seeded_generator(2, "cpu")) == 3).all()


def test_temperature_must_be_positive():
    for t in (0.0, -1.0):
        with pytest.raises(ValueError, match="temperature must be > 0"):
            make_greedy_generate_llm_only(None, max_new_tokens=2, eos_token_id=2,
                                          do_sample=True, temperature=t)


@pytest.fixture(scope="module")
def lm_batch(llm):
    rng = np.random.default_rng(4)
    ids = rng.integers(3, llm["tm"].config.vocab_size, (2, 10)).astype(np.int32)
    kv = np.asarray([10, 7], np.int32)
    return ids, kv


def _port_args(ids, kv):
    return torch.as_tensor(ids), torch.as_tensor(kv)


def test_sampled_generate_llm_only(llm, lm_batch):
    """A port of tests/test_eval.py's sampling test for the bare LM: a one-
    token nucleus equals the JAX greedy tokens; one seed reproduces, another
    differs at T 10; rng= is required."""
    ids, kv = lm_batch
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=-1, pad_token_id=PAD)
    want = np.asarray(jax_generate_llm(llm["jm"], cache_dtype=jnp.float32, **kw)(
        llm["params"], jnp.asarray(ids), jnp.asarray(kv)))
    collapse = make_greedy_generate_llm_only(
        llm["tm"], do_sample=True, top_p=COLLAPSE, cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(collapse(*_port_args(ids, kv), rng=1).numpy(), want)
    hot = make_greedy_generate_llm_only(
        llm["tm"], do_sample=True, temperature=HOT, cache_dtype=torch.float32, **kw)
    a, b, c = (hot(*_port_args(ids, kv), rng=s).numpy() for s in (2, 2, 3))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and (a != want).any()
    assert ((0 <= a) & (a < llm["tm"].config.vocab_size)).all()
    with pytest.raises(ValueError, match="requires rng="):
        hot(*_port_args(ids, kv))


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "collapse"])
def test_dynamic_steps_equal_jax(llm, lm_batch, sample):
    """`dynamic_steps=True` at budgets 1, 3 and 8 and above max_new_tokens
    (clamped) gives the JAX package's tokens, pad past the budget."""
    ids, kv = lm_batch
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=-1, pad_token_id=PAD,
              dynamic_steps=True)
    jgen = jax_generate_llm(llm["jm"], cache_dtype=jnp.float32, **kw)
    tgen = make_greedy_generate_llm_only(
        llm["tm"], cache_dtype=torch.float32, do_sample=sample, top_p=COLLAPSE,
        **kw)
    for budget in (1, 3, 8, 11):
        want = np.asarray(jgen(llm["params"], jnp.asarray(ids), jnp.asarray(kv),
                               jnp.int32(budget)))
        got = tgen(*_port_args(ids, kv), budget, rng=5 if sample else None)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want[:, min(budget, MAX_NEW):] == PAD).all()


def test_sampled_generate_vlm(vlm):
    """`make_greedy_generate(do_sample=True)` on the VLM: a one-token
    nucleus equals the JAX VLM's greedy tokens; seeds reproduce and part."""
    (p0, v0), (p1, v1) = vlm["traffic"][:2]
    n = max(len(p0), len(p1))
    ids = np.zeros((2, n), np.int32)
    ids[0, :len(p0)], ids[1, :len(p1)] = p0, p1
    kv = np.asarray([len(p0), len(p1)], np.int32)
    vol = np.concatenate([vlm["volumes"][v0], vlm["volumes"][v1]])
    sl = np.concatenate([vlm["slices"][v0], vlm["slices"][v1]])
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=-1, pad_token_id=PAD)
    want = np.asarray(jax_generate(vlm["jm"], cache_dtype=jnp.float32, **kw)(
        vlm["params"], *map(jnp.asarray, (ids, kv, vol, sl))))
    args = tuple(map(torch.as_tensor, (ids, kv, vol, sl)))
    collapse = make_greedy_generate(vlm["tm"], do_sample=True, top_p=COLLAPSE,
                                    cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(collapse(*args, rng=0).numpy(), want)
    hot = make_greedy_generate(vlm["tm"], do_sample=True, temperature=HOT,
                               cache_dtype=torch.float32, **kw)
    a, b, c = (hot(*args, rng=s).numpy() for s in (4, 4, 6))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and (a != want).any()
    with pytest.raises(ValueError, match="requires rng="):
        hot(*args)


def test_pld_round_sampling_law():
    """The port of tests/test_serving.py's constant-logit test: whatever
    the n-gram drafter proposes, every token `pld_round(sample=...)`
    commits, with each round's correction token, is distributed as
    softmax(logits / T) within 0.03, over ~3k draws. Beside it the JAX
    round's own frequencies on the same drafts."""
    vocab, k, b, temperature = 8, 4, 8, 1.3
    base = np.linspace(0.0, 2.0, vocab).astype(np.float32)
    target = np.exp(base / temperature) / np.exp(base / temperature).sum()
    cfg = TINY_LLM.__class__(vocab_size=vocab, hidden_size=8, intermediate_size=8,
                             num_layers=1, num_heads=1, num_kv_heads=1, head_dim=8)
    tcfg = to_torch_config(cfg)
    ctx_cap = 64
    kw = dict(draft_len=k, ngram=2, eos_token_id=-1, pad_token_id=0)

    def tverify(tokens, cache):
        return torch.as_tensor(base).expand(*tokens.shape, vocab), cache

    def jverify(tokens, cache):
        return jnp.broadcast_to(jnp.asarray(base), tokens.shape + (vocab,)), cache

    jstep = jax.jit(lambda pend, ctx, key: jax_pld_round(
        jverify, pend, JaxKVCache.create(cfg, b, ctx_cap, dtype=jnp.float32).replace(
            lengths=jnp.full((b,), 8, jnp.int32)),
        ctx, jnp.full((b,), 9, jnp.int32), jnp.zeros((b,), bool),
        jnp.zeros((b,), jnp.int32), jnp.full((b,), 100, jnp.int32),
        sample=(key, temperature, None), **kw))
    rng = np.random.default_rng(0)
    counts = {"port": np.zeros(vocab, np.int64), "jax": np.zeros(vocab, np.int64)}
    key = jax.random.PRNGKey(42)
    for trial in range(200):
        ctx = rng.integers(0, vocab, (b, ctx_cap)).astype(np.int32)
        # the seed pending token is itself a draw from the target
        pending = rng.choice(vocab, size=b, p=target).astype(np.int32)
        cache = KVCache.create(tcfg, b, ctx_cap, dtype=torch.float32, device="cpu")
        cache.lengths.fill_(8)
        out = pld_round(
            tverify, torch.as_tensor(pending), cache, torch.as_tensor(ctx),
            torch.full((b,), 9, dtype=torch.int32), torch.zeros(b, dtype=torch.bool),
            torch.zeros(b, dtype=torch.int32), torch.full((b,), 100, dtype=torch.int32),
            sample=(fold_seed(42, trial), temperature, None), **kw)
        key, sub = jax.random.split(key)
        jout = jstep(jnp.asarray(pending), jnp.asarray(ctx), sub)
        for name, (nxt, inputs, commit) in (
                ("port", (out[0].numpy(), out[6].numpy(), out[7].numpy())),
                ("jax", tuple(np.asarray(jout[i]) for i in (0, 6, 7)))):
            for r in range(b):
                np.add.at(counts[name], inputs[r, :commit[r]], 1)
                counts[name][nxt[r]] += 1  # the round's correction token
    for name, c in counts.items():
        assert c.sum() > 2000, (name, c.sum())
        np.testing.assert_allclose(c / c.sum(), target, atol=0.03, err_msg=name)


def test_pld_round_residual_masks_the_rejected_draft():
    """A target whose mass sits on two tokens, drafts always the first:
    after a rejection the correction token must be the second (the
    residual masks the rejected draft), never the draft itself."""
    vocab, k, b = 4, 2, 64
    logits = torch.tensor([5.0, 5.0, -30.0, -30.0])
    tcfg = to_torch_config(TINY_LLM.__class__(
        vocab_size=vocab, hidden_size=8, intermediate_size=8, num_layers=1,
        num_heads=1, num_kv_heads=1, head_dim=8))
    cache = KVCache.create(tcfg, b, 32, dtype=torch.float32, device="cpu")
    ctx = torch.zeros((b, 32), dtype=torch.int32)  # every n-gram drafts 0
    out = pld_round(
        lambda t, c: (logits.expand(*t.shape, vocab), c),
        torch.zeros(b, dtype=torch.int32), cache, ctx,
        torch.full((b,), 6, dtype=torch.int32), torch.zeros(b, dtype=torch.bool),
        torch.zeros(b, dtype=torch.int32), torch.full((b,), 100, dtype=torch.int32),
        draft_len=k, ngram=2, eos_token_id=-1, pad_token_id=0,
        sample=(3, 1.0, None))
    nxt, inputs, commit = out[0], out[6], out[7]
    rejected = commit < k + 1
    assert rejected.any() and (~rejected).any()
    assert (nxt[rejected] == 1).all()
    assert (inputs[:, 1:] == 0).all()


def _engine_runs(model, params, tm, prompts, cfg_kw, **spec):
    """Greedy JAX engine tokens, and the port's engine with a one-token
    nucleus, hot seeds 2, 2 and 3 (the ports of tests/test_serving.py's
    sampling tests)."""
    jeng = JaxEngine(model, params, eos_token_id=2, cache_dtype=jnp.float32,
                     **cfg_kw, **spec)
    uids = [jeng.submit(p) for p in prompts]
    res = jeng.run_until_drained()
    greedy = [res[u] for u in uids]

    def run(**extra):
        eng = ServingEngine(tm, eos_token_id=2, cache_dtype=torch.float32,
                            device="cpu", **cfg_kw, **spec, **extra)
        uids = [eng.submit(p) for p in prompts]
        res = eng.run_until_drained()
        return [res[u] for u in uids]

    return greedy, run


@pytest.mark.parametrize("spec", [{}, dict(speculative=True, draft_len=4)],
                         ids=["greedy-engine", "speculative"])
def test_sampling_engine(llm, spec):
    """A one-token nucleus equals the JAX engine's greedy tokens, request
    for request (plain and speculative sampling); hot sampling reproduces
    for one seed and submission order and parts for another; every token
    lies in the vocabulary; do_sample without rng= raises."""
    kw = dict(LLM_KW, chunk_size=3 if spec else 4)
    greedy, run = _engine_runs(llm["jm"], llm["params"], llm["tm"],
                               llm["prompts"][:3], kw, **spec)
    assert run(do_sample=True, top_p=COLLAPSE, rng=1) == greedy
    hot_a, hot_b, hot_c = (run(do_sample=True, temperature=HOT, rng=s)
                           for s in (2, 2, 3))
    assert hot_a == hot_b
    assert hot_a != hot_c and hot_a != greedy
    assert all(0 <= t < llm["tm"].config.vocab_size for row in hot_a for t in row)
    assert all(len(row) <= LLM_KW["max_new_tokens"] for row in hot_a)
    with pytest.raises(ValueError, match="requires rng="):
        ServingEngine(llm["tm"], eos_token_id=2, device="cpu", do_sample=True,
                      **kw, **spec)


def test_sampling_engine_multimodal_collapse(vlm):
    """The multimodal engine with caches, speculative sampling at a one-
    token nucleus: the JAX greedy speculative engine's tokens."""
    spec = dict(speculative=True, draft_len=3, volume_cache_size=2,
                kv_prefix_cache_size=2)
    jeng = JaxEngine(vlm["jm"], vlm["params"], eos_token_id=2,
                     cache_dtype=jnp.float32, **VLM_KW, **spec)
    teng = ServingEngine(vlm["tm"], eos_token_id=2, cache_dtype=torch.float32,
                         device="cpu", do_sample=True, top_p=COLLAPSE, rng=9,
                         **VLM_KW, **spec)
    assert _drain_vlm(teng, vlm) == _drain_vlm(jeng, vlm)


@pytest.mark.parametrize("spec", [[], ["--speculative"]], ids=["plain", "speculative"])
def test_cli_serve_do_sample(capsys, spec):
    argv = ["--synthetic", "--llm-only", "--prompt-cap", "32", "--do-sample",
            "--temperature", "0.7", "--top-p", "0.9", "--gen-seed", "3",
            *spec, *CLI_SMALL]
    a = tserve.main(argv, device="cpu")
    assert a["requests"] == 5 and 4 * 5 <= a["tokens"] <= 10 * 5
    b = tserve.main(argv, device="cpu")
    assert a["tokens"] == b["tokens"]
    if spec:
        assert a["mean_committed_per_round"] >= 1.0


def test_cli_evaluate_do_sample(capsys):
    m = teval.main(["--task", "mrg", "--synthetic", "--do-sample",
                    "--temperature", "0.8", "--top-p", "0.9", "--gen-seed", "1",
                    "--max-samples", "2"], device="cpu")
    assert m["num_samples"] >= 1 and "bleu1" in m and "rouge_l" in m


@pytest.mark.parametrize("flag,message", [
    ("--engine", "--engine eval is greedy-only"),
    ("--spec-decode", "--spec-decode is greedy-only"),
])
def test_cli_evaluate_refuses_sampling_routes_as_jax(flag, message):
    """`--do-sample` with `--engine` or `--spec-decode` is refused as the
    JAX CLI refuses it: an AssertionError with its message."""
    argv = ["--task", "mrg", "--synthetic", "--do-sample", flag]
    with pytest.raises(AssertionError, match=message):
        jeval.main(argv)
    with pytest.raises(AssertionError, match=message):
        teval.main(argv, device="cpu")
