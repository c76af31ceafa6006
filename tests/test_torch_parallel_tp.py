"""Tensor parallelism of the port (`hsenet_torch.parallel`) over two gloo
ranks on the CPU, against the JAX package on a tp = 2 mesh of its virtual
CPU devices, in f32 at toy size (`test_torch_common.TINY_LLM`: 4 query and
2 key/value heads, LoRA rank 2, vocabulary 64; biases and LoRA B drawn).

The ranks run once for the whole file (`_torch_parallel_worker.py`); each
test reads its case. Logits hold to the JAX package's at 2e-5 and the
gradients of a masked-LM loss (every leaf, LoRA included, gathered from
the shards) at 5e-5, the JAX package's own tp tolerances
(`tests/test_sharding.py`). Greedy tokens, of the decoders and of the
serving engine (float and int8 caches), must be equal: both sides compute
the same f32 sums in another order. A decoder with one kv head, which does
not split over tp = 2, keeps its k / v projections and cache whole on both
ranks, as the JAX engine replicates its cache.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parallel_worker import spawn
from hsenet_tpu.configs import MeshConfig
from hsenet_tpu.eval.generate import make_greedy_generate_llm_only as jax_generate
from hsenet_tpu.models.lora import quantize_embed_int8, quantize_kernels_int8
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_tpu.parallel.mesh import create_mesh
from hsenet_tpu.parallel.sharding import shard_params
from hsenet_tpu.serving import ServingEngine as JaxEngine
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.cli import serve as tserve
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from test_torch_common import TINY_LLM, fill_zero_inits, load_flax, to_torch_config

torch.set_num_threads(1)

PROMPT, MAX_NEW = 6, 8
ENGINE_LLM = dataclasses.replace(TINY_LLM, vocab_size=96, tie_word_embeddings=False)
MQA_LLM = dataclasses.replace(ENGINE_LLM, num_kv_heads=1)
ENGINE_KW = dict(eos_token_id=2, pad_token_id=0, num_slots=2, prompt_cap=16,
                 max_new_tokens=12, chunk_size=4)
SERVE_ARGV = ["--synthetic", "--num-requests", "5", "--slots", "2", "--chunk",
              "4", "--max-new-tokens", "10"]


def _port(cfg, params):
    return load_flax(Phi3ForCausalLM(to_torch_config(cfg), dtype=torch.float32,
                                     device="cpu"), params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 64, (2, 12))
    labels = rng.integers(0, 64, (2, 12))
    kv = np.asarray([PROMPT, PROMPT - 2], np.int32)
    jm = JaxLM(TINY_LLM, dtype=jnp.float32)
    params = fill_zero_inits(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(ids))), 1)
    qparams = {"params": quantize_embed_int8(quantize_kernels_int8(
        params["params"]))}
    qcfg = dataclasses.replace(TINY_LLM, quant_int8=True, quant_int8_embed=True)
    bcfg = dataclasses.replace(TINY_LLM, attention_bias=True)
    bparams = fill_zero_inits(jax.tree.map(np.asarray, JaxLM(bcfg).init(
        jax.random.PRNGKey(2), jnp.asarray(ids))), 3)
    em = JaxLM(ENGINE_LLM, dtype=jnp.float32)
    prompts = [rng.integers(3, ENGINE_LLM.vocab_size, size=n) for n in (5, 9, 13)]
    eparams = fill_zero_inits(jax.tree.map(np.asarray, em.init(
        jax.random.PRNGKey(4), jnp.asarray(prompts[0][None]))), 5)
    mm = JaxLM(MQA_LLM, dtype=jnp.float32)
    mparams = fill_zero_inits(jax.tree.map(np.asarray, mm.init(
        jax.random.PRNGKey(6), jnp.asarray(ids))), 7)
    serve_out = root / "serve_tp2.jsonl"
    cases = [
        ("tp_lm", dict(model=_port(TINY_LLM, params),
                       qmodel=_port(qcfg, qparams),
                       bias_model=_port(bcfg, bparams), ids=ids, labels=labels,
                       kv_lens=kv, prompt=PROMPT, max_new=MAX_NEW)),
        ("tp_engine", dict(model=_port(ENGINE_LLM, eparams), prompts=prompts,
                           kwargs=ENGINE_KW)),
        ("tp_mqa", dict(model=_port(MQA_LLM, mparams), ids=ids, labels=labels,
                        prompts=prompts, kwargs=ENGINE_KW)),
        ("serve_cli", dict(argv=SERVE_ARGV + ["--tp", "2", "--output",
                                              str(serve_out)])),
    ]
    ranks = spawn(root, cases)

    # the JAX package on a tp = 2 mesh
    mesh = create_mesh(MeshConfig(dp=1, tp=2))
    ids_j = jnp.asarray(ids)

    def loss_fn(p):
        logits, _ = jm.apply(p, ids_j)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), jnp.asarray(labels)[:, 1:]).mean()

    sharded = shard_params(params, mesh)
    jax_ref = {
        "logits": np.asarray(jax.jit(lambda p: jm.apply(p, ids_j)[0])(sharded)),
        "grads": flax_to_torch(jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss_fn))(sharded))),
        "bias_logits": np.asarray(jax.jit(
            lambda p: JaxLM(bcfg, dtype=jnp.float32).apply(p, ids_j)[0])(shard_params(bparams, mesh))),
    }
    for key, (model, p) in (("model", (jm, sharded)),
                            ("qmodel", (JaxLM(qcfg, dtype=jnp.float32),
                                        shard_params(qparams, mesh)))):
        gen = jax_generate(model, max_new_tokens=MAX_NEW, eos_token_id=-1,
                           cache_dtype=jnp.float32)
        jax_ref[f"tokens_{key}"] = np.asarray(gen(p, ids_j[:, :PROMPT],
                                                  jnp.asarray(kv)))
    for name, dtype in (("float", jnp.float32), ("int8", jnp.int8)):
        eng = JaxEngine(em, eparams, mesh=mesh, cache_dtype=dtype, **ENGINE_KW)
        uids = [eng.submit(q) for q in prompts]
        res = eng.run_until_drained()
        jax_ref[f"engine_{name}"] = [res[u] for u in uids]

    msharded = shard_params(mparams, mesh)

    def mqa_loss(p):
        logits, _ = mm.apply(p, ids_j)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), jnp.asarray(labels)[:, 1:]).mean()

    jax_ref["mqa_logits"] = np.asarray(jax.jit(lambda p: mm.apply(p, ids_j)[0])(
        msharded))
    jax_ref["mqa_grads"] = flax_to_torch(jax.tree.map(
        np.asarray, jax.jit(jax.grad(mqa_loss))(msharded)))
    eng = JaxEngine(mm, mparams, mesh=mesh, cache_dtype=jnp.float32, **ENGINE_KW)
    uids = [eng.submit(q) for q in prompts]
    res = eng.run_until_drained()
    jax_ref["mqa_engine"] = [res[u] for u in uids]

    # the port's serve CLI in one process
    serve_ref = root / "serve_tp1.jsonl"
    tserve.main(SERVE_ARGV + ["--output", str(serve_ref)], device="cpu")
    return dict(ranks=ranks, jax=jax_ref, serve=(serve_out, serve_ref))


def test_tp_ranks_hold_local_heads(world):
    for r in world["ranks"]:
        assert r["tp_lm"]["heads"] == (2, 1)  # 4 / 2 query, 2 / 2 kv heads
        assert r["tp_engine"]["float_cache_heads"] == 1
        assert r["tp_engine"]["int8_cache_heads"] == 1


def test_tp_logits_match_jax(world):
    for r in world["ranks"]:  # every rank holds the whole vocabulary
        np.testing.assert_allclose(r["tp_lm"]["logits"].numpy(),
                                   world["jax"]["logits"], atol=2e-5, rtol=2e-5)


def test_tp_attention_bias_added_once(world):
    """Row-parallel biases after the all-reduce, column-parallel biases
    split with their outputs."""
    np.testing.assert_allclose(world["ranks"][0]["tp_lm"]["bias_logits"].numpy(),
                               world["jax"]["bias_logits"], atol=2e-5, rtol=2e-5)


def test_tp_lora_gradients_match_jax(world):
    got, want = world["ranks"][0]["tp_lm"]["grads"], world["jax"]["grads"]
    assert set(got) == set(want)
    assert any("lora_a" in k for k in got) and any("lora_b" in k for k in got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-5,
                                   rtol=5e-5, err_msg=name)
    for name, g in world["ranks"][1]["tp_lm"]["grads"].items():
        assert torch.equal(g, got[name]), name


@pytest.mark.parametrize("key", ["model", "qmodel"], ids=["float", "int8"])
def test_tp_decode_matches_jax(world, key):
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["tp_lm"][f"tokens_{key}"].numpy(),
                                      world["jax"][f"tokens_{key}"])


@pytest.mark.parametrize("cache", ["float", "int8"])
def test_tp_engine_tokens_match_jax(world, cache):
    for r in world["ranks"]:
        assert r["tp_engine"][cache] == world["jax"][f"engine_{cache}"]


def test_tp_replicates_kv_heads_that_do_not_split(world):
    """One kv head over tp = 2: the k / v projections and the cache stay
    whole on both ranks (each query head reads its kv head), and the logits,
    the gradients (the replicated k / v leaves' summed over tp) and the
    engine's tokens hold to the JAX package's."""
    want = world["jax"]
    for r in world["ranks"]:
        got = r["tp_mqa"]
        assert got["cache_heads"] == 1
        np.testing.assert_allclose(got["logits"].numpy(), want["mqa_logits"],
                                   atol=2e-5, rtol=2e-5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["mqa_grads"][name].numpy(),
                                       atol=5e-5, rtol=5e-5, err_msg=name)
        assert got["tokens"] == want["mqa_engine"]


def test_serve_cli_tp2_equals_tp1(world):
    tp2, tp1 = world["serve"]

    def rows(path):
        with open(path) as f:
            return {r["id"]: r["tokens"] for r in map(json.loads, f)}

    assert rows(tp2) == rows(tp1) and len(rows(tp1)) == 5
    summaries = [r["serve_cli"] for r in world["ranks"]]
    assert summaries[0]["tp"] == 2 and summaries[0]["tokens"] == summaries[1]["tokens"]
