"""The port's model variants against the JAX package's, on the CPU at toy
size in f32: the Llama decoder (configuration, HF converter, logits, the
`convert_checkpoint --kind llama` CLI, the serving engine over it, a VLM
with a Llama backbone), the four ablation projectors alone and QFormer and
Med2E3 inside the VLM (tower_mode 'med2e3'), with the engine serving it.

The JAX side runs flash mode "always", so QFormer's and the prefills'
attention go through the Pallas kernel in interpret mode. Tolerances: 1e-5
on the projectors and the decoder's logits, 2e-5 where QFormer's
attention runs through flash, 1e-4 on a VLM's logits (the tower, packer
and LLM stacked); greedy tokens equal, token for token.
"""

import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.ops.attention as jattn
from hsenet_tpu.eval.generate import make_greedy_generate as jax_generate
from hsenet_tpu.models import projector as jproj
from hsenet_tpu.models.llama import LlamaForCausalLM as JaxLlama
from hsenet_tpu.models.llama import convert_hf_llama as jax_convert_llama
from hsenet_tpu.models.llama import llama_as_phi3_config as jax_as_phi3
from hsenet_tpu.models.lora import quantize_embed_int8, quantize_kernels_int8
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import KVCache as JaxCache
from hsenet_tpu.serving import ServingEngine as JaxEngine
from hsenet_tpu.utils.export_hf import export_hf_llama, to_torch_state_dict
from hsenet_torch.cli import convert_checkpoint as tconvert_cli
from hsenet_torch.cli.common import restore_checkpoint
from hsenet_torch.eval.generate import make_greedy_generate
from hsenet_torch.models import projector as tproj
from hsenet_torch.models.llama import (
    LlamaForCausalLM,
    convert_hf_llama,
    llama_as_phi3_config,
)
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import KVCache
from hsenet_torch.serving import ServingEngine
from test_torch_checkpoint import assert_same_state, bridged
from test_torch_common import (
    TINY_VLM,
    fill_zero_inits,
    load_flax,
    to_np,
    to_torch_config,
)

torch.set_num_threads(1)

LLAMA = jcfg.LlamaConfig(
    vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=10000.0,
    tie_word_embeddings=False,
)
PACKER = jcfg.PackerConfig(grid=(4, 4, 4), kernel=(1, 2, 2), in_dim=16,
                           out_dim=24, dropout_rate=0.0)
TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)
VLM_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_NEW = 8
ENGINE_KW = dict(pad_token_id=0, num_slots=2, max_new_tokens=MAX_NEW,
                 chunk_size=4)


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


@pytest.fixture(scope="module")
def llama():
    """The JAX Llama at toy size (params drawn, no zero leaves), its HF
    export as the seeded HF-layout dict, and the port's model converted
    from that dict."""
    rng = np.random.default_rng(0)
    ids = rng.integers(3, LLAMA.vocab_size, (2, 12)).astype(np.int32)
    jm = JaxLlama(LLAMA, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids)))
    params = jax.tree.map(
        lambda x: (x + rng.normal(0, 0.05, x.shape)).astype(np.float32), params)
    sd = to_torch_state_dict(export_hf_llama(params, LLAMA))
    tm = LlamaForCausalLM(to_torch_config(LLAMA), dtype=torch.float32,
                          device="cpu")
    tm.load_state_dict(convert_hf_llama(sd, to_torch_config(LLAMA)), strict=True)
    return dict(ids=ids, jm=jm, params=params, sd=sd, tm=tm.eval())


def test_llama_configs_agree():
    t = to_torch_config(LLAMA)
    assert dataclasses.asdict(t) == dataclasses.asdict(LLAMA)
    want = dataclasses.asdict(jax_as_phi3(LLAMA))
    got = dataclasses.asdict(llama_as_phi3_config(t))
    assert got == want  # remat_policy included since the port has it
    phi = llama_as_phi3_config(t)
    assert (phi.rotary_dim, phi.attention_bias, phi.rope_short_factor) == (8, False, None)


def test_convert_hf_llama_equals_jax(llama):
    """Key for key and bit for bit against the JAX converter through the
    bridge; the tensors are the dict's own, not copies."""
    got = convert_hf_llama(llama["sd"], to_torch_config(LLAMA))
    assert_same_state(got, bridged(jax_convert_llama(llama["sd"], LLAMA)))
    assert got["decoder.layers.1.q_proj.weight"] is llama["sd"][
        "model.layers.1.self_attn.q_proj.weight"]
    tied = dataclasses.replace(to_torch_config(LLAMA), tie_word_embeddings=True)
    assert "lm_head.weight" not in convert_hf_llama(llama["sd"], tied)


def test_llama_logits_equal_jax(llama):
    ids = llama["ids"]
    kv = np.asarray([12, 9], np.int32)
    want, _ = jax.jit(llama["jm"].apply)(llama["params"], jnp.asarray(ids),
                                         kv_lens=jnp.asarray(kv))
    with torch.no_grad():
        got, _ = llama["tm"](torch.as_tensor(ids), kv_lens=torch.as_tensor(kv))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_convert_cli_llama_equals_jax(tmp_path, llama, quant):
    """`convert_checkpoint --kind llama [--quant-int8]` from a file: the
    saved state equals the JAX converter's tree (int8 codes and scales
    included), and it loads into the port's model and serves."""
    src, out = str(tmp_path / "llama.bin"), str(tmp_path / "llama.pt")
    torch.save(llama["sd"], src)
    overrides = {k: getattr(LLAMA, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta")}
    flags = ["--quant-int8"] if quant else []
    state = tconvert_cli.main(["--kind", "llama", "--input", src, "--output", out,
                               "--config-json", json.dumps(overrides), *flags],
                              device="cpu")
    want = jax_convert_llama(llama["sd"], LLAMA)
    if quant:
        want = {"params": quantize_embed_int8(quantize_kernels_int8(want["params"]))}
    assert_same_state(state, bridged(want))
    cfg = dataclasses.replace(LLAMA, quant_int8=quant, quant_int8_embed=quant)
    tm = restore_checkpoint(LlamaForCausalLM(to_torch_config(cfg),
                                             dtype=torch.float32, device="cpu"), out)
    eng = ServingEngine(tm.eval(), eos_token_id=-1, prompt_cap=16,
                        cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    eng.submit(llama["ids"][0][:7], 4)
    assert [len(t) for t in eng.run_until_drained().values()] == [4]


@pytest.mark.parametrize("spec", [False, True], ids=["greedy", "speculative"])
def test_engine_over_llama_equals_jax(llama, spec):
    """The port of tests/test_serving.py's Llama engine test: the greedy
    and the speculative engine over Llama give the JAX engine's tokens."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, LLAMA.vocab_size, size=n) for n in (5, 9, 7)]
    kw = dict(ENGINE_KW, prompt_cap=16, speculative=spec)
    jeng = JaxEngine(llama["jm"], llama["params"], eos_token_id=2,
                     cache_dtype=jnp.float32, **kw)
    teng = ServingEngine(llama["tm"], eos_token_id=2, cache_dtype=torch.float32,
                         device="cpu", **kw)
    results = []
    for eng in (jeng, teng):
        uids = [eng.submit(p) for p in prompts]
        res = eng.run_until_drained()
        results.append([res[u] for u in uids])
    assert results[1] == results[0]


# ------------------------------------------------------------- projectors


def _projector_io(kind, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((2, 64, PACKER.in_dim)).astype(np.float32)
    if kind != "med2e3":
        return (tokens,)
    slices = rng.standard_normal((2, 8, 12)).astype(np.float32)
    text = rng.standard_normal((2, 40, PACKER.out_dim)).astype(np.float32)
    return tokens, slices, text


@pytest.mark.parametrize("kind", ["spatial_pooling", "mlp", "qformer", "med2e3"])
def test_projector_equals_jax(kind):
    """Each ablation projector alone against the JAX module on bridged
    params: 1e-5, QFormer 2e-5 (its attention through flash on both
    sides); Med2E3's slices 12 wide, scored against the prompt."""
    cfg = dataclasses.replace(PACKER, projector_type=kind)
    inputs = _projector_io(kind)
    if kind == "qformer":
        jm = jproj.QFormerProjector(cfg, num_queries=8, num_heads=4)
        tm = tproj.QFormerProjector(to_torch_config(cfg), num_queries=8,
                                    num_heads=4, device="cpu")
    elif kind == "med2e3":
        jm = jproj.Med2E3Projector(cfg, num_slices=8)
        tm = tproj.Med2E3Projector(to_torch_config(cfg), num_slices=8,
                                   slice_dim=12, device="cpu")
    else:
        jm = jproj.build_projector(cfg)
        tm = tproj.build_projector(to_torch_config(cfg), device="cpu")
    with jax_flash_always():
        params = fill_zero_inits(jm.init(jax.random.PRNGKey(3),
                                         *map(jnp.asarray, inputs)), 3)
        want = np.asarray(jm.apply(params, *map(jnp.asarray, inputs)))
    load_flax(tm, params)
    with torch.no_grad():
        got = to_np(tm(*map(torch.as_tensor, inputs)))
    n_out = {"spatial_pooling": 8, "mlp": 64, "qformer": 8, "med2e3": 16 + 8}[kind]
    assert got.shape == want.shape == (2, n_out, PACKER.out_dim)
    np.testing.assert_allclose(got, want, **(FLASH_TOL if kind == "qformer" else TOL))


def test_build_projector_registry():
    for kind, cls in (("packer_v3", tproj.VisualPacker),
                      ("spatial_pooling", tproj.SpatialPoolingProjector),
                      ("mlp", tproj.MLPProjector),
                      ("qformer", tproj.QFormerProjector),
                      ("med2e3", tproj.Med2E3Projector)):
        cfg = to_torch_config(dataclasses.replace(PACKER, projector_type=kind))
        assert type(tproj.build_projector(cfg, device="cpu")) is cls
    with pytest.raises(ValueError, match="Unknown projector type"):
        tproj.build_projector(to_torch_config(dataclasses.replace(
            PACKER, projector_type="perceiver")), device="cpu")


# ---------------------------------------------------------- VLM variants

VARIANTS = {
    "qformer": dataclasses.replace(
        TINY_VLM, tower_mode="3d_vit",
        packer=dataclasses.replace(TINY_VLM.packer, projector_type="qformer")),
    "med2e3": dataclasses.replace(TINY_VLM, tower_mode="med2e3"),
    "llama": dataclasses.replace(TINY_VLM, llm=jax_as_phi3(LLAMA)),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    cfg = VARIANTS[request.param]
    rng = np.random.default_rng(5)
    n_img, seq = cfg.num_image_tokens, cfg.num_image_tokens + 12
    ids = rng.integers(5, cfg.llm.vocab_size, (2, seq)).astype(np.int32)
    ids[:, 0] = 1
    ids[:, 1:1 + n_img] = 4
    kv = np.asarray([seq, seq - 4], np.int32)
    vol = rng.random((2, 1, 4, 16, 16), np.float32)
    sl = rng.standard_normal((2, 2, 16)).astype(np.float32)
    jm = JaxVLM(cfg, dtype=jnp.float32)
    with jax_flash_always():
        params = fill_zero_inits(jax.jit(jm.init)(
            jax.random.PRNGKey(5), *map(jnp.asarray, (ids, vol, sl))), 5)
    tm = load_flax(HSENetVLM(to_torch_config(cfg), dtype=torch.float32,
                             device="cpu"), params)
    return dict(name=request.param, cfg=cfg, ids=ids, kv=kv, vol=vol, sl=sl,
                jm=jm, params=params, tm=tm)


def test_vlm_variant_prefill_and_tokens_equal_jax(variant):
    """QFormer (3d_vit), med2e3 and a Llama backbone (the port of
    tests/test_vlm.py's Llama VLM test) inside the VLM: prefill logits
    within 1e-4 and greedy tokens equal to the JAX VLM's."""
    v, cfg = variant, variant["cfg"]
    seq = v["ids"].shape[1]
    args = (v["ids"], v["vol"], v["sl"])
    with jax_flash_always():
        want, _ = jax.jit(functools.partial(v["jm"].apply, method=JaxVLM.prefill))(
            v["params"], *map(jnp.asarray, args),
            JaxCache.create(cfg.llm, 2, seq, dtype=jnp.float32), jnp.asarray(v["kv"]))
        want_tok = np.asarray(jax_generate(
            v["jm"], max_new_tokens=MAX_NEW, eos_token_id=-1,
            cache_dtype=jnp.float32)(v["params"], *map(jnp.asarray, (
                v["ids"], v["kv"], v["vol"], v["sl"]))))
    with torch.inference_mode():
        got, _ = v["tm"].prefill(
            *map(torch.as_tensor, args),
            KVCache.create(to_torch_config(cfg.llm), 2, seq, dtype=torch.float32,
                           device="cpu"), torch.as_tensor(v["kv"]))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **VLM_TOL)
    got_tok = make_greedy_generate(
        v["tm"], max_new_tokens=MAX_NEW, eos_token_id=-1,
        cache_dtype=torch.float32)(*map(torch.as_tensor, (
            v["ids"], v["kv"], v["vol"], v["sl"])))
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    if v["name"] == "med2e3":
        # the image features read the prompt: another question moves them
        tm = v["tm"]
        ids2 = v["ids"].copy()
        ids2[:, -3:] = 7
        with torch.no_grad():
            embeds = [tm.llm.embed_tokens(torch.as_tensor(i)) for i in (v["ids"], ids2)]
            f1, f2 = (tm.encode_images(torch.as_tensor(v["vol"]), torch.as_tensor(v["sl"]),
                                       text_embeds=e) for e in embeds)
        n3d = cfg.packer.proj_out_num
        assert torch.equal(f1[:, :n3d], f2[:, :n3d])
        assert not torch.allclose(f1[:, n3d:], f2[:, n3d:])
        with pytest.raises(ValueError, match="depend on the prompt"):
            tm.encode_images_only(torch.as_tensor(v["vol"]), torch.as_tensor(v["sl"]))


def test_med2e3_engine_equals_jax_engine():
    """tower_mode 'med2e3' through the engine, without caches, against the
    JAX engine: equal tokens. Both pad every admission to prompt_cap and
    the text mean reads the pads too, so these tokens are the engine's, not
    batch generate's (ROADMAP §C); the caches refuse med2e3."""
    cfg = VARIANTS["med2e3"]
    rng = np.random.default_rng(7)
    n_img = cfg.num_image_tokens
    traffic = []
    for n_text in (3, 6, 4):
        ids = rng.integers(5, cfg.llm.vocab_size, 1 + n_img + n_text)
        ids[0], ids[1:1 + n_img] = 1, 4
        traffic.append((ids, rng.random((1, 1, 4, 16, 16), np.float32),
                        rng.standard_normal((1, 2, 16)).astype(np.float32)))
    jm = JaxVLM(cfg, dtype=jnp.float32)
    ids0, vol0, sl0 = traffic[0]
    params = fill_zero_inits(jax.jit(jm.init)(
        jax.random.PRNGKey(8), *map(jnp.asarray, (ids0[None], vol0, sl0))), 8)
    tm = load_flax(HSENetVLM(to_torch_config(cfg), dtype=torch.float32,
                             device="cpu"), params)
    kw = dict(ENGINE_KW, prompt_cap=20, multimodal=True)
    jeng = JaxEngine(jm, params, eos_token_id=-1, cache_dtype=jnp.float32, **kw)
    teng = ServingEngine(tm, eos_token_id=-1, cache_dtype=torch.float32,
                         device="cpu", **kw)
    results = []
    for eng in (jeng, teng):
        uids = [eng.submit(ids, volume=vol, slice_features=sl)
                for ids, vol, sl in traffic]
        res = eng.run_until_drained()
        results.append([res[u] for u in uids])
    assert results[1] == results[0]
    for cache in ("volume_cache_size", "kv_prefix_cache_size"):
        with pytest.raises(ValueError, match="med2e3"):
            ServingEngine(tm, eos_token_id=-1, device="cpu", **kw, **{cache: 2})
