"""The port's checkpoints and reference converters on the CPU against the
JAX package.

  * Converters, bit for bit in f32: for every kind, the port's converter
    equals the JAX converter's tree carried over by
    `hsenet_torch.bridge.flax_to_torch`, key for key. The reference-layout
    inputs are the torch oracles of tests/test_convert_golden.py (MONAI
    ViT towers, the 2E3 tower's cross-attention, the packer), the JAX
    package's own exporters (`export_hf_phi3`, `export_reference_vit`,
    `export_reference_packer`) and seeded tensors under HF BERT's key
    names.
  * `convert_checkpoint` end to end: `--kind phi3 --config-json ...
    --quant-int8` and `--kind clip-stage2` give models whose logits and
    embeddings match the JAX models on the JAX converters' params (1e-4,
    the tolerance of tests/test_torch_phi3.py and test_torch_clip.py), and
    `serve --checkpoint` serves the converted int8 model.
  * Checkpoints: save/restore round trips bit-equal, the overwrite refusal,
    the keep-limit, async saves, the VLM delta selection against the JAX
    regex on the bridged keys, and a Trainer resumed at step 2 of 4 that
    ends bit-equal to the unbroken run.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.utils.checkpoint as jckpt
import hsenet_tpu.utils.convert as jconv
import hsenet_torch.utils.checkpoint as tckpt
import hsenet_torch.utils.convert as tconv
from hsenet_tpu.models.bert import convert_hf_bert as jax_bert
from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
from hsenet_tpu.models.lora import quantize_embed_int8, quantize_kernels_int8
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_tpu.models.phi3 import convert_hf_phi3 as jax_phi3
from hsenet_tpu.models.projector import VisualPacker as JaxPacker
from hsenet_tpu.models.vit import ViT3D as JaxViT
from hsenet_tpu.utils.export_hf import (
    export_hf_phi3,
    export_reference_packer,
    export_reference_vit,
    to_torch_state_dict,
)
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.cli import convert_checkpoint as tconvert_cli
from hsenet_torch.cli import serve as tserve
from hsenet_torch.cli.common import restore_checkpoint
from hsenet_torch.configs import TrainConfig
from hsenet_torch.data.datasets import (
    DataArgs,
    DataLoader,
    SimpleTokenizer,
    SyntheticCTDataset,
)
from hsenet_torch.eval.generate import make_greedy_generate_llm_only
from hsenet_torch.models import init_random_
from hsenet_torch.models.bert import convert_hf_bert
from hsenet_torch.models.clip import CLIPModel
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import Phi3ForCausalLM, convert_hf_phi3
from hsenet_torch.train import train_state as tts
from hsenet_torch.train import vlm as tvlm
from hsenet_torch.train.trainer import Trainer
from test_convert_golden import VIT_CFG, OraclePacker, OracleViT, _randomize
from test_torch_common import TINY_LLM, TINY_VLM, fill_zero_inits, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
BERT = jcfg.BertConfig(vocab_size=64, hidden_size=48, num_layers=2, num_heads=4,
                       intermediate_size=96, max_position_embeddings=32)
PHI = dataclasses.replace(TINY_LLM, lora=None, vocab_size=96,
                          tie_word_embeddings=False)


def assert_same_state(got, want):
    """Key for key, dtype and bits."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def bridged(tree, prefix=""):
    """The JAX converter's tree through the bridge (a standalone BERT's
    `layers` stack is unstacked under a `language_encoder` wrapper)."""
    tree = jax.tree.map(np.asarray, tree)
    if prefix:
        tree = {prefix: tree.get("params", tree)}
    state = flax_to_torch(tree)
    return {k[len(prefix) + 1 if prefix else 0:]: v for k, v in state.items()}


def hf_bert_state(cfg, seed, prefix=""):
    """Seeded tensors under HF `BertModel`'s key names."""
    g = torch.Generator().manual_seed(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab_size, h),
              "embeddings.position_embeddings.weight": (cfg.max_position_embeddings, h),
              "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, h),
              "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,)}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        for name, (o, n) in {"attention.self.query": (h, h), "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (inter, h),
                             "output.dense": (h, inter)}.items():
            shapes[f"{p}.{name}.weight"], shapes[f"{p}.{name}.bias"] = (o, n), (o,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{name}.weight"] = shapes[f"{p}.{name}.bias"] = (h,)
    return {prefix + k: torch.randn(s, generator=g) * 0.1 for k, s in shapes.items()}


def phi_params(seed=0):
    ids = np.random.default_rng(seed).integers(3, PHI.vocab_size, (2, 12))
    params = jax.jit(JaxLM(PHI, dtype=jnp.float32).init)(
        jax.random.PRNGKey(seed), jnp.asarray(ids))
    return ids, jax.tree.map(np.asarray, params)


def clip_reference_state(slice_guided, seed=0):
    """An `M3DCLIP_stage{1,2}` state dict at toy size: MONAI tower oracle,
    HF BERT, projections and logit scale; stage 2 carries the frozen
    teacher under `stage1_pretrained_CLIP.`."""
    vit = dataclasses.replace(VIT_CFG, slice_guided=slice_guided)
    oracle = _randomize(OracleViT(vit, slice_guided=slice_guided), seed)
    g = torch.Generator().manual_seed(seed + 1)
    sd = {f"vision_encoder.{k}": v for k, v in oracle.state_dict().items()}
    sd.update(hf_bert_state(BERT, seed + 2, "language_encoder."))
    for name, width in (("mm_vision_proj", vit.hidden_size),
                        ("mm_language_proj", BERT.hidden_size)):
        sd[f"{name}.weight"] = torch.randn((16, width), generator=g) * 0.1
        sd[f"{name}.bias"] = torch.randn((16,), generator=g) * 0.1
    sd["logit_scale"] = torch.tensor([2.5])
    if slice_guided:
        teacher = clip_reference_state(False, seed + 7)
        sd.update({f"stage1_pretrained_CLIP.{k}": v for k, v in teacher.items()})
    return sd


# ------------------------------------------------------- converters, bitwise


@pytest.mark.parametrize("slice_guided", [False, True], ids=["stage1", "stage2"])
def test_vit_converter_equals_jax(slice_guided):
    cfg = dataclasses.replace(VIT_CFG, slice_guided=slice_guided)
    sd = _randomize(OracleViT(cfg, slice_guided=slice_guided), 3).state_dict()
    got = tconv.convert_reference_vit(sd, cfg.num_layers, slice_guided=slice_guided)
    assert_same_state(got, bridged(jconv.convert_reference_vit(
        sd, cfg.num_layers, slice_guided=slice_guided)))
    if slice_guided:  # the 2E3 tower's cross-attention keys arrive
        assert {"slice_guided_attention.out_proj.weight",
                "patch_score_proj.bias"} <= set(got)


def test_vit_converter_on_exported_jax_params():
    """export_reference_vit of JAX params, converted back by the port, is
    the JAX params bridged (the exporter's layout is the converter's)."""
    cfg = dataclasses.replace(VIT_CFG, slice_guided=True)
    vol = jnp.zeros((1, 1, *cfg.image_size))
    params = jax.tree.map(np.asarray, fill_zero_inits(jax.jit(JaxViT(cfg).init)(
        jax.random.PRNGKey(1), vol, jnp.zeros((1, cfg.num_slices, 48))), 1))
    sd = to_torch_state_dict(export_reference_vit(params, "enc.", slice_guided=True))
    got = tconv.convert_reference_vit(sd, cfg.num_layers, prefix="enc.",
                                      slice_guided=True)
    assert_same_state(got, bridged(params))


@pytest.mark.parametrize("source", ["oracle", "export"])
def test_packer_converter_equals_jax(source):
    """The reference packer's keys from the torch oracle, or from
    export_reference_packer of JAX params (then the converter gives those
    params back, bridged)."""
    prefix = "model.mm_projector2."
    if source == "oracle":
        sd = _randomize(OraclePacker((4, 4, 4), (1, 2, 2), 48, 80), 4).state_dict()
        sd = {f"{prefix}{k}": v for k, v in sd.items()}
    else:
        cfg = jcfg.PackerConfig(grid=(4, 4, 4), kernel=(1, 2, 2), in_dim=48,
                                out_dim=80, dropout_rate=0.0)
        params = jax.tree.map(np.asarray, fill_zero_inits(jax.jit(
            JaxPacker(cfg).init)(jax.random.PRNGKey(4), jnp.zeros((1, 64, 48))), 4))
        sd = to_torch_state_dict(export_reference_packer(params, prefix))
    got = tconv.convert_reference_packer(sd, prefix)
    assert_same_state(got, bridged(jconv.convert_reference_packer(sd, prefix)))
    if source == "export":
        assert_same_state(got, bridged(params))


@pytest.mark.parametrize("slice_guided", [False, True], ids=["stage1", "stage2"])
def test_clip_converter_equals_jax(slice_guided):
    sd = clip_reference_state(slice_guided)
    student = {k: v for k, v in sd.items()
               if not k.startswith("stage1_pretrained_CLIP.")}
    got = tconv.convert_reference_clip(student, 2, slice_guided=slice_guided)
    assert_same_state(got, bridged(jconv.convert_reference_clip(
        student, 2, slice_guided=slice_guided)))
    if slice_guided:  # the teacher converts from its prefix alone
        teacher = tconv.extract_subtree(sd, "stage1_pretrained_CLIP.")
        assert_same_state(tconv.convert_reference_clip(teacher, 2), bridged(
            jconv.convert_reference_clip(
                jconv.extract_subtree(sd, "stage1_pretrained_CLIP."), 2)))


def test_bert_converter_equals_jax():
    sd = hf_bert_state(BERT, 5)
    got = convert_hf_bert(sd, to_torch_config(BERT))
    assert_same_state(got, bridged(jax_bert(sd, BERT), "language_encoder"))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_phi3_converter_equals_jax(tied):
    cfg = dataclasses.replace(PHI, tie_word_embeddings=tied)
    params = jax.tree.map(np.asarray, jax.jit(JaxLM(cfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(2), jnp.ones((1, 4), jnp.int32)))
    sd = to_torch_state_dict(export_hf_phi3(params, cfg))
    got = convert_hf_phi3(sd, to_torch_config(cfg))
    assert_same_state(got, bridged(jax_phi3(sd, cfg)))
    assert ("lm_head.weight" in got) == (not tied)


def test_graft_and_subtree():
    dst = {"a.w": torch.zeros(2), "b.w": torch.zeros(3)}
    assert tconv.graft_params(dict(dst), {"a.w": torch.ones(2)})["a.w"].sum() == 2
    with pytest.raises(KeyError):
        tconv.graft_params(dict(dst), {"c.w": torch.ones(2)})
    with pytest.raises(ValueError):
        tconv.graft_params(dict(dst), {"b.w": torch.ones(2)})
    assert tconv.extract_subtree({"p.x": 1, "q.x": 2}, "p.") == {"x": 1}


# ------------------------------------------------ convert_checkpoint, e2e


def _convert(tmp_path, kind, sd, *flags):
    src, out = str(tmp_path / f"{kind}.bin"), str(tmp_path / f"{kind}.pt")
    torch.save(sd, src)
    tconvert_cli.main(["--kind", kind, "--input", src, "--output", out, *flags],
                      device="cpu")
    return out


def test_convert_cli_phi3_int8_logits_equal_jax(tmp_path):
    ids, params = phi_params()
    sd = to_torch_state_dict(export_hf_phi3(params, PHI))
    overrides = {k: getattr(PHI, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "tie_word_embeddings")}
    out = _convert(tmp_path, "phi3", sd, "--config-json", json.dumps(overrides),
                   "--quant-int8")
    quant = dataclasses.replace(PHI, quant_int8=True, quant_int8_embed=True)
    tm = restore_checkpoint(Phi3ForCausalLM(to_torch_config(quant), dtype=torch.float32,
                                            device="cpu"), out).eval()
    jparams = quantize_embed_int8(quantize_kernels_int8(jax_phi3(sd, PHI)["params"]))
    want, _ = jax.jit(JaxLM(quant, dtype=jnp.float32).apply)(
        {"params": jparams}, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = tm(torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(FileExistsError):  # the output is not overwritten
        tconvert_cli.main(["--kind", "phi3", "--input", str(tmp_path / "phi3.bin"),
                           "--output", out, "--config-json", json.dumps(overrides)],
                          device="cpu")


def test_convert_cli_clip_stage2_embeddings_equal_jax(tmp_path):
    sd = clip_reference_state(True)
    out = _convert(tmp_path, "clip-stage2", sd, "--num-layers", "2")
    cfg = jcfg.CLIPConfig(vision=dataclasses.replace(VIT_CFG, slice_guided=True),
                          text=BERT, projection_dim=16)
    tm = restore_checkpoint(CLIPModel(to_torch_config(cfg), device="cpu"), out).eval()
    rng = np.random.default_rng(6)
    vol = rng.standard_normal((2, 1, *VIT_CFG.image_size)).astype(np.float32)
    slices = rng.standard_normal((2, VIT_CFG.num_slices, 48)).astype(np.float32)
    ids = rng.integers(3, BERT.vocab_size, (2, 10))
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    student = {k: v for k, v in sd.items() if not k.startswith("stage1_pretrained_CLIP.")}
    want = jax.jit(JaxCLIP(cfg).apply)(
        jconv.convert_reference_clip(student, 2, slice_guided=True),
        jnp.asarray(vol), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(slices))
    with torch.no_grad():
        got = tm(*map(torch.as_tensor, (vol, ids, mask, slices)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_convert_cli_vlm_deltas_and_later_kinds(tmp_path):
    sd = {}
    for i, name in enumerate(("mm_projector", "mm_projector2")):
        packer = _randomize(OraclePacker((4, 4, 4), (1, 2, 2), 48, 80), 10 + i)
        sd.update({f"model.{name}.{k}": v for k, v in packer.state_dict().items()})
    out = _convert(tmp_path, "vlm-deltas", sd)
    want = bridged({name: jconv.convert_reference_packer(sd, f"model.{name}.")
                    for name in ("mm_projector", "mm_projector2")})
    assert_same_state(torch.load(out, weights_only=True), want)
    # --kind llama converts an HF Llama state (tests/test_torch_variants.py
    # holds it against the JAX converter at every leaf)
    from hsenet_tpu.configs import LlamaConfig
    from hsenet_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from hsenet_tpu.utils.export_hf import export_hf_llama

    llama = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                        num_layers=1, num_heads=2, num_kv_heads=1, head_dim=8)
    params = jax.tree.map(np.asarray, JaxLlama(llama, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32)))
    sd = to_torch_state_dict(export_hf_llama(params, llama))
    overrides = {k: getattr(llama, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim")}
    out = _convert(tmp_path, "llama", sd, "--config-json", json.dumps(overrides))
    assert_same_state(torch.load(out, weights_only=True), bridged(params))


def test_serve_checkpoint_serves_the_converted_int8_model(tmp_path):
    """convert_checkpoint --kind phi3 --quant-int8 at the serving CLI's
    --synthetic widths, then serve --quant-int8 --llm-only --synthetic
    --checkpoint: the served tokens are the converted model's greedy ones,
    not the random weights'."""
    cfg = dataclasses.replace(PHI, vocab_size=512, hidden_size=64,
                              intermediate_size=128, head_dim=16,
                              tie_word_embeddings=True)
    params = jax.tree.map(np.asarray, jax.jit(JaxLM(cfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(3), jnp.ones((1, 4), jnp.int32)))
    overrides = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
                 "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
                 "tie_word_embeddings": True}
    out = _convert(tmp_path, "phi3", to_torch_state_dict(export_hf_phi3(params, cfg)),
                   "--config-json", json.dumps(overrides), "--quant-int8")
    prompts = [[1, 17, 40, 9, 300], [1, 5, 6, 7]]
    req = tmp_path / "req.jsonl"
    req.write_text("\n".join(json.dumps({"id": f"r{i}", "prompt_ids": p})
                             for i, p in enumerate(prompts)))
    served = {}
    for ckpt in (["--checkpoint", out], []):
        resp = tmp_path / f"resp{len(ckpt)}.jsonl"
        tserve.main(["--quant-int8", "--llm-only", "--synthetic", "--requests",
                     str(req), "--output", str(resp), "--max-new-tokens", "6",
                     "--eos-token-id", "-1", "--prompt-cap", "16", *ckpt],
                    device="cpu")
        served[bool(ckpt)] = [json.loads(line)["tokens"]
                              for line in resp.read_text().splitlines()]
    quant = dataclasses.replace(cfg, quant_int8=True, quant_int8_embed=True)
    tm = restore_checkpoint(Phi3ForCausalLM(to_torch_config(quant), dtype=torch.float32,
                                            device="cpu"), out).eval()
    greedy = make_greedy_generate_llm_only(tm, max_new_tokens=6, eos_token_id=-1,
                                           cache_dtype=torch.float32)
    want = [greedy(torch.tensor([p]), torch.tensor([len(p)]))[0].tolist()
            for p in prompts]
    assert served[True] == want != served[False]


# ------------------------------------------------------------- checkpoints


def test_save_restore_params_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((3, 4), generator=g), "h": torch.randn(5).bfloat16(),
             "q": torch.randint(-127, 128, (4, 2), dtype=torch.int8, generator=g),
             "s": torch.rand(4, generator=g)[1:]}  # a view of a larger storage
    path = str(tmp_path / "sub" / "params.pt")
    tckpt.save_params(path, state)
    got = tckpt.restore_params(path, {k: torch.zeros_like(v) for k, v in state.items()})
    assert_same_state(got, {k: v.clone() for k, v in state.items()})
    with pytest.raises(FileExistsError):
        tckpt.save_params(path, state)
    tckpt.save_params(path, {**state, "w": state["w"] + 1}, overwrite=True)
    assert torch.equal(tckpt.restore_params(path, state)["w"], state["w"] + 1)
    # the template fixes keys, shapes and (float) dtypes
    cast = tckpt.restore_params(path, {**state, "w": state["w"].double()})
    assert cast["w"].dtype == torch.float64
    for template, error in (({k: v for k, v in state.items() if k != "s"}, KeyError),
                            ({**state, "w": torch.zeros(4, 3)}, ValueError),
                            ({**state, "q": torch.zeros(4, 2)}, TypeError)):
        with pytest.raises(error):
            tckpt.restore_params(path, template)


def _train_state(seed=0, value=None):
    model = torch.nn.Linear(4, 3)
    init_random_(model, torch.Generator().manual_seed(seed))
    tx = tts.make_optimizer(TrainConfig(total_steps=10))
    state = tts.TrainState.create(model, tx)
    if value is not None:
        with torch.no_grad():
            for p in state.params.values():
                p.fill_(value)
            for m in state.opt_state.mu + state.opt_state.nu:
                m.fill_(value / 2)
        state = tts.TrainState(step=int(value), params=state.params,
                               opt_state=tts.AdamWState(int(value), state.opt_state.mu,
                                                        state.opt_state.nu))
    return state


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_manager_keeps_the_newest(tmp_path, async_save):
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2, async_save=async_save)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_train_state())
    for step in range(1, 6):
        mgr.save(step, _train_state(value=float(step)), config={"lr": 1e-4})
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert json.load(open(tmp_path / "config.json")) == {"lr": 1e-4}
    with pytest.raises(FileExistsError):
        mgr.save(5, _train_state(value=9.0))
    template = _train_state(seed=1)
    restored = mgr.restore(template, step=4)
    assert restored.step == 4 and restored.opt_state.count == 4
    assert restored.params is template.params
    assert all(torch.equal(p, torch.full_like(p, 4.0)) for p in template.params.values())
    assert all(torch.equal(m, torch.full_like(m, 2.0)) for m in restored.opt_state.nu)
    assert mgr.restore(_train_state()).step == 5
    mgr.save(5, _train_state(value=7.0), force=True)
    assert mgr.restore(_train_state()).step == 7
    assert not [n for n in os.listdir(tmp_path) if "tmp" in n]


def test_async_save_snapshots_before_returning(tmp_path):
    """The tensors are copied to the host inside save(): updates made while
    the write runs do not reach the checkpoint."""
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    state = _train_state(value=1.0)
    mgr.save(1, state)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(5.0)
    mgr.wait()
    restored = mgr.restore(_train_state())
    assert all(torch.equal(p, torch.ones_like(p)) for p in restored.params.values())


@pytest.fixture(scope="module")
def vlm_params():
    cfg = TINY_VLM
    ids = jnp.ones((1, 1 + cfg.num_image_tokens + 2), jnp.int32)
    params = jax.jit(JaxVLM(cfg).init)(
        jax.random.PRNGKey(0), ids, jnp.zeros((1, 1, *cfg.vision.image_size)),
        jnp.zeros((1, cfg.vision.num_slices, cfg.vision.slice_feature_dim)))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("quant", [False, True], ids=["lora", "int8"])
def test_vlm_delta_selection_equals_jax(vlm_params, quant):
    """The JAX regex over the flax tree and the port's over the bridged
    dotted names pick the same leaves, with float and int8 LLM leaves."""
    params = vlm_params
    if quant:
        params = {"params": dict(params["params"], llm=quantize_embed_int8(
            quantize_kernels_int8(params["params"]["llm"])))}
    want = set(flax_to_torch(jckpt.filter_tree(params, jckpt._VLM_DELTA_RX)))
    got = set(tckpt.filter_tree(flax_to_torch(params), tckpt._VLM_DELTA_RX))
    assert got == want
    assert any(".embed." in k for k in got) and any("lora_" in k for k in got)
    assert not any("patch_embed" in k or "vision_tower" in k for k in got)


def test_vlm_deltas_round_trip(tmp_path):
    cfg = to_torch_config(TINY_VLM)
    trained = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    init_random_(trained, torch.Generator().manual_seed(0))
    fresh = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    init_random_(fresh, torch.Generator().manual_seed(0))
    with torch.no_grad():  # the finetune moved the deltas only
        for name, p in trained.named_parameters():
            if name in tckpt.filter_tree(dict(trained.named_parameters()),
                                         tckpt._VLM_DELTA_RX):
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    path = str(tmp_path / "deltas.pt")
    tckpt.save_vlm_deltas(path, trained.state_dict())
    tckpt.save_vlm_deltas(path, trained.state_dict())  # re-export overwrites
    saved = torch.load(path, weights_only=True)
    assert saved and all("mm_projector" in k or "lora_" in k or k == "llm.embed.weight"
                         for k in saved)
    fresh.load_state_dict(tckpt.load_vlm_deltas(path, fresh.state_dict()), strict=True)
    assert_same_state(fresh.state_dict(), trained.state_dict())


def _fit(tmp_path, total, restore_from=None):
    """The tiny VLM's LoRA finetune through Trainer, LoRA dropout on (so
    each step's seed matters), shuffled epochs of 3 batches, a checkpoint
    every 2 steps."""
    cfg = to_torch_config(dataclasses.replace(TINY_VLM, llm=dataclasses.replace(
        TINY_VLM.llm, lora=dataclasses.replace(TINY_VLM.llm.lora, dropout_rate=0.3))))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    mask = tvlm.vlm_trainable_mask(model)
    tvlm.to_training_dtypes(model, mask)
    train_cfg = TrainConfig(total_steps=4, learning_rate=1e-2, log_every=1,
                            eval_every=0, checkpoint_every=2, seed=5)
    tx = tts.make_optimizer(train_cfg, mask)
    state = tts.TrainState.create(model, tx)
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    if restore_from is not None:
        state = mgr.restore(state, step=restore_from)
    ds = SyntheticCTDataset(n=6, shape=(1, *cfg.vision.image_size),
                            tokenizer=SimpleTokenizer(vocab_size=64), mode="caption",
                            args=DataArgs(proj_out_num=cfg.num_image_tokens,
                                          max_length=24),
                            num_slices=2, slice_dim=16)
    seen = []

    def loader():
        return DataLoader(ds, batch_size=2, shuffle=True, seed=3)

    step_fn = tvlm.make_vlm_train_step(model, tx)

    def step(state, batch, rng):
        seen.append(batch["image"][:, 0, 0, 0, 0].tolist())
        return step_fn(state, batch, rng)

    trainer = Trainer(step, state, loader, train_cfg, checkpoint_manager=mgr)
    state = trainer.fit(total)
    return state, seen, mgr


def test_trainer_resumes_bit_equal(tmp_path):
    unbroken, seen, mgr = _fit(tmp_path / "a", 4)
    assert mgr.all_steps() == [2, 4]
    _, first, _ = _fit(tmp_path / "b", 2)
    resumed, rest, _ = _fit(tmp_path / "b", 4, restore_from=2)
    assert first + rest == seen  # the same batches, epoch 1 included
    assert resumed.step == unbroken.step == 4
    assert all(v.abs().sum() > 0 for k, v in unbroken.params.items()
               if "lora_b" in k)  # the steps trained (LoRA B starts at 0)
    assert_same_state({k: v.detach() for k, v in resumed.params.items()},
                      {k: v.detach() for k, v in unbroken.params.items()})
    for a, b in zip(resumed.opt_state.mu + resumed.opt_state.nu,
                    unbroken.opt_state.mu + unbroken.opt_state.nu):
        assert torch.equal(a, b)
