"""The weight bridge: every flax leaf of a toy HSENetVLM has a place in the
port's module, and the port loads the result with strict=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.mllm import HSENetVLM
from test_torch_common import TINY_VLM, to_torch_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flax_params():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 64, (1, 12))
    vol = rng.random((1, 1, 4, 16, 16), np.float32)
    sl = rng.random((1, 2, 16), np.float32)
    variables = jax.jit(JaxVLM(TINY_VLM, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(vol),
        jnp.asarray(sl),
    )
    return jax.tree.map(np.asarray, variables)


def test_every_leaf_maps_and_loads_strictly(flax_params):
    state = flax_to_torch(flax_params)
    # each scanned leaf becomes one entry per layer, every other leaf one
    expected = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(flax_params)[0]:
        keys = [p.key for p in path]
        stacked = any(keys[i:i + 2] in (["tower", "blocks"], ["decoder", "layers"])
                      for i in range(len(keys)))
        expected += leaf.shape[0] if stacked else 1
    assert len(state) == expected
    model = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32,
                      device="cpu")
    model.load_state_dict(state, strict=True)
    assert set(state) == set(model.state_dict())


def test_layouts(flax_params):
    p = flax_params["params"]
    state = flax_to_torch(flax_params)
    # Dense kernel (in, out) -> weight (out, in), scan axis unstacked
    q1 = p["llm"]["decoder"]["layers"]["q_proj"]["kernel"][1]
    np.testing.assert_array_equal(
        state["llm.decoder.layers.1.q_proj.weight"].numpy(), q1.T
    )
    qkv0 = p["vision_tower"]["tower_stage2"]["tower"]["blocks"]["attn"]["qkv"]
    np.testing.assert_array_equal(
        state["vision_tower.tower_stage2.tower.blocks.0.attn.qkv.weight"].numpy(),
        qkv0["kernel"][0].T,
    )
    # LayerNorm scale -> weight; LoRA adapters and embeddings keep layout
    np.testing.assert_array_equal(
        state["vision_tower.tower_stage1.tower.norm.weight"].numpy(),
        p["vision_tower"]["tower_stage1"]["tower"]["norm"]["scale"],
    )
    np.testing.assert_array_equal(
        state["llm.decoder.layers.0.down_proj.lora_a"].numpy(),
        p["llm"]["decoder"]["layers"]["down_proj"]["lora_a"][0],
    )
    np.testing.assert_array_equal(
        state["llm.embed.weight"].numpy(), p["llm"]["embed"]["embedding"]
    )


def test_unknown_leaf_raises(flax_params):
    # a leaf no module of either package has
    tree = {"params": {"q_proj": {"zero_point": np.zeros((), np.float32)}}}
    with pytest.raises(KeyError, match="zero_point"):
        flax_to_torch(tree)


def test_int8_tree_loads_strictly(flax_params):
    """A tree from the JAX package's int8 converters (LoRA merged first)
    loads strictly into the port's `quant_int8` + `quant_int8_embed` VLM:
    codes stay int8, transposed like a float kernel and unstacked along the
    scan axis; scales stay f32; a `QuantEmbed`'s `scale` keeps its name
    while every norm's `scale` still becomes `weight`."""
    import dataclasses

    from hsenet_tpu.models.lora import (
        merge_lora,
        quantize_embed_int8,
        quantize_kernels_int8,
    )

    tree = quantize_embed_int8(quantize_kernels_int8(merge_lora(flax_params)))
    state = flax_to_torch(tree)
    cfg = to_torch_config(dataclasses.replace(
        TINY_VLM, llm=dataclasses.replace(
            TINY_VLM.llm, lora=None, quant_int8=True, quant_int8_embed=True)))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(state, strict=True)
    assert set(state) == set(model.state_dict())
    layers = tree["params"]["llm"]["decoder"]["layers"]
    q = model.llm.decoder.layers[1].down_proj
    assert q.weight_q.dtype == torch.int8 and q.weight_scale.dtype == torch.float32
    np.testing.assert_array_equal(
        q.weight_q.numpy(), layers["down_proj"]["kernel_q"][1].T)
    np.testing.assert_array_equal(
        q.weight_scale.numpy(), layers["down_proj"]["kernel_scale"][1])
    embed = tree["params"]["llm"]["embed"]
    assert model.llm.embed.embedding_q.dtype == torch.int8
    np.testing.assert_array_equal(model.llm.embed.embedding_q.numpy(),
                                  embed["embedding_q"])
    np.testing.assert_array_equal(model.llm.embed.scale.numpy(), embed["scale"])
    np.testing.assert_array_equal(
        model.llm.decoder.norm.weight.detach().numpy(),
        tree["params"]["llm"]["decoder"]["norm"]["scale"])
    int8_names = [n for n, t in state.items() if t.dtype == torch.int8]
    assert len(int8_names) == 7 * TINY_VLM.llm.num_layers + 1
    # the towers and packers stay float parameters
    assert all(n.startswith("llm.") for n in int8_names)


@pytest.mark.parametrize("stage", [1, 2])
def test_clip_tree_loads_strictly(stage):
    """A stage-1 (3D ViT + BERT) or stage-2 (2E3 + BERT) CLIP tree: BERT's
    scan stack `language_encoder/layers` is unstacked, its word, position
    and token-type embeddings and the 0-d logit scale carry over, and the
    port's `CLIPModel` loads every leaf strictly."""
    import dataclasses

    import hsenet_tpu.configs as jcfg
    from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
    from hsenet_torch.models.clip import CLIPModel

    vit = jcfg.ViT3DConfig(
        image_size=(4, 16, 16), patch_size=(2, 8, 8), hidden_size=16,
        mlp_dim=32, num_layers=2, num_heads=2, num_slices=2,
        slice_feature_dim=16, slice_guided=stage == 2)
    bert = jcfg.BertConfig(vocab_size=64, hidden_size=16, num_layers=3,
                           num_heads=2, intermediate_size=32,
                           max_position_embeddings=16)
    cfg = jcfg.CLIPConfig(vision=vit, text=bert, projection_dim=8)
    rng = np.random.default_rng(1)
    args = [rng.random((1, 1, 4, 16, 16), np.float32),
            rng.integers(1, 64, (1, 6)), np.ones((1, 6), np.int32)]
    if stage == 2:
        args.append(rng.random((1, 2, 16), np.float32))
    variables = jax.tree.map(np.asarray, jax.jit(JaxCLIP(cfg).init)(
        jax.random.PRNGKey(0), *map(jnp.asarray, args)))
    state = flax_to_torch(variables)
    model = CLIPModel(to_torch_config(cfg), device="cpu")
    model.load_state_dict(state, strict=True)
    assert set(state) == set(model.state_dict())
    p = variables["params"]
    layers = p["language_encoder"]["layers"]
    np.testing.assert_array_equal(
        state["language_encoder.layers.2.ffn_in.weight"].numpy(),
        layers["ffn_in"]["kernel"][2].T)
    np.testing.assert_array_equal(
        state["language_encoder.layers.1.attn_norm.weight"].numpy(),
        layers["attn_norm"]["scale"][1])
    emb = p["language_encoder"]["embeddings"]
    for name in ("word", "position", "token_type"):
        np.testing.assert_array_equal(
            state[f"language_encoder.embeddings.{name}.weight"].numpy(),
            emb[name]["embedding"])
    assert state["logit_scale"].shape == ()
    assert state["logit_scale"].item() == pytest.approx(cfg.logit_scale_init)
    assert dataclasses.asdict(model.config) == dataclasses.asdict(
        to_torch_config(cfg))
