"""The port's BiomedCLIP 2D trunk against the JAX package's, on the CPU in
f32 through the plain attention (flash mode "never" in both packages):
`PatchEmbed2D`, `ViT2D`, `OnlineSliceFeatures`, the VLM with in-graph slice
features (`VLMConfig.online_slice_features`), its trainable mask and train
step, and the timm/open_clip trunk converter.

Tolerances: activations and logits 1e-4 absolute and relative; the
converter's tensors equal the JAX converter's carried over by the bridge,
bit for bit.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.ops.attention as jattn
import hsenet_torch.ops.attention as tattn
from hsenet_tpu.models.layers import PatchEmbed2D as JaxPatchEmbed2D
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.vit import OnlineSliceFeatures as JaxOnline
from hsenet_tpu.models.vit import ViT2D as JaxViT2D
from hsenet_tpu.train.vlm import vlm_trainable_mask as jax_mask
from hsenet_tpu.utils.convert import convert_biomedclip_vit2d as jax_convert
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.layers import PatchEmbed2D
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.vit import OnlineSliceFeatures, ViT2D
from hsenet_torch.train import train_state as tts
from hsenet_torch.train import vlm as tvlm
from hsenet_torch.utils.convert import convert_biomedclip_vit2d
from test_torch_common import (
    TINY_VIT,
    TINY_VLM,
    fill_zero_inits,
    load_flax,
    to_np,
    to_torch_config,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
VIT2D = jcfg.ViT2DConfig(image_size=32, patch_size=8, hidden_size=32,
                         mlp_dim=64, num_layers=2, num_heads=2)
# tests/test_vlm.py's online configuration: the trunk as wide as the tower
ONLINE_VLM = dataclasses.replace(
    TINY_VLM, online_slice_features=True,
    vit2d=jcfg.ViT2DConfig(image_size=16, patch_size=8,
                           hidden_size=TINY_VIT.slice_feature_dim, mlp_dim=32,
                           num_layers=1, num_heads=2))


@contextlib.contextmanager
def plain():
    jattn.set_flash_mode("never")
    tattn.set_flash_mode("never")
    try:
        yield
    finally:
        jattn.set_flash_mode("auto")
        tattn.set_flash_mode("auto")


@pytest.fixture(autouse=True)
def plain_attention():
    with plain():
        yield


def test_patch_embed_2d_matches_jax():
    x = np.random.default_rng(0).random((3, 32, 24, 3), np.float32)
    jm = JaxPatchEmbed2D(8, 20)
    params = fill_zero_inits(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    tm = load_flax(PatchEmbed2D(8, 3, 20, device="cpu"), params)
    np.testing.assert_allclose(to_np(tm(torch.tensor(x))),
                               np.asarray(jm.apply(params, jnp.asarray(x))), **TOL)


def test_vit2d_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jm = JaxViT2D(VIT2D)
    params = fill_zero_inits(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)), 1)
    tm = load_flax(ViT2D(to_torch_config(VIT2D), device="cpu"), params)
    got = to_np(tm(torch.tensor(x)))
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x))),
                               **TOL)


def test_online_slice_features_match_jax():
    """A (6, 40, 40) volume resized to 4 slices of 32x32 (an antialiased
    downsample on every axis), min-max, CLIP normalisation, the trunk on
    each slice."""
    vol = np.random.default_rng(2).random((2, 1, 6, 40, 40), np.float32)
    jm = JaxOnline(VIT2D, num_slices=4)
    params = fill_zero_inits(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(vol)), 2)
    tm = load_flax(OnlineSliceFeatures(to_torch_config(VIT2D), num_slices=4,
                                       device="cpu"), params)
    got = to_np(tm(torch.tensor(vol)))
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(params, jnp.asarray(vol))),
                               **TOL)


@pytest.fixture(scope="module")
def online():
    rng = np.random.default_rng(3)
    ids = rng.integers(3, TINY_VLM.llm.vocab_size, (2, 24))
    ids[:, 0] = 1  # BOS
    ids[:, 1:1 + TINY_VLM.num_image_tokens] = 4  # image placeholders
    vol = rng.random((2, 1, 4, 16, 16), np.float32)
    jm = JaxVLM(ONLINE_VLM, dtype=jnp.float32)
    with plain():
        params = fill_zero_inits(jax.jit(jm.init)(
            jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(vol), None), 3)
    tm = load_flax(HSENetVLM(to_torch_config(ONLINE_VLM), dtype=torch.float32,
                             device="cpu"), params)
    return dict(ids=ids, vol=vol, jm=jm, params=params, tm=tm)


def test_vlm_with_online_slice_features_matches_jax(online):
    assert "slice_encoder" in online["params"]["params"]
    want = jax.jit(online["jm"].apply)(
        online["params"], jnp.asarray(online["ids"]), jnp.asarray(online["vol"]))
    with torch.no_grad():
        got = online["tm"](torch.tensor(online["ids"]), torch.tensor(online["vol"]))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_trainable_mask_freezes_the_trunk(online):
    """The port's mask freezes every slice_encoder leaf, as the JAX mask
    does, and a train step leaves the trunk's weights as they were."""
    mask = tvlm.vlm_trainable_mask(online["tm"])
    trunk = [k for k in mask if k.startswith("slice_encoder.")]
    assert trunk and not any(mask[k] for k in trunk)
    jmask = jax_mask(online["params"]["params"])
    assert not any(jax.tree.leaves(jmask["slice_encoder"]))
    assert sum(mask.values()) > 0
    model = HSENetVLM(to_torch_config(ONLINE_VLM), dtype=torch.float32, device="cpu")
    model.load_state_dict(online["tm"].state_dict())
    mask = tvlm.vlm_trainable_mask(model)
    tvlm.to_training_dtypes(model, mask)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith("slice_encoder.")}
    tx = tts.make_optimizer(to_torch_config(jcfg.TrainConfig(learning_rate=1e-2)), mask)
    labels = np.where(np.arange(24) < 1 + TINY_VLM.num_image_tokens, -100,
                      online["ids"]).astype(np.int64)
    batch = {"input_ids": torch.tensor(online["ids"]), "labels": torch.tensor(labels),
             "attention_mask": torch.ones(2, 24, dtype=torch.int64),
             "image": torch.tensor(online["vol"])}
    state, metrics = tvlm.make_vlm_train_step(model, tx)(
        tts.TrainState.create(model, tx), batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(p.requires_grad for k, p in model.named_parameters()
                   if k.startswith("slice_encoder."))


def _timm_trunk(seed, norm_pre):
    """A timm ViT trunk state dict at VIT2D's widths, from a numpy seed."""
    rng = np.random.default_rng(seed)
    h, m, p = VIT2D.hidden_size, VIT2D.mlp_dim, VIT2D.patch_size

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": t(h, 3, p, p), "patch_embed.proj.bias": t(h),
          "cls_token": t(1, 1, h), "pos_embed": t(1, VIT2D.num_patches + 1, h),
          "norm.weight": t(h), "norm.bias": t(h)}
    if norm_pre:
        sd.update({"norm_pre.weight": t(h), "norm_pre.bias": t(h)})
    for i in range(VIT2D.num_layers):
        b = f"blocks.{i}"
        for name, shape in (("norm1", (h,)), ("norm2", (h,))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = t(*shape), t(*shape)
        for name, (o, n) in (("attn.qkv", (3 * h, h)), ("attn.proj", (h, h)),
                             ("mlp.fc1", (m, h)), ("mlp.fc2", (h, m))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = t(o, n), t(o)
    return sd


@pytest.mark.parametrize("norm_pre", [False, True], ids=["identity", "norm_pre"])
def test_convert_biomedclip_matches_jax(norm_pre):
    sd = _timm_trunk(5, norm_pre)
    want = flax_to_torch(jax_convert({k: v.numpy() for k, v in sd.items()},
                                     VIT2D.num_layers))
    got = convert_biomedclip_vit2d(sd, VIT2D.num_layers)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    model = ViT2D(to_torch_config(VIT2D), device="cpu")
    model.load_state_dict(got, strict=True)
    # the converted patch projection is the timm conv
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    conv = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      sd["patch_embed.proj.weight"],
                                      sd["patch_embed.proj.bias"], stride=8)
    np.testing.assert_allclose(to_np(model.patch_embed(x)),
                               to_np(conv.flatten(2).transpose(1, 2)), **TOL)
