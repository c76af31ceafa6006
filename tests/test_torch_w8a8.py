"""The port's W8A8 encode serving mode against the JAX package's, on the
CPU: `DenseW8A8` (dynamic, static and calibrating), the calibration of
static activation scales, the int8 converters, the W8A8 `ViT3D` and
`DualVisionTower`, `quantize_clip_w8a8` and a strict bridge load.

Both sides quantise activations in f32 with the same arithmetic (absmax,
max(., 1e-8) / 127, a division, round half to even), so the int8 codes
agree except where two f32 values straddle a half step after a different
summation order upstream: there a code may differ by one. The int32 sums
are exact on both sides, so a single layer agrees to f32 rounding
(DENSE_TOL, codes equal); a tower's outputs agree to TOWER_TOL, which
leaves room for a flipped code upstream (it moves one product of a later
sum by 1/127 of the row's scale).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsenet_tpu.configs import BertConfig, CLIPConfig, ViT3DConfig
from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
from hsenet_tpu.models.lora import DenseW8A8 as JaxDenseW8A8
from hsenet_tpu.models.lora import VIT_QUANT_TARGETS as JAX_VIT_TARGETS
from hsenet_tpu.models.lora import calibrate_w8a8_act_scales as jax_calibrate
from hsenet_tpu.models.lora import quantize_kernels_int8 as jax_quantize
from hsenet_tpu.models.vit import DualVisionTower as JaxDual
from hsenet_tpu.models.vit import ViT3D as JaxViT
from hsenet_tpu.utils.convert import quantize_clip_w8a8 as jax_quantize_clip
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.clip import CLIPModel
from hsenet_torch.models.lora import (
    VIT_QUANT_TARGETS,
    DenseW8A8,
    calibrate_w8a8_act_scales,
    quantize_kernels_int8,
    quantize_towers_w8a8,
)
from hsenet_torch.models.vit import DualVisionTower, ViT3D
from hsenet_torch.utils.convert import quantize_clip_w8a8
from test_torch_common import fill_zero_inits, load_flax, to_np, to_torch_config
from test_torch_vit import jax_flash_always

torch.set_num_threads(1)

DENSE_TOL = dict(atol=1e-5, rtol=1e-5)
TOWER_TOL = dict(atol=2e-3, rtol=2e-3)
# 4 x 4 x 4 patches + CLS = 65 tokens, 4 heads of width 16, 2 blocks
VIT = ViT3DConfig(
    image_size=(8, 32, 32), patch_size=(2, 8, 8), hidden_size=64, mlp_dim=128,
    num_layers=2, num_heads=4, num_slices=4, slice_feature_dim=64,
    slice_dropout_rate=0.0,
)
W8A8 = dict(quant_w8a8=True)
STATIC = dict(quant_w8a8=True, quant_w8a8_static=True)


def _inputs(seed=0, b=2, cfg=VIT):
    rng = np.random.default_rng(seed)
    vol = rng.random((b, 1, *cfg.image_size), np.float32)
    sl = rng.standard_normal((b, cfg.num_slices, cfg.slice_feature_dim)).astype(
        np.float32)
    return vol, sl


def _np_tree(tree):
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def _quantize_towers_jax(params):
    """The JAX converter on every `tower` subtree (the blocks only: the
    slice-guided cross-attention's float `out_proj` must stay float for a
    JAX W8A8 model to apply)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        return {k: jax_quantize(v, JAX_VIT_TARGETS) if k == "tower" else walk(v)
                for k, v in node.items()}
    return {"params": walk(_np_tree(params)["params"])}


def _dense_problem(seed, in_dim=96, out=64, rows=(3, 17)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*rows, in_dim)) * rng.uniform(0.1, 3.0, (*rows, 1))
         ).astype(np.float32)
    w = rng.standard_normal((in_dim, out)).astype(np.float32) / np.sqrt(in_dim)
    bias = rng.normal(0.0, 0.1, out).astype(np.float32)
    jparams = jax_quantize({"fc1": {"kernel": w, "bias": bias}}, ("fc1",))["fc1"]
    return x, jparams


def _torch_dense(jparams, static):
    in_dim, out = jparams["kernel_q"].shape
    layer = DenseW8A8(in_dim, out, static_act_scale=static, dtype=torch.float32,
                      device="cpu")
    state = {"weight_q": torch.tensor(np.asarray(jparams["kernel_q"]).T),
             "weight_scale": torch.tensor(np.asarray(jparams["kernel_scale"])),
             "bias": torch.tensor(np.asarray(jparams["bias"]))}
    if static:
        state["act_scale"] = torch.tensor(np.float32(jparams.get("act_scale", 1.0)))
    layer.load_state_dict(state, strict=True)
    return layer


@pytest.mark.parametrize("mode", ["dynamic", "static", "calibrating"])
def test_dense_w8a8_matches_jax(mode):
    x, jparams = _dense_problem(0)
    static = mode != "dynamic"
    jm = JaxDenseW8A8(64, dtype=jnp.float32, static_act_scale=static)
    if mode == "static":
        # a scale that clips the widest rows, so the clip is exercised
        jparams = {**jparams, "act_scale": np.float32(np.abs(x).max() * 0.6)}
    layer = _torch_dense(jparams, static)
    if mode == "calibrating":
        want, sown = jm.apply({"params": jparams | {"act_scale": np.float32(1.0)}},
                              jnp.asarray(x), mutable=["calibration"])
        layer.calibrating = True
        got = layer(torch.as_tensor(x))
        np.testing.assert_allclose(float(layer.amax),
                                   float(np.asarray(sown["calibration"]["amax"])), rtol=0)
    else:
        want = jm.apply({"params": jparams}, jnp.asarray(x))
        got = layer(torch.as_tensor(x))
    assert got.shape == (3, 17, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **DENSE_TOL)


def test_dense_w8a8_casts_to_its_dtype():
    x, jparams = _dense_problem(1, rows=(1, 5))
    jm = JaxDenseW8A8(64, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x)), np.float32)
    layer = _torch_dense(jparams, False)
    layer.compute_dtype = torch.bfloat16
    got = layer(torch.as_tensor(x))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 value on both sides
    np.testing.assert_allclose(to_np(got), want, rtol=2 ** -8, atol=1e-6)
    # the integer product is exact: the library's against an int64 product
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.integers(-127, 128, (5, 2176)), dtype=torch.int8)
    w = torch.as_tensor(rng.integers(-127, 128, (24, 2176)), dtype=torch.int8)
    assert torch.equal(torch._int_mm(a, w.t()).long(), a.long() @ w.long().t())


def test_calibrate_gives_the_jax_scales():
    vol, _ = _inputs(3)
    jm = JaxViT(dataclasses.replace(VIT, **STATIC))
    float_params = fill_zero_inits(
        jax.jit(JaxViT(VIT).init)(jax.random.PRNGKey(3), jnp.asarray(vol)), 3)
    qparams = _quantize_towers_jax(float_params)
    with jax_flash_always():
        jscales = jax_calibrate(jm.apply, qparams, [(jnp.asarray(vol),)])
    want = np.asarray(jscales["tower"]["blocks"]["mlp"]["fc1"]["act_scale"])
    assert want.shape == (VIT.num_layers,)

    tm = ViT3D(to_torch_config(dataclasses.replace(VIT, **STATIC)), device="cpu")
    state = quantize_towers_w8a8(flax_to_torch(_np_tree(float_params)), static=True)
    tm.load_state_dict(state, strict=True)
    calibrate_w8a8_act_scales(tm.eval(), [(torch.as_tensor(vol),)])
    for i in range(VIT.num_layers):
        block = tm.tower.blocks[i]
        for name, mod in (("qkv", block.attn.qkv), ("out_proj", block.attn.out_proj),
                          ("fc1", block.mlp.fc1), ("fc2", block.mlp.fc2)):
            group = "mlp" if name.startswith("fc") else "attn"
            jax_scale = jscales["tower"]["blocks"][group][name]["act_scale"][i]
            np.testing.assert_allclose(float(mod.act_scale), float(jax_scale),
                                       rtol=1e-5)
            assert not mod.calibrating and mod.amax is None
    with pytest.raises(ValueError, match="static_act_scale"):
        calibrate_w8a8_act_scales(
            ViT3D(to_torch_config(dataclasses.replace(VIT, **W8A8)), device="cpu"),
            [(torch.as_tensor(vol),)])


def test_quantize_codes_equal_jax():
    vol, _ = _inputs(4)
    params = _np_tree(jax.jit(JaxViT(VIT).init)(jax.random.PRNGKey(4), jnp.asarray(vol)))
    jq = flax_to_torch(jax_quantize(params["params"], JAX_VIT_TARGETS))
    assert VIT_QUANT_TARGETS == JAX_VIT_TARGETS
    tq = quantize_kernels_int8(flax_to_torch(params), VIT_QUANT_TARGETS)
    assert set(tq) == set(jq)
    for name, value in jq.items():
        if value.dtype == torch.int8:
            assert torch.equal(tq[name], value), name
        else:
            np.testing.assert_allclose(tq[name].numpy(), value.numpy(), rtol=1e-6)
    # the tower converter touches the blocks alone
    tt = quantize_towers_w8a8(flax_to_torch(params))
    assert {k for k in tt if k.endswith("weight_q")} == {
        k for k in tq if k.endswith("weight_q") and k.startswith("tower.blocks.")}
    assert "patch_embed.proj.weight" in tt and not any("act_scale" in k for k in tt)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("slice_guided", [False, True], ids=["3d", "2e3"])
def test_w8a8_vit3d_matches_jax(mode, slice_guided):
    cfg = dataclasses.replace(VIT, slice_guided=slice_guided,
                              gelu_approx=mode == "static",
                              **(STATIC if mode == "static" else W8A8))
    vol, sl = _inputs(5)
    args = (jnp.asarray(vol), jnp.asarray(sl) if slice_guided else None)
    float_params = fill_zero_inits(jax.jit(JaxViT(dataclasses.replace(
        cfg, quant_w8a8=False, quant_w8a8_static=False)).init)(
            jax.random.PRNGKey(5), *args), 5)
    jm = JaxViT(cfg)
    jparams = _quantize_towers_jax(float_params)
    with jax_flash_always():
        if mode == "static":
            jparams = {"params": jax_calibrate(jm.apply, jparams, [args])}
        want = jax.jit(jm.apply)(jparams, *args)
    tm = load_flax(ViT3D(to_torch_config(cfg), device="cpu"), jparams)
    got = tm(torch.as_tensor(vol), torch.as_tensor(sl) if slice_guided else None)
    assert got.shape == (2, cfg.seq_len, cfg.hidden_size)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOWER_TOL)


def test_w8a8_dual_tower_matches_jax_and_tracks_float():
    cfg = dataclasses.replace(VIT, **STATIC)
    vol, sl = _inputs(6)
    args = (jnp.asarray(vol), jnp.asarray(sl))
    float_params = fill_zero_inits(
        jax.jit(JaxDual(VIT).init)(jax.random.PRNGKey(6), *args), 6)
    jm = JaxDual(cfg)
    with jax_flash_always():
        jparams = {"params": jax_calibrate(
            jm.apply, _quantize_towers_jax(float_params), [args])}
        want = jax.jit(jm.apply)(jparams, *args)
        ref = jax.jit(JaxDual(VIT).apply)(float_params, *args)
    tm = load_flax(DualVisionTower(to_torch_config(cfg), device="cpu"), jparams)
    got = tm(torch.as_tensor(vol), torch.as_tensor(sl))
    for g, w, r in zip(got, want, ref):
        assert g.shape == (2, VIT.num_patches, VIT.hidden_size)
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOWER_TOL)
        a, b = to_np(g).reshape(-1, VIT.hidden_size), np.asarray(r).reshape(
            -1, VIT.hidden_size)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        assert cos.min() > 0.98, cos.min()


def test_bridge_loads_a_w8a8_tree_strictly():
    cfg = dataclasses.replace(VIT, slice_guided=True, **STATIC)
    vol, sl = _inputs(7)
    jparams = {"params": _np_tree(jax.jit(JaxViT(cfg).init)(
        jax.random.PRNGKey(7), jnp.asarray(vol), jnp.asarray(sl))["params"])}
    state = flax_to_torch(jparams)
    assert state["tower.blocks.1.mlp.fc2.act_scale"].shape == ()
    assert state["tower.blocks.0.attn.qkv.weight_q"].dtype == torch.int8
    assert state["tower.blocks.0.attn.qkv.weight_q"].shape == (
        3 * cfg.hidden_size, cfg.hidden_size)
    tm = ViT3D(to_torch_config(cfg), device="cpu")
    tm.load_state_dict(state, strict=True)
    # the slice-guided cross-attention stays a float dense
    assert tm.slice_guided_attention.out_proj.weight.dtype == torch.float32


CLIP = CLIPConfig(
    vision=VIT,
    text=BertConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                    intermediate_size=64, max_position_embeddings=16),
    projection_dim=32,
)


@pytest.mark.parametrize("slice_guided", [False, True], ids=["stage1", "stage2"])
def test_quantize_clip_w8a8_matches_jax(slice_guided):
    cfg = dataclasses.replace(CLIP, vision=dataclasses.replace(
        VIT, slice_guided=slice_guided))
    qcfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **STATIC))
    vol, sl = _inputs(8, cfg=cfg.vision)
    args = (jnp.asarray(vol, jnp.bfloat16),) + (
        (jnp.asarray(sl),) if slice_guided else ())
    params = _np_tree(jax.jit(JaxCLIP(cfg).init)(
        jax.random.PRNGKey(8), jnp.asarray(vol), jnp.zeros((2, 8), jnp.int32),
        None, jnp.asarray(sl) if slice_guided else None))
    kw = dict(volumes=vol, slice_features=sl if slice_guided else None)
    jmodel = JaxCLIP(qcfg, dtype=jnp.bfloat16)
    with jax_flash_always():
        jq = _np_tree(jax_quantize_clip(params, cfg, **kw))
        jwant = jstate = flax_to_torch(jq)
        if slice_guided:
            # the same calibration on a tree whose cross-attention stayed float
            jwant = flax_to_torch(jax_calibrate(
                lambda v, *a, **k: jmodel.apply(v, *a, method=JaxCLIP.encode_image, **k),
                _quantize_towers_jax(params), [args]))
    tq = quantize_clip_w8a8(flax_to_torch(params), to_torch_config(cfg), **kw)
    scales = sorted(k for k in tq if k.endswith("act_scale"))
    assert len(scales) == 4 * cfg.vision.num_layers
    for name in scales:
        # bf16 encode passes on both sides: the largest |activation| of a
        # layer agrees to a few bf16 units
        np.testing.assert_allclose(float(tq[name]), float(jwant[name]), rtol=2e-2)
    for name, value in tq.items():
        if name.endswith(("weight_q", "weight_scale")) and ".tower." in name:
            assert torch.equal(value, jstate[name]), name
    model = CLIPModel(to_torch_config(qcfg), device="cpu")
    model.load_state_dict(tq, strict=True)
    text = {k: v for k, v in tq.items() if k.startswith(("language", "mm_"))}
    assert all(torch.equal(v, jstate[k]) for k, v in text.items())
    if slice_guided:
        # the JAX converter quantises the cross-attention's out_proj by name
        # and its calibration pass draws a new float kernel for it; the port
        # keeps the trained one
        out_proj = "vision_encoder.slice_guided_attention.out_proj.weight"
        assert torch.equal(tq[out_proj], flax_to_torch(params)[out_proj])
        jcross = jq["params"]["vision_encoder"]["slice_guided_attention"]["out_proj"]
        assert "kernel_q" in jcross and not np.array_equal(
            jcross["kernel"],
            params["params"]["vision_encoder"]["slice_guided_attention"]
            ["out_proj"]["kernel"])
