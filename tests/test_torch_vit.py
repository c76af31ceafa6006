"""The port's vision towers against the JAX package's, on the CPU in f32.

The JAX side runs with flash mode "always" so its towers go through the
Pallas kernel (in interpret mode) as on the TPU; the port's towers go
through `flash_attention`'s plain version. Tolerance 1e-4 absolute and
relative on the f32 tower outputs: two blocks of LayerNorm, attention and
GELU in f32, summed in another order.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.attention as jattn
from hsenet_tpu.configs import ViT3DConfig
from hsenet_tpu.models.vit import DualVisionTower as JaxDual
from hsenet_tpu.models.vit import ViT3D as JaxViT
from hsenet_torch.models.vit import DualVisionTower, ViT3D
from test_torch_common import fill_zero_inits, load_flax, to_np, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
# 4 x 4 x 4 patches + CLS = 65 tokens, 4 heads of width 8, 2 blocks
VIT = ViT3DConfig(
    image_size=(8, 32, 32), patch_size=(2, 8, 8), hidden_size=32, mlp_dim=64,
    num_layers=2, num_heads=4, num_slices=4, slice_feature_dim=32,
)


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    vol = rng.random((b, 1, 8, 32, 32), np.float32)
    sl = rng.standard_normal((b, 4, 32)).astype(np.float32)
    return vol, sl


@pytest.mark.parametrize(
    "overrides",
    [{}, {"slice_guided": True, "slice_dropout_rate": 0.0},
     {"qkv_bias": True, "gelu_approx": True}],
    ids=["3d", "2e3", "qkv-bias-tanh-gelu"],
)
def test_vit3d_matches_jax(overrides):
    cfg = dataclasses.replace(VIT, **overrides)
    slice_guided = cfg.slice_guided
    vol, sl = _inputs()
    jm = JaxViT(cfg)
    args = (jnp.asarray(vol), jnp.asarray(sl) if slice_guided else None)
    params = fill_zero_inits(jax.jit(jm.init)(jax.random.PRNGKey(1), *args), 1)
    with jax_flash_always():
        want, want_scores = jax.jit(jm.apply, static_argnames=("return_scores",))(
            params, *args, return_scores=True)
    tm = load_flax(ViT3D(to_torch_config(cfg), device="cpu"), params)
    got, scores = tm(torch.as_tensor(vol),
                     torch.as_tensor(sl) if slice_guided else None,
                     return_scores=True)
    assert got.shape == (2, cfg.seq_len, cfg.hidden_size)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if slice_guided:
        np.testing.assert_allclose(to_np(scores), np.asarray(want_scores), **TOL)


@pytest.mark.parametrize("tower_mode", ["dual_vits", "3d_vit", "2e3_vit"])
def test_dual_vision_tower_matches_jax(tower_mode):
    vol, sl = _inputs(seed=1)
    jm = JaxDual(VIT, tower_mode=tower_mode)
    args = (jnp.asarray(vol), jnp.asarray(sl))
    params = fill_zero_inits(jax.jit(jm.init)(jax.random.PRNGKey(2), *args), 2)
    with jax_flash_always():
        want = jax.jit(jm.apply)(params, *args)
    tm = load_flax(
        DualVisionTower(to_torch_config(VIT), tower_mode=tower_mode,
                        device="cpu"),
        params,
    )
    got = tm(torch.as_tensor(vol), torch.as_tensor(sl))
    if tower_mode != "dual_vits":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (2, VIT.num_patches, VIT.hidden_size)  # CLS stripped
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
