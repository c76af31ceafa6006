"""The port's 3D Swin encoder (models/swin.py) against the JAX package's,
on the CPU in f32 at toy size: (8, 32, 32) volumes in (2, 4, 4) patches,
width 16, windows (2, 4, 4), two stages of two blocks (2 and 4 heads), so
that shifted windows, padding-free partitions and one patch merging all
run; and SegVol on that encoder.

The relative-position index and the shift masks are integer-equal to the
JAX package's; features, logits and gradients agree to 1e-4 absolute and
relative (both sides f32; sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.models.swin as jswin
import hsenet_torch.models.swin as tswin
from hsenet_tpu.models.segvol import SegVol as JaxSegVol
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.segvol import SegVol
from test_torch_common import fill_zero_inits, load_flax, to_np, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SWIN = jcfg.SwinConfig(
    image_size=(8, 32, 32), patch_size=(2, 4, 4), embed_dim=16,
    window_size=(2, 4, 4), depths=(2, 2), num_heads=(2, 4), patch_norm=True,
)


def _volume(seed, b=2, shape=SWIN.image_size):
    return np.random.default_rng(seed).random((b, 1, *shape), np.float32)


@pytest.mark.parametrize(
    "window,table",
    [((2, 4, 4), None), ((4, 4, 4), None), ((2, 3, 4), (4, 4, 4)),
     ((1, 2, 2), (2, 4, 4))],
    ids=["2x4x4", "4x4x4", "clamped", "clamped-small"],
)
def test_relative_position_index_equals_jax(window, table):
    got = tswin.relative_position_index(window, table)
    want = jswin.relative_position_index(window, table)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "dims,window,shift",
    [((4, 8, 8), (2, 4, 4), (1, 2, 2)), ((8, 8, 8), (4, 4, 4), (2, 2, 2)),
     ((4, 8, 12), (2, 4, 4), (0, 2, 2))],
    ids=["stage0", "cube", "no-depth-shift"],
)
def test_shift_attention_mask_equals_jax(dims, window, shift):
    got = tswin.shift_attention_mask(dims, window, shift)
    want = jswin.shift_attention_mask(dims, window, shift)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, -100.0}
    assert tswin._effective_window(dims, (8, 4, 4), (4, 2, 2)) == \
        jswin._effective_window(dims, (8, 4, 4), (4, 2, 2))


def test_window_round_trip():
    x = torch.randn(2, 4, 8, 12, 3, generator=torch.Generator().manual_seed(0))
    win = tswin.window_partition(x, (2, 4, 4))
    assert win.shape == (2 * 2 * 2 * 3, 32, 3)
    np.testing.assert_array_equal(
        to_np(win), np.asarray(jswin.window_partition(jnp.asarray(x.numpy()),
                                                      (2, 4, 4))))
    assert torch.equal(tswin.window_reverse(win, (2, 4, 4), (4, 8, 12)), x)


@pytest.fixture(scope="module")
def swin():
    vol = _volume(0, b=1)
    jm = jswin.SwinTransformer3D(SWIN)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(vol))
    variables = fill_zero_inits(jax.tree.map(np.asarray, variables), 1)
    rng = np.random.default_rng(2)  # bias tables drawn wider than their init
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.5, v.shape).astype(np.float32)
                      if p[-1].key == "relative_position_bias_table" else v),
        variables)
    tm = load_flax(tswin.SwinTransformer3D(to_torch_config(SWIN), device="cpu"),
                   variables)
    return jm, variables, tm


def test_swin_features_equal_jax(swin):
    jm, variables, tm = swin
    vol = _volume(3)
    want = jax.jit(jm.apply)(variables, jnp.asarray(vol))
    with torch.no_grad():
        got = tm(torch.as_tensor(vol))
    assert got.shape == want.shape == (2, *SWIN.grid, SWIN.out_dim)
    assert tm.layer_names == ["stage0_block0", "stage0_block1", "merge1",
                              "stage1_block0", "stage1_block1"]
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_swin_gradients_equal_jax(swin):
    """d(mean of the squared features)/d(every parameter), the bias tables
    included."""
    jm, variables, tm = swin
    vol = _volume(4)

    def jloss(params):
        return jnp.mean(jm.apply({"params": params}, jnp.asarray(vol)) ** 2)

    want = flax_to_torch(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
        variables["params"])))
    tm.zero_grad()
    (tm(torch.as_tensor(vol)) ** 2).mean().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(to_np(p.grad), want[name].numpy(),
                                   err_msg=name, atol=1e-6, rtol=1e-4)
    assert np.abs(want["stage0_block1.attn.relative_position_bias_table"].numpy()).max() > 0


def test_segvol_with_swin_equals_jax():
    """SegVol on the Swin encoder (its grid and width decide the decoder):
    text-prompted logits at the input's shape."""
    swin = dataclasses.replace(SWIN, depths=(1, 1))
    vision = jcfg.ViT3DConfig(image_size=swin.image_size, patch_size=(2, 8, 8),
                              hidden_size=swin.out_dim, mlp_dim=64, num_layers=1,
                              num_heads=2, classification=False)
    vol = _volume(5)
    text = np.random.default_rng(6).normal(size=(2, swin.out_dim)).astype(np.float32)
    jm = JaxSegVol(vision, swin=swin)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(vol[:1]),
                                 jnp.asarray(text[:1]))
    variables = fill_zero_inits(jax.tree.map(np.asarray, variables), 7)
    assert "stage0_block0" in variables["params"]["image_encoder"]
    tm = load_flax(SegVol(to_torch_config(vision), to_torch_config(swin),
                          device="cpu"), variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(vol), jnp.asarray(text))
    with torch.no_grad():
        got = tm(torch.as_tensor(vol), torch.as_tensor(text))
        grid = tm.encode_image(torch.as_tensor(vol))
    assert grid.shape == (2, *swin.grid, swin.out_dim)
    assert got.shape == want.shape == (2, 1, *swin.image_size)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
