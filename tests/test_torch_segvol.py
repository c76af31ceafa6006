"""The port's SegVol (models/segvol.py), its sliding-window and predictor
tools (eval/sliding_window.py), the box utilities and the seg registry
against the JAX package's, on the CPU in f32 at toy size: volumes (8, 16,
16) in (2, 4, 4) patches (a (4, 4, 4) grid of width 32, one ViT layer of 4
heads, no CLS), the decoder at SegVol's fixed 8 heads and MLP width 2048.

Parameters come from the JAX model's init through the bridge (biases drawn
instead of zero); the JAX ViT runs its attention through the Pallas kernel
in interpret mode (flash mode "always"). Logits and gradients agree to
1e-4 absolute and relative (both sides f32; sums in another order), the
losses to 1e-6; boxes, masks, offsets, RLE and datasets are equal.
"""

import contextlib
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jds
import hsenet_tpu.data.registry as jreg
import hsenet_tpu.eval.sliding_window as jsw
import hsenet_tpu.ops.attention as jattn
import hsenet_tpu.utils.boxes as jboxes
import hsenet_torch.data.datasets as tds
import hsenet_torch.data.registry as treg
import hsenet_torch.eval.sliding_window as tsw
import hsenet_torch.utils.boxes as tboxes
from hsenet_tpu.models import segvol as jseg
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models import segvol as tseg
from test_torch_common import fill_zero_inits, load_flax, to_np, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
VIT = jcfg.ViT3DConfig(
    image_size=(8, 16, 16), patch_size=(2, 4, 4), hidden_size=32, mlp_dim=64,
    num_layers=1, num_heads=4, classification=False,
)
B = 2


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


def _inputs(seed=0, shape=VIT.image_size, b=B):
    rng = np.random.default_rng(seed)
    return {
        "volume": rng.random((b, 1, *shape), np.float32),
        "text": rng.normal(size=(b, VIT.hidden_size)).astype(np.float32),
        "boxes": np.sort(rng.random((b, 2, 3)), axis=1).reshape(b, 6).astype(np.float32),
        "coords": rng.random((b, 3, 3)).astype(np.float32),
        "labels": np.array([[1, 0, -1], [1, 1, 0]][:b], np.int32),
    }


@pytest.fixture(scope="module")
def segvol():
    x = _inputs()
    jm = jseg.SegVol(VIT)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x["volume"]),
                                 jnp.asarray(x["text"]))
    variables = fill_zero_inits(jax.tree.map(np.asarray, variables), 1)
    tm = load_flax(tseg.SegVol(to_torch_config(VIT), device="cpu"), variables)
    return jm, variables, tm


def _prompts(x, kind, pkg):
    arr = jnp.asarray if pkg == "jax" else torch.as_tensor
    text = arr(x["text"]) if "text" in kind else None
    boxes = arr(x["boxes"]) if "box" in kind else None
    points = ((arr(x["coords"]), arr(x["labels"])) if "points" in kind else None)
    return text, boxes, points


@pytest.mark.parametrize(
    "kind,multimask",
    [("text", False), ("box", False), ("points", False),
     ("text+box+points", False), ("text+box", True)],
    ids=["text", "box", "points", "all", "multimask"],
)
def test_segvol_logits_equal_jax(segvol, kind, multimask):
    jm, variables, tm = segvol
    x = _inputs(3)
    with jax_flash_always():
        want = jax.jit(functools.partial(jm.apply, multimask_output=multimask))(
            variables, jnp.asarray(x["volume"]), *_prompts(x, kind, "jax"))
    with torch.no_grad():
        got = tm(torch.as_tensor(x["volume"]), *_prompts(x, kind, "torch"),
                 multimask_output=multimask)
    assert got.shape == want.shape == (B, 3 if multimask else 1, *VIT.image_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_transposed_convolution_mapping():
    """flax's ConvTranspose (kernel 2, stride 2, "SAME", no kernel
    transpose) through the bridge equals `nn.ConvTranspose3d` on the
    channel-last grid; without the bridge's spatial flip it does not."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    conv = fnn.ConvTranspose(4, (2, 2, 2), strides=(2, 2, 2))
    variables = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = fill_zero_inits(jax.tree.map(np.asarray, variables), 2)
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    up = tseg._UpConv(6, 4, dtype=torch.float32, device="cpu")
    up.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got = up(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 6, 8, 10, 4)
    np.testing.assert_allclose(to_np(got), want, atol=1e-5, rtol=1e-5)
    kernel = variables["params"]["kernel"]
    with torch.no_grad():
        up.weight.copy_(torch.as_tensor(kernel.transpose(3, 4, 0, 1, 2).copy()))
        unflipped = up(torch.as_tensor(x))
    assert np.abs(to_np(unflipped) - want).max() > 1e-2


def test_losses_equal_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (3, 1, 4, 6, 6)).astype(np.float32)
    targets = (rng.random((3, 1, 4, 6, 6)) > 0.6).astype(np.float32)
    targets[1, 0, :2] = -1.0  # ignored voxels
    for jfn, tfn in ((jseg.binary_dice_loss, tseg.binary_dice_loss),
                     (jseg.masked_bce_loss, tseg.masked_bce_loss)):
        want = float(jfn(jnp.asarray(logits), jnp.asarray(targets)))
        got = float(tfn(torch.as_tensor(logits), torch.as_tensor(targets)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(tseg.masked_bce_loss(torch.zeros(1, 2), -torch.ones(1, 2))) == 0.0


def test_segvol_gradients_equal_jax(segvol):
    """d(dice + BCE)/d(every parameter) with a text and a box prompt; the
    Fourier matrix takes none in either."""
    jm, variables, tm = segvol
    x = _inputs(4)
    target = (np.random.default_rng(9).random((B, 1, *VIT.image_size)) > 0.5
              ).astype(np.float32)

    def jloss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x["volume"]),
                          jnp.asarray(x["text"]), jnp.asarray(x["boxes"]))
        t = jnp.asarray(target)
        return jseg.binary_dice_loss(logits, t) + jseg.masked_bce_loss(logits, t)

    with jax_flash_always():
        want = flax_to_torch(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
            variables["params"])))
    tm.zero_grad()
    logits = tm(torch.as_tensor(x["volume"]), torch.as_tensor(x["text"]),
                torch.as_tensor(x["boxes"]))
    t = torch.as_tensor(target)
    (tseg.binary_dice_loss(logits, t) + tseg.masked_bce_loss(logits, t)).backward()
    for name, p in tm.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else to_np(p.grad)
        np.testing.assert_allclose(got, want[name].numpy(), err_msg=name,
                                   atol=1e-5, rtol=1e-4)
    assert not np.any(want["prompt_encoder.pe_layer.gaussian_matrix"].numpy())


def test_predictor_caches_the_embedding_and_equals_jax(segvol):
    """set_image on a volume off the model's frame (resampled), then two
    prompts against the cached grid: equal to the JAX predictor, logits at
    the original resolution; the cached grid equals encode_image's."""
    jm, variables, tm = segvol
    x = _inputs(6, shape=(10, 20, 12), b=1)
    jp = jsw.SegVolPredictor(jm, variables)
    tp = tsw.SegVolPredictor(tm)
    with jax_flash_always():
        jp.set_image(jnp.asarray(x["volume"]))
    tp.set_image(torch.as_tensor(x["volume"]))
    assert tp.is_image_set
    np.testing.assert_allclose(to_np(tp.get_image_embedding()),
                               np.asarray(jp.get_image_embedding()), **TOL)
    resized = tp.transform.apply_volume(torch.as_tensor(x["volume"]))
    with torch.no_grad():
        direct = tm.encode_image(resized)
    torch.testing.assert_close(tp.get_image_embedding(), direct, rtol=0, atol=0)
    voxel_boxes = np.array([[1, 2, 3, 8, 15, 10]], np.float32)
    for kw in ({"text_embedding": x["text"][:1]},
               {"boxes_voxel": voxel_boxes, "multimask_output": True}):
        jkw = {k: (jnp.asarray(v) if k == "text_embedding" else v)
               for k, v in kw.items()}
        tkw = {k: (torch.as_tensor(v) if k == "text_embedding" else v)
               for k, v in kw.items()}
        want = jp.predict(**jkw)
        got = tp.predict(**tkw)
        assert got.shape[2:] == (10, 20, 12)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    tp.reset_image()
    with pytest.raises(RuntimeError, match="set_image first"):
        tp.predict(text_embedding=torch.as_tensor(x["text"][:1]))


def test_sliding_window_equals_jax(segvol):
    """A (1, 12, 24, 21) volume in (8, 16, 16) windows at overlap 0.25:
    the same 8 offsets, and the blended logits of the same ROI predictor."""
    jm, variables, tm = segvol
    rng = np.random.default_rng(8)
    vol = rng.random((1, 12, 24, 21), np.float32)
    text = rng.normal(size=(1, VIT.hidden_size)).astype(np.float32)
    offsets = tsw.window_offsets(vol.shape[1:], VIT.image_size)
    np.testing.assert_array_equal(offsets, jsw.window_offsets(vol.shape[1:],
                                                              VIT.image_size))
    assert len(offsets) == 8
    jpred = jsw.make_segvol_predictor(jm, variables)
    tpred = tsw.make_segvol_predictor(tm)
    with jax_flash_always():
        want = jsw.sliding_window_segment(
            lambda p: jpred(p, jnp.asarray(text)), jnp.asarray(vol),
            VIT.image_size)
    got = tsw.sliding_window_segment(
        lambda p: tpred(p, torch.as_tensor(text)), torch.as_tensor(vol),
        VIT.image_size)
    assert got.shape == (1, 12, 24, 21)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_nms_and_automatic_mask_generation_equal_jax(segvol):
    jm, variables, tm = segvol
    vol = _inputs(10, b=1)["volume"]
    with jax_flash_always():
        want = jsw.automatic_mask_generation(jm, variables, jnp.asarray(vol),
                                             points_per_side=2)
    got = tsw.automatic_mask_generation(tm, torch.as_tensor(vol),
                                        points_per_side=2)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["mask"], w["mask"])
        np.testing.assert_array_equal(g["box"], w["box"])
        np.testing.assert_array_equal(g["point"], w["point"])
        assert g["stability"] == w["stability"]
    # NMS alone: overlapping boxes suppressed, empties skipped, score order
    masks = np.zeros((4, 6, 6, 6), bool)
    masks[0, :4, :4, :4] = masks[1, :4, :4, :3] = masks[2, 4:, 4:, 4:] = True
    props = [{"mask": m, "stability": s} for m, s in zip(masks, (0.5, 0.9, 0.2, 0.8))]
    for thresh in (0.7, 0.3):
        kept = tsw.nms_proposals([dict(p) for p in props], thresh)
        ref = jsw.nms_proposals([dict(p) for p in props], thresh)
        assert [p["stability"] for p in kept] == [p["stability"] for p in ref]
    assert [p["stability"] for p in tsw.nms_proposals(
        [dict(p) for p in props], 0.7)] == [0.9, 0.2]


def test_boxes_equal_jax():
    rng = np.random.default_rng(11)
    for _ in range(5):
        mask = np.zeros((7, 9, 11), bool)
        lo = rng.integers(0, 4, 3)
        hi = lo + rng.integers(1, 4, 3)
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
        for ref in (False, True):
            np.testing.assert_array_equal(
                tboxes.mask2box(mask, reference_compatible=ref),
                jboxes.mask2box(mask, reference_compatible=ref))
        a, b = rng.random(6).astype(np.float32), rng.random(6).astype(np.float32)
        a[3:] += a[:3]
        b[3:] += b[:3]
        for ref in (False, True):
            assert tboxes.box_iou_3d(a, b, ref) == jboxes.box_iou_3d(a, b, ref)
        text = "It is at " + tboxes.format_box(a) + " here."
        assert text == "It is at " + jboxes.format_box(a) + " here."
        np.testing.assert_array_equal(tboxes.extract_box_from_text(text),
                                      jboxes.extract_box_from_text(text))
        rle = tboxes.mask_to_rle(mask)
        assert rle == jboxes.mask_to_rle(mask)
        np.testing.assert_array_equal(tboxes.rle_to_mask(rle), mask)
    assert tboxes.mask2box(np.zeros((2, 2, 2))) is None
    for bad in ("no box", "[1, 2]", "[a,b,c,d,e,f]"):
        assert tboxes.extract_box_from_text(bad) is None
        assert jboxes.extract_box_from_text(bad) is None
    full = np.ones((2, 3, 3), bool)
    assert tboxes.mask_to_rle(full) == jboxes.mask_to_rle(full)


def _write_seg_root(root):
    rng = np.random.default_rng(12)
    for code in jreg.DEFAULT_SEG_REGISTRY:
        entries = []
        for i in range(3):
            img = rng.random((1, 4, 8, 8), np.float32)
            seg = np.zeros((4, 8, 8), np.float32)
            if i != 1:  # an empty mask: the "no" answers
                seg[1:3, 2:5, 3:7] = 1.0
            (root / code).mkdir(exist_ok=True)
            np.save(root / code / f"img{i}.npy", img)
            np.save(root / code / f"seg{i}.npy", seg)
            entries.append({"image": f"{code}/img{i}.npy",
                            "seg": f"{code}/seg{i}.npy", "cls_id": i % 1})
        with open(root / code / f"{code}.json", "w") as f:
            json.dump({"train": entries, "validation": entries[:1]}, f)


def test_registry_equals_jax(tmp_path):
    _write_seg_root(tmp_path)
    assert treg.get_registry() == jreg.get_registry()
    assert treg.code_manifest_path("r", "0002") == jreg.code_manifest_path("r", "0002")
    path = tmp_path / "reg.json"
    path.write_text(json.dumps({"0000": ["liver"]}))
    assert treg.get_registry(str(path)) == jreg.get_registry(str(path))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"0000": "liver"}))
    with pytest.raises(ValueError, match="list of names"):
        treg.load_registry(str(bad))
    mixes = []
    for ds, reg in ((tds, treg), (jds, jreg)):
        tok = ds.SimpleTokenizer(vocab_size=512)
        tok.add_special_tokens({"additional_special_tokens": ds.SPECIAL_TOKENS})
        args = ds.DataArgs(data_root=str(tmp_path), max_length=96, proj_out_num=4)
        mixes.append(reg.build_pos_seg_datasets(args, tok, str(tmp_path),
                                                pad_seg_shape=(1, 4, 8, 8)))
    port, ref = mixes
    assert len(port) == len(ref) == 3 * 3 * 6
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
