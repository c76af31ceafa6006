"""The port's segmentation path against the JAX package's, on the CPU in
f32: the [SEG]-routed VLM (`HSENetVLM.forward_with_seg`, SegVol on the
vision config without CLS), `vlm_seg_loss_fn` and its gradients, the
grounding datasets (REC, REG, seg QA), `evaluate --task seg|rec
--synthetic` and `train_vlm --task seg --synthetic`.

The VLM is `test_torch_common.TINY_VLM` with the seg branch (SegVol over a
(2, 2, 2) grid of width 16); parameters come from the JAX init through the
bridge, the JAX attention through the Pallas kernels in interpret mode
(flash mode "always"). Logits, losses and gradients agree to 1e-4 absolute
and relative (f32, sums in another order). Datasets and the CLIs' metrics
are equal. Every dropout is 0 in the CLI comparisons, the [SEG] prompt's
fixed Dropout(0.1) included (`seg_dropout_rate` in the port, the flax
`nn.Dropout` rate in the JAX model): the two packages' random streams
cannot agree.
"""

import argparse
import contextlib
import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.cli.train_vlm as jvlm
import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jds
import hsenet_tpu.ops.attention as jattn
import hsenet_tpu.train.trainer as jtrainer
import hsenet_tpu.train.vlm as jtrain
import hsenet_torch.cli.train_vlm as tvlm
import hsenet_torch.data.datasets as tds
import hsenet_torch.train.trainer as ttrainer
import hsenet_torch.train.vlm as ttrain
from hsenet_tpu.cli import evaluate as jeval
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.segvol import SegVol as JaxSegVol
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.cli import evaluate as teval
from hsenet_torch.cli.common import build_vlm_config
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.utils.checkpoint import save_params
from test_torch_common import TINY_VLM, fill_zero_inits, load_flax, to_np, to_torch_config
from test_torch_eval import _jax_vlm_params, _run
from test_torch_train_cli import recording
from test_torch_train_vlm_cli import BASE, STEPS, without_dropout

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SEG_ID = 60
CFG = dataclasses.replace(TINY_VLM, seg_enable=True, seg_token_id=SEG_ID)
B, S = 3, 20
N_IMG = CFG.num_image_tokens


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


def _batch(seed=0):
    """Rows with two [SEG] tokens, one, and none (its mask empty too)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, SEG_ID, (B, S)).astype(np.int32)
    ids[:, 1:1 + N_IMG] = 0  # the image block
    ids[0, [12, 16]] = SEG_ID
    ids[1, 14] = SEG_ID
    mask = np.ones((B, S), np.int32)
    mask[1, 18:] = 0
    labels = np.where(np.arange(S) >= 10, ids, -100).astype(np.int32)
    seg = np.zeros((B, 1, *CFG.vision.image_size), np.float32)
    seg[0, 0, 1:3, 4:12, 2:9] = 1.0
    seg[1, 0, :2, 8:, 8:] = 1.0
    return {
        "input_ids": ids, "attention_mask": mask, "labels": labels,
        "image": rng.random((B, 1, *CFG.vision.image_size), np.float32),
        "image_2d": rng.standard_normal(
            (B, CFG.vision.num_slices, CFG.vision.slice_feature_dim)).astype(np.float32),
        "seg": seg,
    }


@pytest.fixture(scope="module")
def seg_vlm():
    batch = _batch()
    jm = JaxVLM(CFG, dtype=jnp.float32)
    variables = jax.jit(jm.init, static_argnames="method")(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["image"]), jnp.asarray(batch["image_2d"]),
        method=JaxVLM.forward_with_seg)
    variables = fill_zero_inits(jax.tree.map(np.asarray, variables), 1)
    tm = load_flax(HSENetVLM(to_torch_config(CFG), dtype=torch.float32,
                             device="cpu"), variables)
    return jm, variables, tm


def test_forward_with_seg_equals_jax(seg_vlm):
    """LM logits and SegVol logits; the row without [SEG] is prompted with
    zeros, and the pooled prompt reads the positions before each [SEG]."""
    jm, variables, tm = seg_vlm
    batch = _batch(1)
    kv = batch["attention_mask"].sum(-1).astype(np.int32)
    with jax_flash_always():
        want = jax.jit(lambda v, *a: jm.apply(
            v, *a, kv_lens=jnp.asarray(kv), method=JaxVLM.forward_with_seg))(
            variables, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["image"]),
            jnp.asarray(batch["image_2d"]))
    with torch.no_grad():
        got = tm.forward_with_seg(
            torch.as_tensor(batch["input_ids"]), torch.as_tensor(batch["image"]),
            torch.as_tensor(batch["image_2d"]), kv_lens=torch.as_tensor(kv))
    assert got[1].shape == (B, 1, *CFG.vision.image_size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    with pytest.raises(ValueError, match="seg branch"):
        HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32,
                  device="cpu").forward_with_seg(
            torch.as_tensor(batch["input_ids"]), torch.as_tensor(batch["image"]))


def test_seg_loss_and_gradients_equal_jax(seg_vlm):
    """vlm_seg_loss_fn's loss, lm_loss, seg_loss and token_acc, and the
    gradient of every parameter (the towers' are 0: stop_tower_gradients)."""
    jm, variables, tm = seg_vlm
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax_flash_always():
        (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
            lambda p: jtrain.vlm_seg_loss_fn(jm, p, jb), has_aux=True))(variables)
    want = flax_to_torch(jax.tree.map(np.asarray, jg))
    tm.zero_grad()
    loss, metrics = ttrain.vlm_seg_loss_fn(
        tm, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    assert set(metrics) == set(jmetrics) == {"loss", "lm_loss", "seg_loss",
                                             "token_acc"}
    for key, value in jmetrics.items():
        assert float(metrics[key].detach()) == pytest.approx(float(value),
                                                             rel=1e-5), key
    moved = 0
    for name, p in tm.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else to_np(p.grad)
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
        moved += name.startswith("seg_module.") and bool(np.abs(got).max() > 0)
    assert moved > 20


def test_trainable_mask_and_eval_fn_equal_jax(seg_vlm):
    jm, variables, tm = seg_vlm
    jmask = jtrain.vlm_trainable_mask(variables)
    as_leaves = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                             jmask, variables)
    want = {k: bool(v.all()) for k, v in flax_to_torch(as_leaves).items()}
    got = ttrain.vlm_trainable_mask(tm)
    assert got == want
    assert got["seg_projector.layers_0.weight"] and got[
        "seg_module.mask_decoder.iou_token"]
    assert not any(ttrain.vlm_trainable_mask(tm, train_seg=False)[k]
                   for k in got if k.startswith("seg_"))
    batches = [_batch(3), _batch(4)]
    with jax_flash_always():
        want_eval = jtrain.make_vlm_eval_fn(jm, seg=True)(variables, batches)
    got_eval = ttrain.make_vlm_eval_fn(tm, seg=True)(batches)
    assert set(got_eval) == set(want_eval) == {
        "val_loss", "val_lm_loss", "val_seg_loss", "val_token_acc"}
    for key, value in want_eval.items():
        assert got_eval[key] == pytest.approx(value, rel=1e-5), key


# ------------------------------------------------------------------ datasets


def _write_grounding(root):
    rng = np.random.default_rng(5)
    entries = []
    for i in range(5):
        np.save(root / f"img{i}.npy", rng.random((1, 4, 8, 8), np.float32))
        seg = np.zeros((4, 8, 8), np.float32)
        if i != 2:  # an empty mask: "no" answers, no box
            seg[i % 3:3, 1 + i:6, 2:7 - i % 2] = 1.0
        np.save(root / f"seg{i}.npy", seg if i % 2 else seg[None])
        entry = {"image": f"img{i}.npy", "seg": f"seg{i}.npy"}
        entry.update({"target": "liver"} if i % 2 else {"cls_id": i % 3})
        entries.append(entry)
    path = root / "grounding.json"
    path.write_text(json.dumps({"train": entries, "validation": entries[:2]}))
    return str(path)


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
            assert got[key].dtype == value.dtype, key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("name", ["PosRECDataset", "PosREGDataset", "SegQADataset"])
@pytest.mark.parametrize("description", [False, True], ids=["plain", "description"])
def test_grounding_datasets_equal_jax(tmp_path, name, description):
    manifest = _write_grounding(tmp_path)
    sets = []
    for ds in (tds, jds):
        tok = ds.SimpleTokenizer(vocab_size=512)
        tok.add_special_tokens({"additional_special_tokens": ds.SPECIAL_TOKENS})
        args = ds.DataArgs(data_root=str(tmp_path), max_length=96, proj_out_num=4)
        sets.append(getattr(ds, name)(args, tok, manifest, "train",
                                      classes=["liver", "kidney", "spleen"],
                                      description=description, seed=3))
    port, ref = sets
    assert len(port) == len(ref) == 5
    for i in range(5):
        _assert_samples_equal(port[i], ref[i])
    assert ("box" in port[0]) == (name == "PosRECDataset")
    assert "box" not in port[2]


def test_task_mix_and_synthetic_seg_equal_jax(tmp_path):
    # build_task_mix passes no class list: every entry names its target
    entries = json.loads(open(_write_grounding(tmp_path)).read())
    for e in entries["train"]:
        e.pop("cls_id", None)
        e["target"] = "kidney"
    path = tmp_path / "targets.json"
    path.write_text(json.dumps(entries))
    data = []
    for ds in (tds, jds):
        tok = ds.SimpleTokenizer(vocab_size=512)
        tok.add_special_tokens({"additional_special_tokens": ds.SPECIAL_TOKENS})
        args = ds.DataArgs(data_root=str(tmp_path), max_length=96, proj_out_num=4)
        mix = ds.build_task_mix("seg+rec+reg", args, tok, str(path))
        synth = ds.SyntheticCTDataset(n=3, shape=(1, 4, 8, 8), tokenizer=tok,
                                      mode="seg", args=args, num_slices=2,
                                      slice_dim=8)
        loader = ds.DataLoader(ds.MixDataset([synth, mix.datasets[1]],
                                             pad_seg_shape=(1, 4, 8, 8)),
                               batch_size=2, shuffle=True, seed=1)
        data.append((mix, synth, list(loader)))
    (pmix, psynth, pbatches), (jmix, jsynth, jbatches) = data
    assert type(pmix).__name__ == "MixDataset" and len(pmix) == len(jmix) == 15
    for i in range(len(jmix)):
        _assert_samples_equal(pmix[i], jmix[i])
    for i in range(3):
        _assert_samples_equal(psynth[i], jsynth[i])
        assert psynth[i]["seg"].sum() > 0 and "[SEG]" in psynth[i]["answer"]
    assert len(pbatches) == len(jbatches)
    for g, w in zip(pbatches, jbatches):
        _assert_samples_equal(g, w)


# ---------------------------------------------------------------------- CLIs


def _jax_segvol_params():
    """The JAX CLI's `--task seg --synthetic` SegVol: PRNGKey(0) on ones."""
    vit = jcfg.ViT3DConfig(image_size=(8, 16, 16), patch_size=(2, 4, 4),
                           hidden_size=32, mlp_dim=64, num_layers=1, num_heads=4,
                           classification=False)
    return jax.jit(JaxSegVol(vit).init)(
        jax.random.PRNGKey(0), jnp.ones((1, 1, *vit.image_size)),
        jnp.ones((1, vit.hidden_size)))


def test_cli_evaluate_seg_equals_jax(tmp_path):
    ckpt = str(tmp_path / "segvol.pt")
    save_params(ckpt, flax_to_torch(jax.tree.map(np.asarray, _jax_segvol_params())))
    want, _, printed_want = _run(jeval.main, ["--task", "seg", "--synthetic"], jds)
    got, _, printed = _run(teval.main, ["--task", "seg", "--synthetic",
                                        "--checkpoint", ckpt], tds, device="cpu")
    assert got == want == printed == printed_want
    assert got["num_samples"] == 2 and 0 < got["dice"] < 1
    with pytest.raises(SystemExit):
        teval.main(["--task", "seg", "--manifest", "m.json"], device="cpu")


@pytest.mark.parametrize("flags", [[], ["--reference-compatible"]],
                         ids=["iou", "reference-compatible"])
def test_cli_evaluate_rec_equals_jax(tmp_path, flags):
    ckpt = str(tmp_path / "vlm.pt")
    save_params(ckpt, flax_to_torch(jax.tree.map(np.asarray, _jax_vlm_params())))
    argv = ["--task", "rec", "--synthetic", *flags]
    want, want_rows, _ = _run(jeval.main, argv, jds)
    got, rows, printed = _run(teval.main, argv + ["--checkpoint", ckpt], tds,
                              device="cpu")
    assert rows == want_rows and len(rows) == 4
    assert got == want == printed
    assert got["num_samples"] == 4


@contextlib.contextmanager
def _no_seg_dropout():
    """Every dropout rate 0 in both CLIs, the JAX [SEG] prompt's fixed flax
    Dropout(0.1) included."""
    dropout = fnn.Dropout
    with pytest.MonkeyPatch.context() as mp:
        for cli in (jvlm, tvlm):
            mp.setattr(cli, "build_vlm_config", without_dropout(cli.build_vlm_config))
        mp.setattr(fnn, "Dropout", lambda rate, **kw: dropout(0.0, **kw))
        yield


def _port_seg_model(params):
    cfg = without_dropout(build_vlm_config)(argparse.Namespace(synthetic=True))
    tok = tds.SimpleTokenizer(vocab_size=cfg.llm.vocab_size)
    tok.add_special_tokens({"additional_special_tokens": tds.SPECIAL_TOKENS})
    cfg = dataclasses.replace(cfg, seg_enable=True,
                              seg_token_id=tok.convert_tokens_to_ids("[SEG]"))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    model.seg_dropout_rate = 0.0
    return model


def test_cli_train_vlm_seg_losses_equal_jax(tmp_path):
    """Three `--task seg --synthetic` steps from the JAX CLI's own init:
    loss, lm_loss, seg_loss, token_acc and grad_norm step by step within
    1e-4 relative; the SegVol branch trains."""
    argv = BASE + STEPS + ["--task", "seg"]
    with _no_seg_dropout():
        with recording(jvlm, jtrainer) as (runs, init):
            jvlm.main(argv + ["--output-dir", str(tmp_path / "jax")])
        want = runs[0]
        model = _port_seg_model(init["params"])
        before = model.seg_module.mask_decoder.iou_token.detach().clone()
        with recording(None, ttrainer) as (runs, _):
            state = tvlm.main(argv + ["--output-dir", str(tmp_path / "port")],
                              device="cpu", model=model)
    got = runs[0]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for key in ("loss", "lm_loss", "seg_loss", "token_acc", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert all(r["seg_loss"] > 0 for r in got)
    assert not torch.equal(state.model.seg_module.mask_decoder.iou_token, before)
