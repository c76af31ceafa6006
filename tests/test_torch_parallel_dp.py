"""Data parallelism, ZeRO-1 and FSDP of the port (`hsenet_torch.parallel`)
over two gloo ranks on the CPU, against the JAX package on a dp = 2 mesh of
its virtual CPU devices, in f32 at toy size with every dropout rate at 0.

The ranks run once for the whole file (`_torch_parallel_worker.py`); each
test reads its case.

  * CLIP stage 1 and stage 2 (teacher recomputed and cached): each rank
    holds its half of a batch of 4; the loss is the global one and every
    gradient leaf, averaged over dp, must equal `jax.grad` of the JAX loss
    over the dp-sharded global batch at 1e-4 (`test_torch_clip.py`'s
    tolerance; the towers' sums run in another order).
  * The VLM step, grad_accum 2, over a batch of 8 whose rows split as the
    loader splits them and whose token counts differ per rank: two steps'
    loss, token accuracy and gradient norm at 1e-4 relative, and the
    updated parameters within 1e-5, a hundredth of the learning rate (an
    early Adam step moves a leaf by about lr x sign(g), so a gradient near 0
    carries its rounding into a fraction of lr), against the JAX step on
    the dp mesh, under the plain, ZeRO-1 and FSDP placements (FSDP at
    `min_size=0`, so that the toy leaves split). ZeRO-1's gathered moments and
    parameters equal the plain run's bit for bit; FSDP's leaves are really
    split, and a decoder layer's full weights live only while that layer
    runs, with remat (the backward recomputes the layer) and without (a
    saved-tensor hook keeps the shard and the backward gathers again).
  * Checkpoints: under each placement every rank restores its shards
    from the saved file bit for bit, and the file holds the full gathered
    parameters and moments.
  * `make_data_parallel_generate` over a ragged batch of 3: the greedy ids
    equal the JAX wrapper's, and sampled ids equal one process's.
  * FSDP over the int8-base VLM: the codes and scales split over dp, and
    the loss and LoRA gradients equal one process's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.train.stage1 as jstage1
import hsenet_tpu.train.stage2 as jstage2
from _torch_parallel_worker import spawn
from hsenet_tpu.configs import MeshConfig
from hsenet_tpu.eval.generate import make_data_parallel_generate as jax_dp_generate
from hsenet_tpu.eval.generate import make_greedy_generate as jax_generate
from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.parallel.mesh import create_mesh, shard_batch
from hsenet_tpu.train.train_state import TrainState as JaxTrainState
from hsenet_tpu.train.train_state import make_optimizer as jax_optimizer
from hsenet_tpu.train.vlm import make_vlm_train_step as jax_vlm_step
from hsenet_tpu.train.vlm import vlm_trainable_mask as jax_mask
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.eval.generate import make_greedy_generate
from hsenet_torch.models.lora import quantize_kernels_int8
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.train.vlm import to_training_dtypes, vlm_loss_fn, vlm_trainable_mask
from test_torch_clip import CLIP1, CLIP2, TRAIN_CFG, _batch, _jax_args, _port
from test_torch_common import TINY_VLM, fill_zero_inits, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
N_IMG = TINY_VLM.num_image_tokens
GEN_KW = dict(max_new_tokens=6, eos_token_id=2, pad_token_id=0,
              cache_dtype=torch.float32)
SAMPLE = dict(do_sample=True, temperature=1.5, top_p=0.9)


def _vlm_batch(b=8, seq=N_IMG + 14, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (b, seq))
    ids[:, 0] = 1
    lens = seq - np.asarray([0, 3, 1, 6, 2, 9, 0, 4])[:b]  # ragged per rank
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int64)
    labels = np.where(mask == 1, ids, -100).astype(np.int64)
    labels[:, : N_IMG + 2] = -100
    labels[3, N_IMG + 2:N_IMG + 8] = -100
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "image": rng.random((b, 1, 4, 16, 16), np.float32),
            "image_2d": rng.random((b, 2, 16), np.float32)}


def _vlm_port(params):
    model = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32,
                      device="cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    batch = _batch()
    v1 = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(JaxCLIP(CLIP1).init)(
        jax.random.PRNGKey(0), *_jax_args(batch, False))), 2)
    v2 = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(JaxCLIP(CLIP2).init)(
        jax.random.PRNGKey(1), *_jax_args(batch, True))), 3)
    vbatch = _vlm_batch()
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    vparams = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(vbatch["input_ids"]),
        jnp.asarray(vbatch["image"]), jnp.asarray(vbatch["image_2d"]))), 0)
    gen_in = {"ids": vbatch["input_ids"][:3], "kv_lens": np.asarray(
        [N_IMG + 14, N_IMG + 9, N_IMG + 11], np.int32),
        "image": vbatch["image"][:3], "image_2d": vbatch["image_2d"][:3]}
    cases = [
        ("stage1_grads", dict(model=_port(v1, CLIP1), batch=batch)),
        ("stage2_grads", dict(student=_port(v2, CLIP2), teacher=_port(v1, CLIP1),
                              cfg=to_torch_config(CLIP2), batch=batch, step=0)),
        ("vlm_steps", dict(model=_vlm_port(vparams), batch=vbatch,
                           train_cfg=to_torch_config(TRAIN_CFG), grad_accum=2,
                           dir=str(root / "ckpt"))),
        ("fsdp_layers", dict(model=_vlm_port(vparams), batch=vbatch)),
        ("dp_generate", dict(model=_vlm_port(vparams), gen_kwargs=GEN_KW,
                             sample=SAMPLE, rng=11, **gen_in)),
        ("fsdp_int8", dict(model=_int8_port(vparams), batch=vbatch)),
    ]
    ranks = spawn(root, cases)

    mesh = create_mesh(MeshConfig(dp=2, tp=1))
    ref = {}
    jbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    grad = functools.partial(jax.value_and_grad, has_aux=True)
    (loss, m), g = jax.jit(grad(functools.partial(
        jstage1.stage1_loss_fn, JaxCLIP(CLIP1))))(v1, jbatch)
    ref["stage1"] = dict(loss=float(loss), acc=float(m["retrieval_acc"]),
                         grads=flax_to_torch(jax.tree.map(np.asarray, g)))
    student, teacher = JaxCLIP(CLIP2), JaxCLIP(CLIP1)
    (_, m), g = jax.jit(grad(functools.partial(
        jstage2.stage2_loss_fn, student, teacher, CLIP2)))(
        v2, v1, jbatch, jnp.asarray(0))
    ref["stage2"] = dict(metrics=m, grads=flax_to_torch(jax.tree.map(np.asarray, g)))
    t_img, t_txt, _ = teacher.apply(v1, *_jax_args(batch, False))
    cached = shard_batch({**{k: jnp.asarray(v) for k, v in batch.items()},
                          "teacher_image_features": t_img,
                          "teacher_text_features": t_txt}, mesh)
    (_, m), g = jax.jit(grad(functools.partial(
        jstage2.stage2_loss_fn_cached, student, CLIP2,
        v1["params"]["logit_scale"])))(v2, cached, jnp.asarray(0))
    ref["stage2_cached"] = dict(metrics=m,
                                grads=flax_to_torch(jax.tree.map(np.asarray, g)))

    mask = jax_mask(vparams)
    tx = jax_optimizer(TRAIN_CFG, trainable_mask=mask)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, vparams), tx)
    step = jax_vlm_step(jm, tx, mesh, trainable_mask=mask, grad_accum=2)
    rows = []
    for _ in range(2):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in vbatch.items()})
        rows.append({k: float(v) for k, v in metrics.items()})
    ref["vlm"] = dict(metrics=rows, params=flax_to_torch(
        jax.tree.map(np.asarray, state.params)))

    jgen = jax_dp_generate(jax_generate(
        jm, max_new_tokens=6, eos_token_id=2, pad_token_id=0,
        cache_dtype=jnp.float32), mesh)
    ref["generate"] = np.asarray(jgen(vparams, *[jnp.asarray(gen_in[k]) for k in (
        "ids", "kv_lens", "image", "image_2d")]))
    one = make_greedy_generate(_vlm_port(vparams), **GEN_KW, **SAMPLE)
    ref["sampled_one_process"] = one(*[torch.as_tensor(gen_in[k]) for k in (
        "ids", "kv_lens", "image", "image_2d")], rng=11)
    model = _int8_port(vparams)
    loss, metrics = vlm_loss_fn(model, {k: torch.as_tensor(v) for k, v in vbatch.items()})
    params = {n: q for n, q in model.named_parameters() if q.requires_grad}
    grads = torch.autograd.grad(loss, list(params.values()))
    ref["int8"] = dict(loss=float(metrics["loss"]), grads=dict(zip(params, grads)),
                       codes={n: tuple(b.shape) for n, b in model.named_buffers()})
    return dict(ranks=ranks, jax=ref, root=root)


def _int8_port(params):
    """The port's tiny VLM with the LLM's projections int8 (`--int8-base`)
    and the trainable leaves as f32 masters, frozen base."""
    model = _vlm_port(params)
    state = model.state_dict()
    llm = {k: v for k, v in state.items() if k.startswith("llm.")}
    state = {**{k: v for k, v in state.items() if k not in llm},
             **quantize_kernels_int8(llm)}
    cfg = to_torch_config(TINY_VLM)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, quant_int8=True))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(state, strict=True)
    mask = vlm_trainable_mask(model)
    return to_training_dtypes(model, mask)


def test_fsdp_splits_and_gathers_the_int8_codes(world):
    """Under FSDP the int8 codes and their scales are split over dp like the
    float leaves (each rank holds half of every code matrix) and gathered
    without a gradient: the loss and the LoRA gradients are one process's
    (the JAX package splits these leaves too, test_torch_parallel_specs.py)."""
    want = world["jax"]["int8"]
    for r in world["ranks"]:
        got = r["fsdp_int8"]
        assert set(got["codes"]) == set(want["codes"])
        halved = [n for n, shape in got["codes"].items()
                  if shape != want["codes"][n]]
        assert halved and all(n.endswith(("weight_q", "weight_scale"))
                              for n in halved)
        assert all(n in halved for n in want["codes"] if n.endswith("weight_q"))
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][n].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=n)


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_stage1_global_loss_and_gradients_match_jax(world):
    want = world["jax"]["stage1"]
    for r in world["ranks"]:
        got = r["stage1_grads"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], **TOL)
        np.testing.assert_allclose(float(got["acc"]), want["acc"], **TOL)
        _assert_grads(got["grads"], want["grads"])


@pytest.mark.parametrize("mode", ["recomputed", "cached"])
def test_stage2_loss_and_gradients_match_jax(world, mode):
    want = world["jax"]["stage2" if mode == "recomputed" else "stage2_cached"]
    for r in world["ranks"]:
        got = r["stage2_grads"][mode]
        for key in ("loss", "loss_cl", "loss_relation", "retrieval_acc"):
            np.testing.assert_allclose(float(got["metrics"][key]),
                                       float(want["metrics"][key]), **TOL,
                                       err_msg=key)
        _assert_grads(got["grads"], want["grads"])


@pytest.mark.parametrize("mode", ["plain", "zero1", "fsdp"])
def test_vlm_steps_match_jax(world, mode):
    want = world["jax"]["vlm"]
    for r in world["ranks"]:
        got = r["vlm_steps"][mode]
        for g, w in zip(got["metrics"], want["metrics"]):
            for key in ("loss", "token_acc", "grad_norm"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6,
                                           err_msg=key)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                       atol=1e-5, err_msg=name)


def test_zero1_state_equals_plain(world):
    for r in world["ranks"]:
        plain, zero = r["vlm_steps"]["plain"], r["vlm_steps"]["zero1"]
        for key in ("params", "mu", "nu"):
            for name, t in plain[key].items():
                assert torch.equal(zero[key][name], t), (key, name)
        # each rank holds half of every moment whose largest dim is even
        assert any(a != b for a, b in zip(zero["moment_shapes"],
                                          plain["moment_shapes"]))


@pytest.mark.parametrize("mode", ["plain", "zero1", "fsdp"])
def test_checkpoints_hold_the_full_state(world, mode):
    """Every rank restores its shards from the gathered checkpoint bit for
    bit, and the file (written by rank 0) holds the full parameters and
    moments, whatever the layout: a run resumes under any other."""
    for r in world["ranks"]:
        assert r["vlm_steps"][mode]["restored"]
    saved = torch.load(world["root"] / "ckpt" / mode / "2" / "state.pt",
                       weights_only=True)
    run = world["ranks"][0]["vlm_steps"][mode]  # its leaves gathered by the test
    names = list(run["params"])
    assert list(saved["params"]) == names
    for i, name in enumerate(names):
        assert torch.equal(saved["params"][name], run["params"][name]), name
        for m in ("mu", "nu"):
            assert torch.equal(saved["opt_state"][m][i], run[m][name]), (m, name)


def test_fsdp_leaves_are_split(world):
    for r in world["ranks"]:
        plain, fsdp = r["vlm_steps"]["plain"], r["vlm_steps"]["fsdp"]
        split = [n for n in plain["split"] if fsdp["split"][n] != plain["split"][n]]
        assert "llm.embed.weight" in split and len(split) >= len(plain["split"]) // 2


@pytest.mark.parametrize("remat", [False, True], ids=["saved", "remat"])
def test_fsdp_gathers_one_layer_at_a_time(world, remat):
    for r in world["ranks"]:
        rec = r["fsdp_layers"][remat]
        assert rec["forward"] == rec["layer_leaves"] > 0
        assert rec["alive_after_forward"] == 0
        assert rec["backward"] > 0
        assert rec["max_live"] == 1


def test_data_parallel_generate_matches_jax(world):
    for r in world["ranks"]:  # every rank holds the whole batch's ids
        np.testing.assert_array_equal(r["dp_generate"]["greedy"].numpy(),
                                      world["jax"]["generate"])


def test_data_parallel_sampling_equals_one_process(world):
    for r in world["ranks"]:
        assert torch.equal(r["dp_generate"]["sampled"],
                           world["jax"]["sampled_one_process"])
