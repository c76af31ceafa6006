"""The port's VLM finetune slice against the JAX package's, on the CPU in
f32: loss, schedule, optimizer, trainable mask, three train steps of the
tiny VLM of tests/test_vlm.py, gradient accumulation, remat, dropout and
the finetune's data.

The JAX side runs with flash mode "always", so its training forward and
backward go through the Pallas kernels (interpret mode), and without a
dropout key (deterministic), as tests/test_vlm.py trains. Tolerance 1e-4
absolute and relative unless stated: both sides compute in f32 and differ
in the order of their sums.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jdata
import hsenet_tpu.ops.attention as jattn
import hsenet_torch.data.datasets as tdata
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.train import train_state as jts
from hsenet_tpu.train import vlm as jvlm
from hsenet_tpu.train.losses import masked_lm_loss as jax_masked_lm_loss
from hsenet_torch.bridge import flax_to_torch, load_flax
from hsenet_torch.configs import AugmentConfig, LoRAConfig
from hsenet_torch.models import init_random_
from hsenet_torch.models.layers import dropout, dropout_rng
from hsenet_torch.models.lora import LoRADense
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import Phi3Decoder
from hsenet_torch.train import train_state as tts
from hsenet_torch.train import vlm as tvlm
from hsenet_torch.train.losses import masked_lm_loss
from hsenet_torch.train.trainer import Trainer, TrainerHooks
from test_torch_common import TINY_VLM, fill_zero_inits, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
N_IMG = TINY_VLM.num_image_tokens
TRAIN_CFG = jcfg.TrainConfig(total_steps=10, learning_rate=1e-3)


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


def _batch(b=2, seq=24, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (b, seq))
    ids[:, 0] = 1  # BOS
    labels = ids.copy().astype(np.int64)
    labels[:, : N_IMG + 4] = -100  # question + image masked
    mask = np.ones((b, seq), np.int64)
    if ragged:
        mask[1, seq - 4:] = 0
        labels[1, seq - 4:] = -100
    return {
        "input_ids": ids,
        "labels": labels,
        "attention_mask": mask,
        "image": rng.random((b, 1, 4, 16, 16), np.float32),
        "image_2d": rng.random((b, 2, 16), np.float32),
    }


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    batch = _batch()
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    params = fill_zero_inits(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["image"]), jnp.asarray(batch["image_2d"])), 0)
    params = jax.tree.map(np.asarray, params)
    return dict(batch=batch, jm=jm, params=params)


def _port_model(params, *, remat=False):
    model = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32,
                      device="cpu", remat=remat)
    mask = tvlm.vlm_trainable_mask(model)
    tvlm.to_training_dtypes(model, mask)
    return load_flax(model, params), mask


@pytest.mark.parametrize("shift", [True, False])
def test_masked_lm_loss_matches_jax(shift):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 12, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 12))
    labels[0, :5] = -100
    labels[2] = -100  # a row with nothing to learn
    want = jax_masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels), shift)
    got = masked_lm_loss(torch.as_tensor(logits), torch.as_tensor(labels), shift)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_matches_optax(schedule):
    cfg = jcfg.TrainConfig(total_steps=40, learning_rate=3e-4,
                           warmup_ratio=0.1, schedule=schedule)
    want = jts.make_schedule(cfg)
    got = tts.make_schedule(to_torch_config(cfg))
    assert got(0) == 0.0  # step 0 takes no step
    for count in range(45):  # optax computes in f32, the port in f64
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5,
                                   atol=1e-10)


def test_optimizer_matches_optax_over_five_steps():
    """chain(clip_by_global_norm, adamw) under a trainable mask, including
    a step whose gradient norm is clipped and one that is not, and weight
    decay; the frozen leaf never moves."""
    cfg = jcfg.TrainConfig(total_steps=20, learning_rate=1e-2,
                           warmup_ratio=0.1, weight_decay=0.01,
                           max_grad_norm=1.0)
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "frozen": rng.standard_normal((2,)).astype(np.float32)}
    mask = {"a": True, "b": True, "frozen": False}
    scales = [0.1, 5.0, 0.2, 3.0, 0.05]  # norms below and above 1
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in scales]

    tx = jts.make_optimizer(cfg, trainable_mask=mask)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    ttx = tts.make_optimizer(to_torch_config(cfg), mask)
    state = tts.TrainState.create(module, ttx)
    assert list(state.params) == ["a", "b"]
    assert not module.frozen.requires_grad
    norms = []
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        updates, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.tensor(g[k]) for k in state.params]
        norm = tts.global_norm(tg)
        norms.append(float(norm))
        state.opt_state = ttx.step(list(state.params.values()), tg,
                                   state.opt_state, norm)
    assert min(norms) < 1.0 < max(norms)
    for k, v in jp.items():
        np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7)


def test_trainable_mask_matches_jax(tiny):
    want = flax_to_torch(jax.tree.map(
        lambda m, p: np.full(np.shape(p), m, np.float32),
        jvlm.vlm_trainable_mask(tiny["params"]), tiny["params"]))
    model, mask = _port_model(tiny["params"])
    assert set(mask) == set(want)
    assert {k for k, m in mask.items() if m} == {
        k for k, m in want.items() if bool(m.all())}
    trained = {k for k, m in mask.items() if m}
    assert any("lora_a" in k for k in trained)
    assert any("mm_projector2" in k for k in trained)
    assert "llm.embed.weight" in trained
    assert not any("vision_tower" in k for k in trained)
    assert all(p.dtype == torch.float32 for n, p in model.named_parameters()
               if mask[n])


@pytest.fixture(scope="module")
def three_steps(tiny):
    """Three steps of the JAX package's make_vlm_train_step."""
    params = tiny["params"]
    mask = jvlm.vlm_trainable_mask(params)
    tx = jts.make_optimizer(TRAIN_CFG, trainable_mask=mask)
    state = jts.TrainState.create(jax.tree.map(jnp.array, params), tx)
    step = jvlm.make_vlm_train_step(tiny["jm"], tx, None, trainable_mask=mask)
    batch = {k: jnp.asarray(v) for k, v in tiny["batch"].items()}
    metrics = []
    with jax_flash_always():
        for _ in range(3):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flax_to_torch(jax.tree.map(np.asarray, state.params))


def test_three_train_steps_match_jax(tiny, three_steps):
    want_metrics, want_params = three_steps
    model, mask = _port_model(tiny["params"])
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tx = tts.make_optimizer(to_torch_config(TRAIN_CFG), mask)
    state = tts.TrainState.create(model, tx)
    step = tvlm.make_vlm_train_step(model, tx)
    batch = _torch_batch(tiny["batch"])
    for want in want_metrics:
        state, got = step(state, batch)
        for key in ("loss", "token_acc", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), want[key], **TOL)
    assert state.step == 3
    for name, p in model.named_parameters():
        if mask[name]:
            np.testing.assert_allclose(p.detach().numpy(),
                                       want_params[name].numpy(), **TOL)
            assert not torch.equal(p.detach(), before[name]), name
        else:
            assert torch.equal(p.detach(), before[name]), name


class _RecordGrads:
    """A stand-in optimizer that keeps the gradients it is handed."""

    def __init__(self):
        self.seen = []

    def step(self, params, grads, state, grad_norm):
        self.seen.append([g.clone() for g in grads])
        return state


def test_grad_accum_matches_full_batch(tiny):
    """grad_accum=2 on a batch whose rows all hold the same number of
    labels (so the loss decomposes per row) gives the full batch's mean
    gradient, loss and grad norm."""
    batch = _torch_batch(_batch(b=4, seed=3, ragged=False))
    results = []
    for accum in (1, 2):
        model, mask = _port_model(tiny["params"])
        rec = _RecordGrads()
        state = tts.TrainState.create(model, tts.make_optimizer(
            to_torch_config(TRAIN_CFG), mask))
        step = tvlm.make_vlm_train_step(model, rec, grad_accum=accum)
        _, metrics = step(state, batch)
        results.append((metrics, rec.seen[0]))
    (m1, g1), (m2, g2) = results
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [None, 11], ids=["deterministic", "dropout"])
def test_remat_gives_the_same_gradients(tiny, seed):
    """Remat recomputes each Phi block in the backward; with dropout on,
    the recomputed blocks draw the same masks. Equal to 1e-6."""
    cfg = dataclasses.replace(
        TINY_VLM, llm=dataclasses.replace(
            TINY_VLM.llm, lora=dataclasses.replace(TINY_VLM.llm.lora,
                                                   dropout_rate=0.3)))
    batch = _torch_batch(tiny["batch"])
    out = []
    for remat in (False, True):
        model = HSENetVLM(to_torch_config(cfg), dtype=torch.float32,
                          device="cpu", remat=remat)
        load_flax(model, tiny["params"])
        params = [p for n, p in model.named_parameters() if "lora" in n]
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        loss, _ = tvlm.vlm_loss_fn(model, batch, gen)
        out.append((loss, torch.autograd.grad(loss, params)))
    (l1, g1), (l2, g2) = out
    torch.testing.assert_close(l2, l1, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


def test_remat_leaves_the_forward_unchanged():
    """Remat changes what the backward keeps, not what the forward
    computes: with grad on (checkpointed blocks) and off (remat skipped),
    the decoder's output is that of the decoder without remat, exactly."""
    cfg = to_torch_config(TINY_VLM.llm)
    plain = Phi3Decoder(cfg, dtype=torch.float32, device="cpu")
    init_random_(plain, torch.Generator().manual_seed(6))
    remat = Phi3Decoder(cfg, dtype=torch.float32, device="cpu", remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 70, cfg.hidden_size, generator=torch.Generator().manual_seed(7),
                    requires_grad=True)
    kv = torch.tensor([70, 41], dtype=torch.int32)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            want, _ = plain(x, kv_lens=kv)
            got, _ = remat(x, kv_lens=kv)
        assert (got.grad_fn is not None) == grad
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dropout_keeps_and_scales_like_flax():
    """Kept with probability 1 - rate, scaled by 1 / (1 - rate), the masks
    those of torch.rand < 1 - rate on the installed generator."""
    x = torch.randn(200, 300)
    with dropout_rng(torch.Generator().manual_seed(4)):
        y = dropout(x, 0.25, deterministic=False)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(4)) < 0.75
    torch.testing.assert_close(y, torch.where(keep, x / 0.75, 0.0), rtol=0, atol=0)
    assert abs(keep.float().mean().item() - 0.75) < 0.01
    assert dropout(x, 0.25, deterministic=True) is x
    with dropout_rng(torch.Generator().manual_seed(4)):
        assert torch.count_nonzero(dropout(x, 1.0, deterministic=False)) == 0
    with pytest.raises(RuntimeError, match="generator"):
        dropout(x, 0.25, deterministic=False)


def test_lora_dropout_falls_on_the_adapter_input_only():
    layer = LoRADense(6, 5, lora=LoRAConfig(rank=2, alpha=4, dropout_rate=0.5),
                      device="cpu")
    with torch.no_grad():
        layer.lora_a.normal_()
        layer.lora_b.normal_()
    x = torch.randn(3, 6)
    with dropout_rng(torch.Generator().manual_seed(5)):
        y = layer(x, deterministic=False)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(5)) < 0.5
    h = torch.where(keep, x / 0.5, 0.0)
    want = x @ layer.weight.T + (h @ layer.lora_a) @ layer.lora_b * 2.0
    torch.testing.assert_close(y, want)
    torch.testing.assert_close(
        layer(x), x @ layer.weight.T + (x @ layer.lora_a) @ layer.lora_b * 2.0)


def test_train_step_dropout_is_seeded_by_step(tiny):
    """With an rng the step turns dropout on: the same (rng, step) gives the
    same loss, another rng another loss."""
    cfg = dataclasses.replace(TINY_VLM, packer=dataclasses.replace(
        TINY_VLM.packer, dropout_rate=0.5))
    batch = _torch_batch(tiny["batch"])
    losses = []
    for rng in (1, 1, 2):
        model = HSENetVLM(to_torch_config(cfg), dtype=torch.float32, device="cpu")
        mask = tvlm.vlm_trainable_mask(model)
        load_flax(tvlm.to_training_dtypes(model, mask), tiny["params"])
        tx = tts.make_optimizer(to_torch_config(TRAIN_CFG), mask)
        _, m = tvlm.make_vlm_train_step(model, tx)(
            tts.TrainState.create(model, tx), batch, rng)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_trainer_fit_runs_the_steps(tiny):
    cfg = to_torch_config(dataclasses.replace(TRAIN_CFG, log_every=1,
                                              eval_every=0))
    model, mask = _port_model(tiny["params"])
    tx = tts.make_optimizer(cfg, mask)
    step = tvlm.make_vlm_train_step(model, tx)
    logged = []
    trainer = Trainer(step, tts.TrainState.create(model, tx),
                      lambda: [tiny["batch"]], cfg,
                      hooks=TrainerHooks(on_log=lambda s, r: logged.append(s)))
    state = trainer.fit(total_steps=3)
    assert state.step == 3 and logged == [1, 2, 3]
    assert [row["step"] for row in trainer.history] == [1, 2, 3]
    assert all(np.isfinite(row["loss"]) for row in trainer.history)
    evaluate = tvlm.make_vlm_eval_fn(model)
    val = evaluate([tiny["batch"]])
    assert set(val) == {"val_loss", "val_token_acc"}
    Trainer(step, state, lambda: [], cfg, augment=AugmentConfig())  # taken
    Trainer(step, state, lambda: [], cfg, checkpoint_manager=object())  # taken


def test_eval_fn_matches_jax(tiny):
    want = jvlm.make_vlm_eval_fn(tiny["jm"])
    with jax_flash_always():
        want = want(jax.tree.map(jnp.asarray, tiny["params"]), [tiny["batch"]])
    model, _ = _port_model(tiny["params"])
    got = tvlm.make_vlm_eval_fn(model)([tiny["batch"]])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **TOL)


def test_bridge_refuses_trainable_leaves_below_f32(tiny):
    model = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.bfloat16,
                      device="cpu")
    with pytest.raises(ValueError, match="f32"):
        load_flax(model, tiny["params"])
    mask = tvlm.vlm_trainable_mask(model)
    load_flax(tvlm.to_training_dtypes(model, mask), tiny["params"])
    state = flax_to_torch(tiny["params"])
    assert model.llm.decoder.layers[0].q_proj.weight.dtype == torch.bfloat16
    for name, p in model.named_parameters():
        if mask[name]:
            assert p.dtype == torch.float32
            assert torch.equal(p.detach(), state[name])


def test_finetune_data_matches_jax():
    """Tokenizer, the QA packing rule, the synthetic caption set and the
    loader give the JAX package's batches."""
    batches = []
    for data in (jdata, tdata):
        tok = data.SimpleTokenizer(vocab_size=200)
        tok.add_special_tokens({"additional_special_tokens": data.SPECIAL_TOKENS})
        ds = data.SyntheticCTDataset(
            n=6, shape=(1, 4, 16, 16), tokenizer=tok, mode="caption",
            args=data.DataArgs(max_length=24, proj_out_num=4), num_slices=2,
            slice_dim=16,
        )
        loader = data.DataLoader(ds, 3, shuffle=True, seed=7)
        batches.append(list(loader))
    assert len(batches[1]) == 2
    for want, got in zip(*batches):
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value)
                assert got[key].dtype == value.dtype
            else:
                assert got[key] == value
    row = batches[1][0]
    assert (row["labels"][:, :1 + 4 + 3] == -100).all()  # BOS, image, prompt
    # mode "seg" (a box mask and a [SEG] answer) gives the JAX samples too
    seg = [data.SyntheticCTDataset(n=2, shape=(1, 4, 16, 16), mode="seg",
                                   num_slices=2, slice_dim=16)[1]
           for data in (jdata, tdata)]
    assert sorted(seg[1]) == sorted(seg[0])
    for key, value in seg[0].items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(seg[1][key], value)
        else:
            assert seg[1][key] == value
