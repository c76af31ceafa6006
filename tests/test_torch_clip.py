"""The port's CLIP pretraining slice against the JAX package's, on the CPU
in f32, at toy size: vision (8, 16, 16) in (2, 4, 4) patches (65 tokens),
hidden 32, 2 layers and 2 heads in both towers, BERT with vocab 512 and 64
positions, text of 16 tokens.

Parameters come from the JAX models' init through the bridge; inputs from
a numpy seed. The JAX side runs with flash mode "always", so its attention
forward and backward are the Pallas kernels in interpret mode (the
resident ones, B1 and B3, or with `_FORCE_STREAM` the streaming ones, B2
and B4). The 2E3 tower's slice dropout is set to 0 so that no random stream
enters the comparison (the JAX steps always run dropout on). Tolerance
1e-4 absolute and relative: both sides compute in f32 and differ in the
order of their sums.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jdata
import hsenet_tpu.eval.retrieval as jret
import hsenet_tpu.ops.attention as jattn
import hsenet_tpu.ops.flash_attention as jfa
import hsenet_tpu.train.losses as jloss
import hsenet_torch.data.datasets as tdata
import hsenet_torch.eval.retrieval as tret
import hsenet_torch.train.losses as tloss
from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
from hsenet_tpu.train import stage1 as jstage1
from hsenet_tpu.train import stage2 as jstage2
from hsenet_tpu.train import train_state as jts
from hsenet_torch.bridge import flax_to_torch, load_flax
from hsenet_torch.models import init_random_
from hsenet_torch.models.clip import CLIPModel, MaskedCLIPModel
from hsenet_torch.train import stage1 as tstage1
from hsenet_torch.train import stage2 as tstage2
from hsenet_torch.train import train_state as tts
from test_torch_common import fill_zero_inits, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY_VIT = jcfg.ViT3DConfig(
    image_size=(8, 16, 16), patch_size=(2, 4, 4), hidden_size=32, mlp_dim=64,
    num_layers=2, num_heads=2, num_slices=4, slice_feature_dim=32,
    slice_dropout_rate=0.0,
)
TINY_BERT = jcfg.BertConfig(
    vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, max_position_embeddings=64,
)
CLIP1 = jcfg.CLIPConfig(vision=TINY_VIT, text=TINY_BERT, projection_dim=32,
                        max_text_len=16)
CLIP2 = dataclasses.replace(
    CLIP1, vision=dataclasses.replace(TINY_VIT, slice_guided=True))
TRAIN_CFG = jcfg.TrainConfig(total_steps=10, learning_rate=1e-3)
B, SEQ = 4, 16


@contextlib.contextmanager
def jax_flash_always(stream=None):
    try:
        jattn.set_flash_mode("always")
        jfa._FORCE_STREAM = stream
        yield
    finally:
        jattn.set_flash_mode("auto")
        jfa._FORCE_STREAM = None


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, SEQ), np.int32)
    for row in range(b):
        mask[row, :SEQ - 3 * row] = 1  # right-padded: 16, 13, 10, 7
    return {
        "image": rng.random((b, 1, 8, 16, 16), np.float32),
        "image_2d": rng.random((b, 4, 32), np.float32),
        "input_ids": np.where(mask == 1, rng.integers(1, 512, (b, SEQ)), 0),
        "attention_mask": mask,
    }


def _jax_args(batch, with_2d):
    keys = ["image", "input_ids", "attention_mask"] + (["image_2d"] if with_2d else [])
    return [jnp.asarray(batch[k]) for k in keys]


def _port(variables, cfg, remat=False):
    model = CLIPModel(to_torch_config(cfg), device="cpu", remat=remat)
    return load_flax(model, variables)


@pytest.fixture(scope="module")
def params():
    """Flax variables of the stage-1 model (the teacher) and the stage-2
    student, zero inits drawn."""
    batch = _batch()
    v1 = jax.jit(JaxCLIP(CLIP1).init)(jax.random.PRNGKey(0), *_jax_args(batch, False))
    v2 = jax.jit(JaxCLIP(CLIP2).init)(jax.random.PRNGKey(1), *_jax_args(batch, True))
    return (fill_zero_inits(jax.tree.map(np.asarray, v1), 2),
            fill_zero_inits(jax.tree.map(np.asarray, v2), 3))


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("stage", [1, 2])
def test_clip_forward_matches_jax(params, stage):
    cfg, variables = (CLIP1, params[0]) if stage == 1 else (CLIP2, params[1])
    batch = _batch(1)
    with jax_flash_always():
        want = JaxCLIP(cfg).apply(variables, *_jax_args(batch, stage == 2))
    t = _torch_batch(batch)
    with torch.no_grad():
        got = _port(variables, cfg)(
            t["image"], t["input_ids"], t["attention_mask"],
            t["image_2d"] if stage == 2 else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(got[0], dim=-1), 1.0,
                               rtol=1e-5)
    assert got[2].dtype == torch.float32 and got[2].ndim == 0


def _features(seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, 6, 8)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("loss", ["contrastive", "relation", "weight",
                                  "retrieval_acc"])
def test_losses_match_jax(loss):
    img, txt = _features(4)
    t_img, t_txt = _features(5)
    scale = np.float32(2.659)
    if loss == "contrastive":
        want = jloss.clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt),
                                           jnp.asarray(scale))
        got = tloss.clip_contrastive_loss(torch.as_tensor(img),
                                          torch.as_tensor(txt),
                                          torch.as_tensor(scale))
    elif loss == "relation":
        logits = [np.asarray(jloss.clip_contrastive_loss(
            jnp.asarray(a), jnp.asarray(b), scale)[i])
            for a, b in ((t_img, t_txt), (img, txt)) for i in (1, 2)]
        want = [jloss.relation_regulation_loss(*map(jnp.asarray, logits))]
        leaves = [torch.tensor(x, requires_grad=True) for x in logits]
        got = [tloss.relation_regulation_loss(*leaves)]
        got[0].backward()
        assert leaves[0].grad is None and leaves[1].grad is None  # teacher
        assert leaves[2].grad is not None
    elif loss == "weight":
        steps = (0, 1, 2500, 4999, 5000, 70000)
        want = [jloss.relation_weight(jnp.asarray(s)) for s in steps]
        got = [tloss.relation_weight(s) for s in steps]
    else:
        logits = np.random.default_rng(6).standard_normal((6, 6)).astype(np.float32)
        want = [jloss.retrieval_accuracy(jnp.asarray(logits))]
        got = [tloss.retrieval_accuracy(torch.as_tensor(logits))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def _jax_steps(variables, make_step, batches, stream=None):
    tx = jts.make_optimizer(TRAIN_CFG)
    state = jts.TrainState.create(jax.tree.map(jnp.array, variables), tx)
    step, metrics = make_step(tx), []
    with jax_flash_always(stream):
        for batch in batches:
            state, m = step(state, batch, jax.random.PRNGKey(7))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flax_to_torch(jax.tree.map(np.asarray, state.params))


def _port_steps(model, make_step, batches):
    tx = tts.make_optimizer(to_torch_config(TRAIN_CFG))
    state = tts.TrainState.create(model, tx)
    step, metrics = make_step(tx), []
    for batch in batches:
        state, m = step(state, batch, 7)
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == len(batches)
    return metrics


def _assert_steps_match(got_metrics, want_metrics, model, want_params, before):
    for got, want in zip(got_metrics, want_metrics):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    # no mask: every parameter trains, the 0-d logit scale included. BERT's
    # key bias adds the same q.b to every score of a query, which the softmax
    # ignores: its exact gradient is 0, and Adam turns each side's rounding
    # noise into steps of up to lr, so it is held to one lr a step
    key_bias_tol = dict(atol=TRAIN_CFG.learning_rate * len(got_metrics), rtol=0)
    for name, p in model.named_parameters():
        tol = key_bias_tol if name.endswith(".k.bias") else TOL
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   **tol, err_msg=name)
        assert not torch.equal(p.detach(), before[name]), name


@pytest.mark.parametrize("stream", [None, True], ids=["resident", "forced_stream"])
def test_stage1_steps_match_jax(params, stream):
    """Three stage-1 steps (the JAX side through B1/B3), and one step with
    the JAX side forced through its streaming kernels (B2/B4); the port's
    kernels' plain versions serve both routes."""
    n = 3 if stream is None else 2
    batches = [_batch(10 + i % 2) for i in range(n)]
    model = JaxCLIP(CLIP1)
    want_metrics, want_params = _jax_steps(
        params[0], lambda tx: jstage1.make_stage1_train_step(model, tx),
        [{k: jnp.asarray(v) for k, v in b.items() if k != "image_2d"}
         for b in batches], stream)
    port = _port(params[0], CLIP1)
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    got = _port_steps(port, lambda tx: tstage1.make_stage1_train_step(port, tx),
                      [_torch_batch(b) for b in batches])
    assert port.logit_scale.ndim == 0
    _assert_steps_match(got, want_metrics, port, want_params, before)


class _JaxCachedBatches:
    def __init__(self, teacher, tparams):
        self.cache = jstage2.TeacherCache(
            jstage2.make_teacher_embed_fn(teacher, tparams))

    def __call__(self, batch):
        with jax_flash_always():
            batch = self.cache.attach(batch)
        return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("cached", [False, True], ids=["recompute", "cached"])
def test_stage2_steps_match_jax(params, cached):
    """Three stage-2 steps against the frozen stage-1 teacher, recomputed in
    each step or served by `TeacherCache` (one miss per sample, then hits)."""
    teacher_vars, student_vars = params
    batches = [_batch(20 + i % 2) for i in range(3)]
    jt, js = JaxCLIP(CLIP1), JaxCLIP(CLIP2)
    if cached:
        attach = _JaxCachedBatches(jt, teacher_vars)
        jbatches = [attach(b) for b in batches]
    else:
        jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    want_metrics, want_params = _jax_steps(
        student_vars, lambda tx: jstage2.make_stage2_train_step(
            js, jt, CLIP2, tx, teacher_vars, cached_teacher=cached), jbatches)

    student, teacher = _port(student_vars, CLIP2), _port(teacher_vars, CLIP1)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    if cached:
        cache = tstage2.TeacherCache(tstage2.make_teacher_embed_fn(teacher))
        tbatches = [_torch_batch(cache.attach(b)) for b in batches]
        assert (cache.misses, cache.hits) == (2 * B, B)
        assert (attach.cache.misses, attach.cache.hits) == (2 * B, B)
        np.testing.assert_allclose(
            tbatches[2]["teacher_image_features"],
            np.asarray(jbatches[2]["teacher_image_features"]), **TOL)
    else:
        tbatches = [_torch_batch(b) for b in batches]
    before = {k: v.detach().clone() for k, v in student.state_dict().items()}
    got = _port_steps(student, lambda tx: tstage2.make_stage2_train_step(
        student, teacher, to_torch_config(CLIP2), tx, cached_teacher=cached),
        tbatches)
    assert got[0]["relation_weight"] == pytest.approx(0.1)
    _assert_steps_match(got, want_metrics, student, want_params, before)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    assert not any(p.requires_grad for p in teacher.parameters())


def test_teacher_cache_counts_match_jax():
    """The same attach sequence through both caches: hits, misses and
    teacher forwards agree; per-sample keys hit after a reshuffle."""
    base = _batch(30, b=4)
    new = _batch(31, b=1)
    order = [2, 0, 3, 1]
    seq = [base, base, {k: v[order] for k, v in base.items()},
           {k: np.concatenate([v[:3], new[k]]) for k, v in base.items()}]
    counts = []
    for mod in (jstage2, tstage2):
        calls = []

        def embed(batch, calls=calls):
            calls.append(len(batch["input_ids"]))
            n = len(batch["input_ids"])
            feats = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
            if mod is tstage2:
                feats = torch.as_tensor(feats)
            return {"teacher_image_features": feats,
                    "teacher_text_features": feats}

        cache = mod.TeacherCache(embed)
        rows = [cache.attach(b) for b in seq]
        counts.append((cache.hits, cache.misses, list(calls)))
        np.testing.assert_array_equal(
            np.asarray(rows[2]["teacher_text_features"]),
            np.asarray(rows[0]["teacher_text_features"])[order])
    assert counts[0] == counts[1] == (11, 5, [4, 4])


def test_recall_at_k_and_retrieval_eval_match_jax(params):
    img, txt = _features(8)[0], _features(9)[0]
    txt[:3] = img[:3]  # three exact pairs rank first
    ks = (1, 2, 5)
    assert tret.recall_at_k(img, txt, ks) == jret.recall_at_k(img, txt, ks)
    labels = np.random.default_rng(1).random((6, 5)) < 0.5
    assert tret.volume_volume_label_overlap(img, labels, (1, 3)) == pytest.approx(
        jret.volume_volume_label_overlap(img, labels, (1, 3)))

    loader = [_batch(40), _batch(41)]
    with jax_flash_always():
        want = jret.make_clip_retrieval_eval_fn(JaxCLIP(CLIP1), ks=(1, 5))(
            params[0], loader)
    got = tret.make_clip_retrieval_eval_fn(_port(params[0], CLIP1), ks=(1, 5))(
        loader)
    assert got == want
    assert tret.clip_retrieval_eval(_port(params[0], CLIP1), loader, (1, 5)) == want


@pytest.mark.parametrize("seed", [None, 3], ids=["deterministic", "dropout"])
def test_remat_gives_the_same_gradients(params, seed):
    """Remat recomputes each vision block in the backward; with dropout on
    in the blocks, the recomputation draws the same masks."""
    cfg = dataclasses.replace(
        CLIP1, vision=dataclasses.replace(TINY_VIT, dropout_rate=0.2))
    batch = _torch_batch(_batch(50))
    grads = []
    for remat in (False, True):
        model = _port(params[0], cfg, remat=remat)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        loss, _ = tstage1.stage1_loss_fn(model, batch, gen)
        names = [n for n, _ in model.named_parameters()]
        grads.append(dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters())))))
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7)


def test_clip_datasets_match_jax():
    """The synthetic clip and clip2 samples and their batches are the JAX
    package's."""
    for mode in ("clip", "clip2"):
        batches = []
        for data in (jdata, tdata):
            ds = data.SyntheticCTDataset(
                n=4, shape=(1, 4, 8, 8), tokenizer=data.SimpleTokenizer(vocab_size=64),
                mode=mode, args=data.DataArgs(max_text_len=12), num_slices=2,
                slice_dim=8)
            batches.append(list(data.DataLoader(ds, 2, shuffle=True, seed=3)))
        for want, got in zip(*batches):
            assert set(got) == set(want)
            for key, value in want.items():
                if isinstance(value, np.ndarray):
                    np.testing.assert_array_equal(got[key], value)
                else:
                    assert got[key] == value
        assert ("image_2d" in batches[1][0]) == (mode == "clip2")


def test_init_random_and_the_parts_left_out():
    model = init_random_(CLIPModel(to_torch_config(CLIP1), device="cpu"),
                         torch.Generator().manual_seed(0))
    assert model.logit_scale.item() == pytest.approx(np.log(1 / 0.07))
    assert model.scale().item() == pytest.approx(np.log(1 / 0.07))
    log_cfg = dataclasses.replace(to_torch_config(CLIP1), scale_is_log=True)
    assert CLIPModel(log_cfg, device="cpu").scale().item() == pytest.approx(
        1 / 0.07, rel=1e-6)
    # the legacy masked CLIP draws the same way, its masked stream's own
    # final norm included (test_torch_masked_clip.py holds it to JAX)
    masked = init_random_(MaskedCLIPModel(to_torch_config(CLIP1), device="cpu"),
                          torch.Generator().manual_seed(0))
    assert masked.scale().item() == pytest.approx(np.log(1 / 0.07))
    assert torch.equal(masked.vision_encoder.norm_masked.weight,
                       torch.ones(CLIP1.vision.hidden_size))
    step = tstage1.make_stage1_train_step(model, tts.make_optimizer(
        to_torch_config(TRAIN_CFG)))
    with pytest.raises(TypeError):  # a stage step without its seed
        step(None, {})
