"""The port's legacy masked-contrastive CLIP (models/vit.MaskedViT3D,
models/clip.MaskedCLIPModel, train/legacy_clip.py) and the Phi remat policy
"dots" against the JAX package's, on the CPU in f32 at toy size: vision
(8, 16, 16) in (2, 4, 4) patches (64 patches + CLS), hidden 32, one layer
of 2 heads in each tower, BERT with vocab 512 and 64 positions, text of 16
tokens.

Parameters come from the JAX models' init through the bridge; the JAX side
runs its attention through the Pallas kernels in interpret mode (flash mode
"always"). Every dropout rate is 0, so no random stream enters the
comparison (the JAX legacy step always runs dropout on). Both streams and
the three legacy steps agree to 1e-4 absolute and relative (f32, sums in
another order); the W8A8 static mode to 2e-3 (`test_torch_w8a8.py`'s
tower tolerance: a flipped int8 code upstream); "dots" gradients equal
"full" ones to 1e-6 and the JAX "dots" model's to 1e-5.
"""

import contextlib
import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
from torch.utils._python_dispatch import TorchDispatchMode

import hsenet_tpu.configs as jcfg
import hsenet_tpu.ops.attention as jattn
import hsenet_tpu.train.legacy_clip as jlegacy
from hsenet_tpu.models.clip import MaskedCLIPModel as JaxMaskedCLIP
from hsenet_tpu.models.lora import VIT_QUANT_TARGETS as JAX_VIT_TARGETS
from hsenet_tpu.models.lora import calibrate_w8a8_act_scales as jax_calibrate
from hsenet_tpu.models.lora import quantize_kernels_int8 as jax_quantize
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxPhi3
from hsenet_tpu.models.vit import MaskedViT3D as JaxMaskedViT
from hsenet_tpu.train import train_state as jts
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.configs import LoRAConfig
from hsenet_torch.models import layers
from hsenet_torch.models.clip import MaskedCLIPModel
from hsenet_torch.models.lora import (
    LoRADense,
    calibrate_w8a8_act_scales,
    quantize_towers_w8a8,
)
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from hsenet_torch.models.vit import MaskedViT3D
from hsenet_torch.train import legacy_clip as tlegacy
from hsenet_torch.train import train_state as tts
from test_torch_common import fill_zero_inits, load_flax, to_np, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
TOWER_TOL = dict(atol=2e-3, rtol=2e-3)
VIT = jcfg.ViT3DConfig(
    image_size=(8, 16, 16), patch_size=(2, 4, 4), hidden_size=32, mlp_dim=64,
    num_layers=1, num_heads=2, num_slices=4, slice_feature_dim=32,
    slice_dropout_rate=0.0,
)
CLIP = jcfg.CLIPConfig(
    vision=VIT, projection_dim=32, max_text_len=16,
    text=jcfg.BertConfig(vocab_size=512, hidden_size=32, num_layers=1,
                         num_heads=2, intermediate_size=64,
                         max_position_embeddings=64),
)
TRAIN_CFG = jcfg.TrainConfig(total_steps=10, learning_rate=1e-3)
B, SEQ = 4, 16
# the legacy ramp at steps 0, 5000 and 20000 over 64 patches
BUCKETS = (64, 56, 40)


@contextlib.contextmanager
def jax_flash_always():
    try:
        jattn.set_flash_mode("always")
        yield
    finally:
        jattn.set_flash_mode("auto")


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, SEQ), np.int32)
    for row in range(b):
        mask[row, :SEQ - 3 * row] = 1
    return {
        "image": rng.random((b, 1, *VIT.image_size), np.float32),
        "image_2d": rng.standard_normal((b, 4, 32)).astype(np.float32),
        "input_ids": np.where(mask == 1, rng.integers(1, 512, (b, SEQ)), 0),
        "attention_mask": mask,
    }


def _jax_args(batch):
    return [jnp.asarray(batch[k]) for k in
            ("image", "input_ids", "attention_mask", "image_2d")]


@pytest.fixture(scope="module")
def params():
    variables = jax.jit(JaxMaskedCLIP(CLIP).init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *_jax_args(_batch()), 48)
    return fill_zero_inits(jax.tree.map(np.asarray, variables), 1)


def _port(variables, cfg=CLIP):
    return load_flax(MaskedCLIPModel(to_torch_config(cfg), device="cpu"),
                     variables)


@pytest.mark.parametrize("unmasked", [None, 64, 40, 9],
                         ids=["full-only", "all-kept", "bucket-40", "ragged-9"])
def test_masked_clip_equals_jax(params, unmasked):
    batch = _batch(1)
    with jax_flash_always():
        want = jax.jit(JaxMaskedCLIP(CLIP).apply, static_argnums=(5,))(
            params, *_jax_args(batch), unmasked)
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got = _port(params)(t["image"], t["input_ids"], t["attention_mask"],
                            t["image_2d"], unmasked)
    assert len(got) == len(want) == (3 if unmasked is None else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


def _vit_variables(params):
    return {"params": params["params"]["vision_encoder"]}


def test_masked_vit_streams_equal_jax(params):
    """Both streams of the vision encoder alone, token by token: the masked
    one holds CLS and the kept patches, normalised by `norm_masked`."""
    batch = _batch(2)
    variables = _vit_variables(params)
    with jax_flash_always():
        full, masked = JaxMaskedViT(VIT).apply(
            variables, jnp.asarray(batch["image"]), jnp.asarray(batch["image_2d"]),
            24)
    tm = load_flax(MaskedViT3D(to_torch_config(VIT), device="cpu"), variables)
    with torch.no_grad():
        got_full, got_masked = tm(torch.as_tensor(batch["image"]),
                                  torch.as_tensor(batch["image_2d"]), 24)
        only_full = tm(torch.as_tensor(batch["image"]),
                       torch.as_tensor(batch["image_2d"]))
    assert got_masked.shape == (B, 25, VIT.hidden_size)
    np.testing.assert_allclose(to_np(got_full), np.asarray(full), **TOL)
    np.testing.assert_allclose(to_np(got_masked), np.asarray(masked), **TOL)
    torch.testing.assert_close(only_full, got_full, rtol=0, atol=0)


@pytest.mark.parametrize("saturated", ["all", "half"])
def test_score_ties_keep_the_jax_tokens(params, saturated):
    """Scores that tie (the f32 sigmoid at 1.0) keep the lower index first,
    as jax.lax.top_k does: planted by a zero score weight and a bias of 40
    (every patch ties), or a weight on one input feature that saturates
    about half of them."""
    variables = jax.tree.map(np.copy, _vit_variables(params))
    proj = variables["params"]["patch_score_proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = 40.0
    if saturated == "half":
        proj["kernel"][0, 0] = 400.0
        proj["bias"][:] = 0.0
    batch = _batch(3)
    with jax_flash_always():
        _, want = JaxMaskedViT(VIT).apply(
            variables, jnp.asarray(batch["image"]), jnp.asarray(batch["image_2d"]),
            16)
    tm = load_flax(MaskedViT3D(to_torch_config(VIT), device="cpu"), variables)
    with torch.no_grad():
        _, got = tm(torch.as_tensor(batch["image"]),
                    torch.as_tensor(batch["image_2d"]), 16)
        x = tm.patch_embed(torch.as_tensor(batch["image"]))
        sf = torch.as_tensor(batch["image_2d"])
        scores = torch.sigmoid(tm.patch_score_proj(
            tm.slice_guided_attention(x, sf, sf)[0]))[..., 0]
    ones = (scores == 1.0).sum(dim=1)
    assert (ones > 16).all() if saturated == "all" else (ones > 16).any()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_bucketed_unmasked_tokens_equal_jax():
    for n in (64, 2048):
        for step in range(0, 60001, 250):
            assert tlegacy.update_mask_ratio(step) == jlegacy.update_mask_ratio(step)
            for buckets in (8, 16):
                assert (tlegacy.bucketed_unmasked_tokens(step, n, buckets)
                        == jlegacy.bucketed_unmasked_tokens(step, n, buckets))
    assert tuple(tlegacy.bucketed_unmasked_tokens(s, 64) for s in
                 (0, 5000, 20000)) == BUCKETS
    assert tuple(tlegacy.bucketed_unmasked_tokens(s, 2048) for s in
                 (0, 5000, 20000)) == (2048, 1792, 1280)


def test_legacy_train_steps_equal_jax(params):
    """Three steps at three buckets: the JAX step's metrics and parameters.
    BERT's key bias has an exact gradient of 0 and is held to one learning
    rate a step (as in `test_torch_clip.py`)."""
    batches = [_batch(10 + i) for i in range(3)]
    tx = jts.make_optimizer(TRAIN_CFG)
    state = jts.TrainState.create(jax.tree.map(jnp.array, params), tx)
    step = jlegacy.make_masked_clip_train_step(JaxMaskedCLIP(CLIP), tx)
    want = []
    with jax_flash_always():
        for batch, n in zip(batches, BUCKETS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(7), n)
            want.append({k: float(v) for k, v in m.items()})
    want_params = flax_to_torch(jax.tree.map(np.asarray, state.params))

    model = _port(params).train()
    ttx = tts.make_optimizer(to_torch_config(TRAIN_CFG))
    tstate = tts.TrainState.create(model, ttx)
    tstep = tlegacy.make_masked_clip_train_step(model, ttx)
    got = []
    for batch, n in zip(batches, BUCKETS):
        tstate, m = tstep(tstate, {k: torch.as_tensor(v) for k, v in batch.items()},
                          7, n)
        got.append({k: float(v) for k, v in m.items()})
    assert tstate.step == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "loss_unmasked", "loss_masked",
                                    "retrieval_acc"}
        for key in w:
            np.testing.assert_allclose(g[key], w[key], **TOL, err_msg=key)
    key_bias = dict(atol=TRAIN_CFG.learning_rate * 3, rtol=0)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            to_np(p), want_params[name].numpy(), err_msg=name,
            **(key_bias if name.endswith(".k.bias") else TOL))


def test_w8a8_static_streams_equal_jax(params):
    """MaskedViT3D with int8 tower blocks and calibrated static activation
    scales (both streams calibrate each layer): equal to the JAX W8A8 model,
    and each token within cosine 0.98 of the float model's."""
    cfg = dataclasses.replace(VIT, quant_w8a8=True, quant_w8a8_static=True)
    batch = _batch(4)
    args = (jnp.asarray(batch["image"]), jnp.asarray(batch["image_2d"]), 40)
    float_vars = _vit_variables(params)
    jparams = {"params": {k: (jax_quantize(v, JAX_VIT_TARGETS) if k == "tower"
                              else v)
                          for k, v in flax.core.unfreeze(float_vars)["params"].items()}}
    jm = JaxMaskedViT(cfg)
    with jax_flash_always():
        jparams = {"params": jax_calibrate(jm.apply, jparams, [args])}
        want = jm.apply(jparams, *args)
        ref = JaxMaskedViT(VIT).apply(float_vars, *args)
    tm = MaskedViT3D(to_torch_config(cfg), device="cpu")
    tm.load_state_dict(quantize_towers_w8a8(flax_to_torch(float_vars), static=True),
                       strict=True)
    targs = (torch.as_tensor(batch["image"]), torch.as_tensor(batch["image_2d"]), 40)
    calibrate_w8a8_act_scales(tm.eval(), [targs])
    for name, value in flax_to_torch(jparams).items():
        if name.endswith("weight_q"):
            assert torch.equal(tm.state_dict()[name], value), name
        elif name.endswith("act_scale"):  # the largest |activation| seen
            np.testing.assert_allclose(to_np(tm.state_dict()[name]),
                                       value.numpy(), rtol=1e-5, err_msg=name)
    with torch.no_grad():
        got = tm(*targs)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOWER_TOL)
        a = to_np(g).reshape(-1, VIT.hidden_size)
        b = np.asarray(r).reshape(-1, VIT.hidden_size)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() > 0.98, cos.min()


# ------------------------------------------------------- remat policy "dots"

PHI = jcfg.Phi3Config(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=True,
    lora=jcfg.LoRAConfig(rank=2, alpha=4, dropout_rate=0.0),
)


def _phi_port(cfg, variables, policy, remat=True):
    cfg = dataclasses.replace(to_torch_config(cfg), remat_policy=policy)
    model = Phi3ForCausalLM(cfg, dtype=torch.float32, device="cpu", remat=remat)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model


def _phi_grads(model, ids, generator=None):
    model.zero_grad()
    with layers.dropout_rng(generator):
        logits, _ = model(torch.as_tensor(ids), deterministic=generator is None)
    loss = (logits[:, :-1].float() ** 2).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_dots_gradients_equal_full_and_jax():
    """The JAX package's test_remat_policy_dots_matches_full on both
    packages: "dots" gives "full"'s loss and gradients, and the JAX "dots"
    model's."""
    ids = np.random.default_rng(0).integers(1, PHI.vocab_size, (2, 10))
    jcfg_dots = dataclasses.replace(PHI, remat_policy="dots")
    jm = JaxPhi3(jcfg_dots, dtype=jnp.float32, remat=True)
    variables = fill_zero_inits(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))), 3)

    def jloss(p):
        logits, _ = jm.apply(p, jnp.asarray(ids))
        return jnp.mean(logits[:, :-1].astype(jnp.float32) ** 2)

    with jax_flash_always():
        jl, jg = jax.value_and_grad(jloss)(variables)
    want = flax_to_torch(jax.tree.map(np.asarray, jg))
    l_full, g_full = _phi_grads(_phi_port(PHI, variables, "full"), ids)
    l_dots, g_dots = _phi_grads(_phi_port(PHI, variables, "dots"), ids)
    torch.testing.assert_close(l_dots, l_full, rtol=1e-6, atol=1e-6)
    assert float(l_dots) == pytest.approx(float(jl), rel=1e-5)
    for name, g in g_dots.items():
        torch.testing.assert_close(g, g_full[name], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(to_np(g), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_remat_dots_replays_dropout():
    """With LoRA dropout on, the "dots" recompute draws the masks of the
    first run, as "full" does: equal gradients to those without remat."""
    cfg = dataclasses.replace(PHI, lora=dataclasses.replace(PHI.lora,
                                                            dropout_rate=0.3))
    ids = np.random.default_rng(1).integers(1, PHI.vocab_size, (2, 12))
    variables = fill_zero_inits(jax.tree.map(np.asarray, JaxPhi3(cfg).init(
        jax.random.PRNGKey(1), jnp.asarray(ids))), 4)
    out = {}
    for policy, remat in (("full", False), ("full", True), ("dots", True)):
        out[policy, remat] = _phi_grads(_phi_port(cfg, variables, policy, remat),
                                        ids, torch.Generator().manual_seed(5))
    base_loss, base = out["full", False]
    for key in (("full", True), ("dots", True)):
        loss, grads = out[key]
        torch.testing.assert_close(loss, base_loss, rtol=1e-6, atol=1e-6)
        for name, g in grads.items():
            torch.testing.assert_close(g, base[name], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="remat policy"):
        layers.checkpointed(torch.nn.Identity(), torch.ones(1), deterministic=True,
                            policy="everything")


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in layers.DOT_OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_dots_policy_sees_2d_products_of_lora_dense(bias):
    """What the policy sees for a LoRADense on a (B, S, D) input: autograd
    flattens each product to a 2-D aten.addmm (base with bias) or aten.mm
    (base without bias, both adapter products), never a batched product.
    Under "dots" the backward recomputes none of them; under "full" it
    recomputes the two whose outputs it needs."""
    seen = []

    def recording(ctx, op, *args, **kwargs):
        seen.append(op)
        return layers._save_dots(ctx, op, *args, **kwargs)

    layer = LoRADense(16, 24, use_bias=bias, lora=LoRAConfig(rank=4, alpha=8),
                      device="cpu")
    torch.nn.init.normal_(layer.lora_b)
    x = torch.randn(2, 5, 16, requires_grad=True)
    out = checkpoint(layer, x, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, recording))
    products = [op for op in seen if op in layers.DOT_OPS]
    base = torch.ops.aten.addmm.default if bias else torch.ops.aten.mm.default
    assert products == [base, torch.ops.aten.mm.default, torch.ops.aten.mm.default]
    assert not any("bmm" in str(op) or "matmul" in str(op) for op in seen)
    torch.testing.assert_close(out, layer(x))
    counts = {}
    for policy in ("full", "dots"):
        y = layers.checkpointed(lambda t, deterministic: layer(t), x,
                                deterministic=True, policy=policy)
        with _CountProducts() as c:
            y.sum().backward()
        counts[policy] = c.n
    assert counts == {"full": 8, "dots": 6}  # the backward's own 6 products
