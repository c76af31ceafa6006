"""Sequence parallelism of the port (`hsenet_torch.parallel.sp`,
`ops/ring_attention.py`) over four gloo ranks on the CPU, against the JAX
package's sp functions (`parallel/sp.py`, `ops/ring_attention.py`) on a
mesh of its virtual CPU devices with the same (dp, sp), in f32 at toy size
with every dropout rate at 0. The cases follow the JAX package's
`tests/test_sp.py`.

The ranks start once for the whole file (`_torch_parallel_worker.py`) and
run while the JAX side computes; each test reads its case.

  * The ring at sp = 4 against the JAX ring: dense, tail padding (`kv_len`),
    causal, GQA with per-row `kv_lens`, `block_q` 4, 5 (not dividing the
    6-token chunk) and 16, and the gradients of q, k and v through the
    ring (autograd through `ppermute`), at 2e-6 (outputs) and 5e-6
    (gradients) absolute: the JAX package's own limits between its ring
    and dense attention.
  * `sp_encode_tokens` (plain and slice-guided) at (dp 2, sp 2) against the
    JAX package's at 2e-5.
  * The sp train steps at (dp 2, sp 2): stage 1, stage 2 (teacher
    recomputed and cached, and the cache's fill over the ring), the causal
    LM (also with `block_q`) and the VLM. The first step's loss, gradient
    norm and gradients equal the JAX sp step's at 1e-4 (its gradients read
    from one SGD step at learning rate 1), and the leaves after two AdamW
    steps equal the port's plain step's on the global batch within 1e-5
    (`test_torch_parallel_dp.py`'s limit).
  * The CLIs at their `--synthetic` sizes, from the JAX CLIs' own initial
    parameters: `train_vlm --remat`, `train_clip_stage1` and
    `train_clip_stage2 --cached-teacher` (its teacher the JAX stage 1's
    export, bridged; the cache filled over the ring) at --dp 2 --sp 2 log
    the JAX CLIs' losses and gradient norms at 1e-4 relative, the JAX CLIs
    on a (dp 2, sp 2) mesh (stage 2 with its teacher recomputed: the JAX
    cached loader's order is its own, ROADMAP §C); the CLIP CLIs also log
    what --dp 4 logs (slice dropout at 0 in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import hsenet_tpu.cli.train_clip_stage1 as jcli1
import hsenet_tpu.cli.train_clip_stage2 as jcli2
import hsenet_tpu.cli.train_vlm as jvlm
import hsenet_tpu.parallel.sp as jsp
from _torch_parallel_worker import launch
from hsenet_tpu.configs import MeshConfig, Phi3Config
from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_tpu.models.vit import ViT3D as JaxViT
from hsenet_tpu.ops.ring_attention import ring_attention as jax_ring
from hsenet_tpu.parallel.mesh import create_mesh
from hsenet_tpu.parallel.pipeline import _shard_map
from hsenet_tpu.train.stage2 import TeacherCache, make_teacher_embed_fn
from hsenet_tpu.train.train_state import TrainState as JaxTrainState
from hsenet_tpu.train.vlm import vlm_trainable_mask as jax_mask
from hsenet_tpu.utils.checkpoint import restore_params as jax_restore_params
import hsenet_torch.configs as tcfg
import hsenet_torch.parallel.mesh as tmesh
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from hsenet_torch.models.vit import ViT3D
from hsenet_torch.utils.checkpoint import save_params
from test_pipeline import TINY_ARGS
from test_torch_clip import CLIP1, CLIP2, TRAIN_CFG, _batch, _jax_args, _port
from test_torch_common import TINY_LLM, TINY_VLM, fill_zero_inits, to_torch_config
from test_torch_parallel_cli import _jax_run
from test_torch_parallel_dp import _vlm_batch, _vlm_port
from test_torch_train_cli import clip_model, jax_cfg_of, no_slice_dropout
from test_torch_train_vlm_cli import no_dropout, port_model

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
RING_TOL, RING_GRAD_TOL = 2e-6, 5e-6
LM = Phi3Config(**{**{f: getattr(TINY_LLM, f) for f in (
    "vocab_size", "hidden_size", "intermediate_size", "num_heads",
    "num_kv_heads", "head_dim", "tie_word_embeddings")}, "num_layers": 2})
STEPS = ["--total-steps", "3", "--log-every", "1", "--learning-rate", "1e-3",
         "--eval-every", "0"]
CLIP_ARGV = [a for a in TINY_ARGS if a not in ("--dp", "1")] + STEPS
STAGE2_ARGV = [a for a in TINY_ARGS if a not in ("--dp", "1")] + STEPS + [
    "--cached-teacher"]
VLM_ARGV = ["--synthetic", "--task", "mrg", "--batch-size", "4", "--dtype",
            "float32", "--checkpoint-every", "1000", "--remat"] + STEPS


def _ring_inputs(rng, b, h, s, d, hkv=None, grads=False):
    hkv = hkv or h
    out = {"q": rng.standard_normal((b, h, s, d)).astype(np.float32),
           "k": rng.standard_normal((b, hkv, s, d)).astype(np.float32),
           "v": rng.standard_normal((b, hkv, s, d)).astype(np.float32)}
    if grads:
        out["w"] = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return out


def _ring_cases():
    rng = np.random.default_rng(0)
    cases = {
        "dense": _ring_inputs(rng, 2, 3, 40, 16),
        "padded": {**_ring_inputs(rng, 1, 2, 40, 8), "kwargs": {"kv_len": 37}},
        "causal": {**_ring_inputs(rng, 2, 2, 32, 8), "kwargs": {"causal": True}},
        "gqa_lens": {**_ring_inputs(rng, 3, 4, 24, 8, hkv=2), "kwargs": {
            "causal": True, "kv_lens": np.asarray([24, 13, 7], np.int32)}},
        "grads": _ring_inputs(rng, 1, 2, 24, 8, grads=True),
    }
    block = _ring_inputs(rng, 2, 2, 24, 8, grads=True)
    for bq in (None, 4, 5, 16):
        cases[f"block_{bq}"] = {**block, "kwargs": {
            "causal": True, "kv_lens": np.asarray([20, 11], np.int32),
            "block_q": bq}}
    return cases


def _jax_ring_case(c):
    """The JAX ring at sp = 4 on the first four devices: (output, grads of
    sum(out * w) by q, k, v or None)."""
    mesh = create_mesh(MeshConfig(dp=1, sp=4))
    kw = dict(c.get("kwargs", {}))
    lens = kw.pop("kv_lens", None)
    spec = P(None, None, "sp")
    q, k, v = (jnp.asarray(c[x]) for x in ("q", "k", "v"))

    def local(q, k, v, lens):
        return jax_ring(q, k, v, axis_name="sp", axis_size=4,
                        kv_lens=lens, **kw)

    lens = jnp.asarray(lens if lens is not None else
                       np.full(q.shape[0], q.shape[2], np.int32))
    fn = _shard_map(local, mesh=mesh, in_specs=(spec, spec, spec, P()),
                    out_specs=spec, check_vma=False)
    out = np.asarray(jax.jit(fn)(q, k, v, lens))
    if "w" not in c:
        return out, None
    w = jnp.asarray(c["w"])
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, lens) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return out, [np.asarray(g) for g in grads]


def _sgd_grads(step, params, *args):
    """(metrics, gradients by port name) of one JAX step at SGD lr 1 from
    `params`: the gradient is what the step subtracted."""
    state = JaxTrainState.create(jax.tree.map(jnp.copy, params), optax.sgd(1.0))
    new, metrics = step(state, *args)
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         params, new.params)
    return {k: float(v) for k, v in metrics.items()}, flax_to_torch(grads)


def _lm_batch(seed=3, b=4, seq=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (b, seq))
    lens = np.asarray([12, 9, 6, 12])[:b]
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int64)
    labels = np.where(mask == 1, ids, -100)
    labels[:, :2] = -100
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


def _vit_inputs(seed, slice_guided):
    rng = np.random.default_rng(seed)
    out = {"volume": rng.random((4, 1, 8, 16, 16), np.float32)}
    if slice_guided:
        out["slices"] = rng.standard_normal((4, 4, 32)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    key = jax.random.PRNGKey(0)
    ring = _ring_cases()
    # ViT3D (stage-1 and 2E3) of test_torch_clip's CLIP: 65 tokens, 33 a rank
    vits = {}
    for name, cfg in (("plain", CLIP1.vision), ("slice_guided", CLIP2.vision)):
        inputs = _vit_inputs(4, cfg.slice_guided)
        args = [jnp.asarray(inputs["volume"][:1])] + (
            [jnp.asarray(inputs["slices"][:1])] if cfg.slice_guided else [])
        variables = fill_zero_inits(jax.tree.map(
            np.asarray, JaxViT(cfg).init(key, *args)), 5)
        model = ViT3D(to_torch_config(cfg), device="cpu")
        model.load_state_dict(flax_to_torch(variables), strict=True)
        vits[name] = dict(variables=variables, inputs=inputs, model=model.eval())
    batch = _batch()
    v1 = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(JaxCLIP(CLIP1).init)(
        key, *_jax_args(batch, False))), 2)
    v2 = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(JaxCLIP(CLIP2).init)(
        jax.random.PRNGKey(1), *_jax_args(batch, True))), 3)
    lm_batch = _lm_batch()
    lm_vars = fill_zero_inits(jax.tree.map(np.asarray, JaxLM(LM).init(
        key, jnp.asarray(lm_batch["input_ids"][:1]))), 6)
    lm_port = Phi3ForCausalLM(to_torch_config(LM), dtype=torch.float32, device="cpu")
    lm_port.load_state_dict(flax_to_torch(lm_vars), strict=True)
    vbatch = _vlm_batch(b=4)
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    vparams = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(jm.init)(
        key, jnp.asarray(vbatch["input_ids"]), jnp.asarray(vbatch["image"]),
        jnp.asarray(vbatch["image_2d"]))), 0)
    train_cfg = to_torch_config(TRAIN_CFG)
    cases = [
        ("ring", ring),
        ("sp_encode", {n: dict(model=v["model"], inputs=v["inputs"])
                       for n, v in vits.items()}),
        ("sp_steps", dict(
            train_cfg=train_cfg,
            clip=dict(batch=batch, stage1=_port(v1, CLIP1), stage2=_port(v2, CLIP2),
                      cfg2=to_torch_config(CLIP2)),
            lm=dict(batch=lm_batch, model=lm_port),
            vlm=dict(batch=vbatch, model=_vlm_port(vparams)))),
    ]
    collect = launch(root / "steps", cases, world=4)
    sp = ["--dp", "2", "--sp", "2"]
    with no_dropout():
        jvlm_log, jvlm_init = _jax_run(
            jvlm, VLM_ARGV + sp + ["--output-dir", str(root / "jax_vlm")])
    # the JAX CLIP CLIs on the (dp 2, sp 2) mesh; stage 2's teacher is the
    # JAX stage 1's export (bridged for the port)
    jclip = {}
    jclip["stage1"] = _jax_run(jcli1, CLIP_ARGV + sp + ["--output-dir",
                                                      str(root / "jax_clip1")])
    jax_export = str(root / "jax_clip1" / "clip_params")
    teacher = str(root / "teacher.pt")
    save_params(teacher, flax_to_torch(jax_restore_params(
        jax_export, jax.tree.map(np.asarray, jclip["stage1"][1]))))
    # the teacher recomputed: the JAX CLI's cached loader draws another
    # order (ROADMAP §C), the port's cached run the recomputed one's
    with pytest.MonkeyPatch.context() as mp:
        no_slice_dropout(mp)
        jclip["stage2"] = _jax_run(jcli2, STAGE2_ARGV[:-1] + sp + [
            "--stage1-checkpoint", jax_export, "--output-dir",
            str(root / "jax_clip2")])
    clis = []
    for name, cli, argv, extra in (
            ("stage1", "train_clip_stage1", CLIP_ARGV, []),
            ("stage2", "train_clip_stage2", STAGE2_ARGV,
             ["--stage1-checkpoint", teacher])):
        model = clip_model(jax_cfg_of(root / f"jax_clip{name[-1]}"),
                           jclip[name][1])
        clis.append(dict(
            cli=f"hsenet_torch.cli.{cli}", model=model, no_slice_dropout=True,
            runs=[argv + extra + sp + ["--output-dir", str(root / f"{cli}_sp")],
                  argv + extra + ["--dp", "4", "--output-dir",
                                  str(root / f"{cli}_dp")]]))
    collect_cli = launch(root / "cli", [
        ("train_vlm_cli", dict(
            cli="hsenet_torch.cli.train_vlm",
            argv=VLM_ARGV + sp + ["--output-dir", str(root / "port_vlm")],
            model=port_model(jvlm_init))),
        ("clip_clis", clis)], world=4)

    ref = {"ring": {n: _jax_ring_case(c) for n, c in ring.items()
                    if n in ("dense", "padded", "causal", "gqa_lens", "grads",
                             "block_None")}}
    mesh = create_mesh(MeshConfig(dp=2, sp=2))
    ref["encode"] = {}
    for name, v in vits.items():
        enc = jsp.make_sp_encode_fn(JaxViT(CLIP2.vision if name != "plain"
                                           else CLIP1.vision), mesh)
        args = [jnp.asarray(v["inputs"]["volume"])] + (
            [jnp.asarray(v["inputs"]["slices"])] if "slices" in v["inputs"] else [])
        ref["encode"][name] = np.asarray(enc(v["variables"], *args))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    student, teacher = JaxCLIP(CLIP2), JaxCLIP(CLIP1)
    rng = jax.random.key(7)
    ref["stage1"] = _sgd_grads(
        jsp.make_sp_stage1_train_step(JaxCLIP(CLIP1), optax.sgd(1.0), mesh), v1, jb, rng)
    ref["stage2_recomputed"] = _sgd_grads(jsp.make_sp_stage2_train_step(
        student, teacher, CLIP2, optax.sgd(1.0), v1, mesh), v2, jb, rng)
    cache = TeacherCache(make_teacher_embed_fn(teacher, v1, mesh))
    ref["stage2_cached"] = _sgd_grads(jsp.make_sp_stage2_train_step(
        student, teacher, CLIP2, optax.sgd(1.0), v1, mesh, cached_teacher=True),
        v2, {k: jnp.asarray(v) for k, v in cache.attach(batch).items()}, rng)
    ref["fill"] = {k: np.asarray(v) for k, v in jsp.make_sp_teacher_embed_fn(
        teacher, v1, mesh)(jb).items()}
    lm = JaxLM(LM, dtype=jnp.float32)
    ref["lm"] = _sgd_grads(jsp.make_sp_causal_lm_train_step(lm, optax.sgd(1.0), mesh),
                           lm_vars, {k: jnp.asarray(v) for k, v in lm_batch.items()})
    mask = jax_mask(vparams)
    ref["vlm"] = _sgd_grads(jsp.make_sp_vlm_train_step(
        jm, optax.sgd(1.0), mesh, trainable_mask=mask), vparams,
        {k: jnp.asarray(v) for k, v in vbatch.items()})
    ranks = [{**a, **b} for a, b in zip(collect(), collect_cli())]
    return dict(ranks=ranks, jax=ref, vlm_log=jvlm_log,
                clip_logs=[jclip["stage1"][0], jclip["stage2"][0]])


def _gathered_chunks(world, name, key):
    """The ring case's output (or gradient i) over the four ranks' chunks."""
    parts = [r["ring"][name][key] if isinstance(key, str) else
             r["ring"][name]["grads"][key] for r in world["ranks"]]
    return torch.cat(parts, dim=2).numpy()


@pytest.mark.parametrize("name", ["dense", "padded", "causal", "gqa_lens"])
def test_ring_attention_matches_jax(world, name):
    want, _ = world["jax"]["ring"][name]
    got = _gathered_chunks(world, name, "out")
    if name == "padded":  # only the 37 true queries are defined
        got, want = got[:, :, :37], want[:, :, :37]
    if name == "gqa_lens":  # rows past kv_lens are dropped downstream
        for row, n in enumerate((24, 13, 7)):
            np.testing.assert_allclose(got[row, :, :n], want[row, :, :n],
                                       atol=RING_TOL)
        return
    np.testing.assert_allclose(got, want, atol=RING_TOL)


def test_ring_attention_grads_match_jax(world):
    _, want = world["jax"]["ring"]["grads"]
    for i in range(3):
        np.testing.assert_allclose(_gathered_chunks(world, "grads", i), want[i],
                                   atol=RING_GRAD_TOL, err_msg="qkv"[i])


def test_ring_attention_blockwise_hop(world):
    """Query blocks (4, 5: not dividing the 6-token chunk, 16: above it)
    give the dense hop's output and gradients, which are the JAX ring's
    (causal, ragged kv_lens)."""
    want_out, want_grads = world["jax"]["ring"]["block_None"]
    dense = _gathered_chunks(world, "block_None", "out")
    for row, n in enumerate((20, 11)):
        np.testing.assert_allclose(dense[row, :, :n], want_out[row, :, :n],
                                   atol=RING_TOL)
    for i in range(3):
        np.testing.assert_allclose(_gathered_chunks(world, "block_None", i),
                                   want_grads[i], atol=RING_GRAD_TOL)
    for bq in (4, 5, 16):
        np.testing.assert_allclose(_gathered_chunks(world, f"block_{bq}", "out"),
                                   dense, atol=RING_TOL, err_msg=str(bq))
        for i in range(3):
            np.testing.assert_allclose(
                _gathered_chunks(world, f"block_{bq}", i),
                _gathered_chunks(world, "block_None", i), atol=RING_GRAD_TOL,
                err_msg=f"{bq} {'qkv'[i]}")


@pytest.mark.parametrize("name", ["plain", "slice_guided"])
def test_sp_encode_matches_jax(world, name):
    want = world["jax"]["encode"][name]
    assert want.shape[1] == 65  # 64 patches and CLS, 33 tokens a rank
    for r, rank in enumerate(world["ranks"]):
        dp = r // 2
        got = rank["sp_encode"][name].numpy()
        np.testing.assert_allclose(got, want[2 * dp:2 * dp + 2], atol=2e-5)


def assert_adam_leaf_close(name, got, want, grads, atol=1e-5, quiet=1e-5):
    """A leaf after the AdamW steps within `atol` of the plain run's, but
    where every step's gradient is below `quiet`: Adam scales a gradient
    near 0 to about a learning rate a step whatever its rounding (BERT's
    key bias has an exact gradient of 0), so there the two may part by up
    to one learning rate a step."""
    got, want = got.numpy(), want.numpy()
    near_zero = np.all([np.abs(g.numpy()) < quiet for g in grads], axis=0)
    far = np.abs(got - want) > atol
    assert not np.any(far & ~near_zero), (name, float(np.abs(got - want)[
        far & ~near_zero].max()))
    steps = len(grads)
    np.testing.assert_allclose(got, want, atol=steps * TRAIN_CFG.learning_rate,
                               err_msg=name)


def _assert_step(world, name, plain, jax_name=None, trainable=None):
    """The sp step's first-step metrics and gradients against the JAX sp
    step's, its leaves after two steps against the port's plain step's."""
    metrics, grads = world["jax"][jax_name or name]
    for rank in world["ranks"]:
        got, base = rank["sp_steps"][name], rank["sp_steps"][plain]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][0][key], metrics[key],
                                       **TOL, err_msg=key)
        names = list(got["grads"][0])
        assert names and (trainable is None or set(names) == trainable)
        for n in names:
            np.testing.assert_allclose(got["grads"][0][n].numpy(),
                                       grads[n].numpy(), **TOL, err_msg=n)
        for n, p in got["params"].items():
            assert_adam_leaf_close(n, p, base["params"][n],
                                   [g[n] for g in base["grads"]])


def test_sp_stage1_step_matches_jax(world):
    _assert_step(world, "stage1", "stage1_plain")


@pytest.mark.parametrize("mode", ["recomputed", "cached"])
def test_sp_stage2_step_matches_jax(world, mode):
    _assert_step(world, f"stage2_{mode}", "stage2_plain")


def test_sp_teacher_fill_matches_jax(world):
    want = world["jax"]["fill"]
    for r, rank in enumerate(world["ranks"]):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        for k, v in rank["sp_steps"]["fill"].items():
            np.testing.assert_allclose(v.numpy(), want[k][rows], atol=1e-5,
                                       err_msg=k)


def test_sp_causal_lm_step_matches_jax(world):
    _assert_step(world, "lm", "lm_plain")
    metrics, grads = world["jax"]["lm"]
    for rank in world["ranks"]:  # query blocks of 2 over the 3-token chunks
        got = rank["sp_steps"]["lm_block"]
        np.testing.assert_allclose(got["metrics"][0]["loss"], metrics["loss"], **TOL)
        for n, g in got["grads"][0].items():
            np.testing.assert_allclose(g.numpy(), grads[n].numpy(), **TOL, err_msg=n)


def test_sp_vlm_step_matches_jax(world):
    _assert_step(world, "vlm", "vlm_plain")


def test_mesh_sp_and_pp_axes_compose_with_dp_only():
    """Without a group: the JAX create_mesh's asserts are the port's
    ValueErrors, word for word."""
    one = jax.devices()[:1]
    for kw in ({"dp": 1, "sp": 2, "tp": 2}, {"dp": 1, "pp": 2, "tp": 2},
               {"dp": 1, "pp": 2, "sp": 2}, {"dp": 1, "sp": 2}, {"dp": 2, "pp": 2}):
        with pytest.raises(AssertionError) as jax_err:
            create_mesh(MeshConfig(**kw), devices=one)
        with pytest.raises(ValueError) as port_err:
            tmesh.create_mesh(tcfg.MeshConfig(**kw))
        assert str(port_err.value) == str(jax_err.value)


def _assert_logs(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_vlm_cli_sp_matches_jax(world):
    for rank in world["ranks"]:
        assert rank["train_vlm_cli"]["step"] == 3
        _assert_logs(rank["train_vlm_cli"]["history"], world["vlm_log"])


@pytest.mark.parametrize("stage", [0, 1], ids=["stage1", "stage2-cached"])
def test_clip_clis_sp_equal_dp(world, stage):
    """train_clip_stage1, and train_clip_stage2 --cached-teacher (the cache
    filled over the ring), at --dp 2 --sp 2 log what --dp 4 logs: the same
    global batch and loss, the towers' tokens split over the ring (the
    stage-1 sp step itself is held against the JAX package's above)."""
    for rank in world["ranks"]:
        sp, dp = rank["clip_clis"][stage]
        assert sp["step"] == dp["step"] == 3
        _assert_logs(sp["history"], dp["history"])


@pytest.mark.parametrize("stage", [0, 1], ids=["stage1", "stage2-cached"])
def test_clip_clis_sp_match_jax(world, stage):
    """train_clip_stage1, and train_clip_stage2 --cached-teacher, at --dp 2
    --sp 2 log the JAX CLIs' losses and gradient norms on the same mesh,
    from the same initial parameters (stage 2 from the same teacher, the
    JAX run recomputing it)."""
    for rank in world["ranks"]:
        sp, _ = rank["clip_clis"][stage]
        _assert_logs(sp["history"], world["clip_logs"][stage])
