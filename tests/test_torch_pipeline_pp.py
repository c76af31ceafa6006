"""Pipeline parallelism of the port (`hsenet_torch.parallel.pipeline`) over
four gloo ranks on the CPU, against the JAX package's GPipe
(`parallel/pipeline.py`) on a mesh of its virtual CPU devices with the same
(dp, pp), in f32 at toy size with every dropout rate at 0. The cases follow
the JAX package's `tests/test_pipeline_pp.py`.

The ranks start once for the whole file (`_torch_parallel_worker.py`) and
run while the JAX side computes; each test reads its case.

  * The causal LM's logits at (dp 1, pp 4), one layer a stage, against the
    JAX pipeline's at 1e-5; its masked-LM loss and every gradient (the
    stages' layers gathered) at (dp 2, pp 2), 2 microbatches, against
    `jax.grad` through the JAX pipeline at 1e-4.
  * The causal-LM and VLM train steps at (dp 2, pp 2): the first step's
    loss, gradient norm and gradients equal the JAX pp step's at 1e-4 (read
    from one SGD step at learning rate 1), and the leaves after two AdamW
    steps equal the port's plain step's on the global batch within 1e-5
    (`test_torch_parallel_dp.py`'s limit).
  * Each stage holds only its own layers, and the VLM's towers stay whole;
    layers that do not divide by pp raise the JAX CLI's message.
  * `train_vlm --dp 2 --pp 2 --n-micro 2` at its `--synthetic` size logs the
    JAX CLI's losses and gradient norms at 1e-4 relative. A run that
    checkpoints at step 2 resumes under --dp 4 (pp 1) and under --pp 2
    again, each logging what --dp 4 logs resuming a --dp 4 run's step 2,
    and its vlm_deltas hold every layer's adapters.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hsenet_tpu.cli.train_vlm as jvlm
from _torch_parallel_worker import launch
from hsenet_tpu.configs import MeshConfig, Phi3Config
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_tpu.parallel.mesh import create_mesh
from hsenet_tpu.parallel.pipeline import (
    make_pp_causal_lm_forward,
    make_pp_causal_lm_train_step,
    make_pp_vlm_train_step,
    shard_params_pp,
)
from hsenet_tpu.train.losses import masked_lm_loss
from hsenet_tpu.train.vlm import vlm_trainable_mask as jax_mask
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from test_torch_clip import TRAIN_CFG
from test_torch_common import TINY_VLM, fill_zero_inits, to_torch_config
from test_torch_parallel_cli import _jax_run
from test_torch_parallel_dp import _vlm_batch, _vlm_port
from test_torch_sp import _assert_logs, _sgd_grads, _assert_step
from test_torch_train_vlm_cli import no_dropout, port_model

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = Phi3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8,
                  tie_word_embeddings=True)
STEPS = ["--log-every", "1", "--learning-rate", "1e-3", "--eval-every", "0"]
VLM_ARGV = ["--synthetic", "--task", "mrg", "--batch-size", "4", "--dtype",
            "float32"] + STEPS
PP = ["--dp", "2", "--pp", "2", "--n-micro", "2"]


def _lm_inputs(b=8, seq=12):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, TINY.vocab_size, (b, seq))
    kv_lens = rng.integers(seq // 2, seq + 1, (b,)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    mask = (np.arange(seq)[None] < kv_lens[:, None]).astype(np.int64)
    batch = {"input_ids": ids[:4], "labels": labels[:4], "attention_mask": mask[:4]}
    return ids, kv_lens, labels, batch


def _port_lm(variables, cfg=TINY):
    model = Phi3ForCausalLM(to_torch_config(cfg), dtype=torch.float32, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    ids, kv_lens, labels, batch = _lm_inputs()
    model = JaxLM(TINY, dtype=jnp.float32)
    lm_vars = fill_zero_inits(jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids[:1]))), 1)
    odd = JaxLM(Phi3Config(**{**TINY.__dict__, "num_layers": 3}), dtype=jnp.float32)
    odd_vars = jax.tree.map(np.asarray, odd.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(ids[:1])))
    vbatch = _vlm_batch(b=4)
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    vparams = fill_zero_inits(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(vbatch["input_ids"]),
        jnp.asarray(vbatch["image"]), jnp.asarray(vbatch["image_2d"]))), 0)
    cases = [("pp", dict(
        lm=dict(model=_port_lm(lm_vars), ids=ids, kv_lens=kv_lens, labels=labels,
                batch=batch),
        vlm=dict(model=_vlm_port(vparams), batch=vbatch),
        odd=_port_lm(odd_vars, Phi3Config(**{**TINY.__dict__, "num_layers": 3})),
        train_cfg=to_torch_config(TRAIN_CFG)))]
    collect = launch(root / "steps", cases, world=4)
    with no_dropout():
        jvlm_log, jvlm_init = _jax_run(
            jvlm, VLM_ARGV + PP + ["--total-steps", "3", "--checkpoint-every",
                                   "1000", "--output-dir", str(root / "jax_vlm")])
    out = {n: str(root / n) for n in ("full", "cut", "dp4", "pp2", "cut_dp4",
                                      "dp4_of_dp4")}
    collect_cli = launch(root / "cli", [("resume_cli", dict(
        cli="hsenet_torch.cli.train_vlm", model=port_model(jvlm_init), runs=[
            VLM_ARGV + PP + ["--total-steps", "3", "--checkpoint-every", "1000",
                             "--output-dir", out["full"]],
            VLM_ARGV + PP + ["--total-steps", "2", "--checkpoint-every", "1",
                             "--output-dir", out["cut"]],
            VLM_ARGV + ["--dp", "4", "--total-steps", "3", "--checkpoint-every",
                        "1000", "--resume", out["cut"], "--output-dir", out["dp4"]],
            VLM_ARGV + PP + ["--total-steps", "3", "--checkpoint-every", "1000",
                             "--resume", out["cut"], "--output-dir", out["pp2"]],
            VLM_ARGV + ["--dp", "4", "--total-steps", "2", "--checkpoint-every",
                        "1", "--output-dir", out["cut_dp4"]],
            VLM_ARGV + ["--dp", "4", "--total-steps", "3", "--checkpoint-every",
                        "1000", "--resume", out["cut_dp4"], "--output-dir",
                        out["dp4_of_dp4"]],
        ]))], world=4)

    ref = {}
    mesh4 = create_mesh(MeshConfig(dp=1, pp=4))
    fwd = jax.jit(make_pp_causal_lm_forward(model, mesh4, n_micro=2))
    ref["logits"] = np.asarray(fwd(shard_params_pp(lm_vars, mesh4),
                                   jnp.asarray(ids), jnp.asarray(kv_lens)))
    mesh = create_mesh(MeshConfig(dp=2, pp=2))
    fwd = make_pp_causal_lm_forward(model, mesh, n_micro=2)

    def pp_loss(p):
        return masked_lm_loss(fwd(p, jnp.asarray(ids[:4]), jnp.asarray(kv_lens[:4])),
                              jnp.asarray(labels[:4]))[0]

    loss, grads = jax.jit(jax.value_and_grad(pp_loss))(shard_params_pp(lm_vars, mesh))
    ref["loss"] = float(loss)
    ref["grads"] = flax_to_torch(jax.tree.map(np.asarray, grads))
    ref["lm"] = _sgd_grads(make_pp_causal_lm_train_step(
        model, optax.sgd(1.0), mesh, n_micro=2), lm_vars,
        {k: jnp.asarray(v) for k, v in batch.items()})
    mask = jax_mask(vparams)
    ref["vlm"] = _sgd_grads(make_pp_vlm_train_step(
        jm, optax.sgd(1.0), mesh, n_micro=2, trainable_mask=mask), vparams,
        {k: jnp.asarray(v) for k, v in vbatch.items()})
    with pytest.raises(AssertionError):
        make_pp_causal_lm_forward(odd, mesh4, n_micro=2)
    ranks = [{**a, **b} for a, b in zip(collect(), collect_cli())]
    return dict(ranks=ranks, jax=ref, vlm_log=jvlm_log)


def test_pp_forward_matches_jax(world):
    for rank in world["ranks"]:  # every stage holds the logits
        np.testing.assert_allclose(rank["pp"]["logits"].numpy(),
                                   world["jax"]["logits"], atol=1e-5)


def test_pp_grads_match_jax(world):
    """Backward through the pipeline (each stage's gradient of its input
    sent back, microbatches accumulated) gives JAX's gradients of every
    leaf, the token table's (from the lookup on stage 0 and the tied head
    on every stage) included."""
    want = world["jax"]["grads"]
    for rank in world["ranks"]:
        got = rank["pp"]["grads"]
        np.testing.assert_allclose(float(rank["pp"]["loss"]), world["jax"]["loss"],
                                   **TOL)
        assert set(got) == set(want)
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                       err_msg=name)


def _worlds(world, name, plain):
    """The pp case's results in the shape `_assert_step` reads."""
    return {"ranks": [{"sp_steps": r["pp"]} for r in world["ranks"]],
            "jax": {name: world["jax"][name]}}


def test_pp_train_step_matches_jax_and_the_plain_step(world):
    _assert_step(_worlds(world, "lm", "lm_plain"), "lm", "lm_plain",
                 trainable=set(world["jax"]["grads"]))


def test_pp_vlm_train_step_matches_jax_and_the_plain_step(world):
    _assert_step(_worlds(world, "vlm", "vlm_plain"), "vlm", "vlm_plain")
    for rank in world["ranks"]:
        assert rank["pp"]["vlm_towers_whole"]


def test_pp_layer_params_actually_split(world):
    """At pp 4 stage s holds decoder layer s alone; the specs put "pp" on
    the layers' leaves only."""
    for r, rank in enumerate(world["ranks"]):
        held = {int(re.match(r"decoder\.layers\.(\d+)\.", n).group(1))
                for n in rank["pp"]["held"]}
        assert held == {r}
        specs = rank["pp"]["specs"]
        assert specs["embed.weight"] == () and specs["decoder.norm.weight"] == ()
        assert all(s == ("pp",) for n, s in specs.items() if ".layers." in n)


def test_pp_requires_divisible_layers(world):
    for rank in world["ranks"]:
        assert rank["pp"]["odd"] == "--pp 4 must divide num_layers 3"


def test_cli_train_vlm_pp_matches_jax(world):
    for rank in world["ranks"]:
        full = rank["resume_cli"][0]
        assert full["step"] == 3
        _assert_logs(full["history"], world["vlm_log"])


@pytest.mark.parametrize("layout", [2, 3], ids=["dp4", "pp2"])
def test_cli_train_vlm_pp_checkpoint_resumes(world, layout):
    """The checkpoint a --pp 2 run writes at step 2 holds the full model's
    trainable leaves and moments: --dp 4 and --pp 2 resume from it and log
    the third step that --dp 4 logs resuming from a --dp 4 run's step 2
    (a resume reads the synthetic reports afresh, so the word-level
    tokenizer numbers them anew: not the unbroken run's third step). Its
    vlm_deltas hold every layer's adapters."""
    for rank in world["ranks"]:
        runs = rank["resume_cli"]
        got, want = runs[layout], runs[5]
        assert got["step"] == want["step"] == 3
        assert [h["step"] for h in got["history"]] == [3]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["history"][0][key],
                                       want["history"][0][key], rtol=1e-4,
                                       err_msg=key)
        assert runs[1]["deltas"] == runs[0]["deltas"] == got["deltas"] \
            == runs[4]["deltas"]
        assert {int(m.group(1)) for n in got["deltas"]
                if (m := re.match(r"llm\.decoder\.layers\.(\d+)\.", n))} == {0, 1}
