"""The port's VLM finetune CLI (`hsenet_torch.cli.train_vlm`) against the
JAX package's, on the CPU in f32 at its `--synthetic` configuration (a tiny
VLM: (8, 32, 32) volumes, towers of width 32, a 2-layer Phi of width 64
with LoRA rank 4, prompts of 96 tokens), batch 2.

The port CLI trains the JAX CLI's own initial parameters (captured from its
`TrainState.create`, carried over by the bridge into `main(model=)`) on the
same batches, both CLIs' `build_vlm_config` rebound to set every dropout
rate to 0 (the JAX and torch dropout draws cannot agree): the logged
losses must equal the JAX CLI's step by step within 1e-4 relative, for
`--task mrg`, `--task vqa`, `--grad-accum 2` and `--int8-base`. Under
`--int8-base` the codes must be the JAX CLI's, stay as they are, and only
the trainable leaves may move. `--resume auto` (at the configuration's own
LoRA dropout 0.05) must be bit-equal to an unbroken run.
"""

import argparse
import contextlib
import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

import hsenet_tpu.cli.train_vlm as jvlm
import hsenet_tpu.train.trainer as jtrainer
import hsenet_torch.cli.train_vlm as tvlm
import hsenet_torch.train.trainer as ttrainer
from hsenet_tpu.utils.checkpoint import filter_tree as jax_filter_tree
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.cli.common import build_vlm_config
from hsenet_torch.models.mllm import HSENetVLM
from test_torch_train_cli import recording

torch.set_num_threads(1)

RTOL = 1e-4
BASE = ["--synthetic", "--batch-size", "2", "--log-every", "1", "--dtype",
        "float32", "--dp", "1", "--learning-rate", "1e-3", "--checkpoint-every",
        "1000"]
STEPS = ["--total-steps", "3"]
# the JAX package's delta set (utils/checkpoint.py, `save_vlm_deltas`)
JAX_DELTA_RX = r"(mm_projector|lora_[ab]|/embed/|seg_projector|seg_module)"


def without_dropout(build):
    def build_vlm_config(args):
        cfg = build(args)
        return dataclasses.replace(
            cfg,
            vision=dataclasses.replace(cfg.vision, dropout_rate=0.0,
                                       slice_dropout_rate=0.0),
            packer=dataclasses.replace(cfg.packer, dropout_rate=0.0),
            llm=dataclasses.replace(cfg.llm, lora=dataclasses.replace(
                cfg.llm.lora, dropout_rate=0.0)),
        )

    return build_vlm_config


@contextlib.contextmanager
def no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        for cli in (jvlm, tvlm):
            mp.setattr(cli, "build_vlm_config", without_dropout(cli.build_vlm_config))
        yield


def port_model(params):
    """The port's `--synthetic` VLM (dropout 0) holding the JAX params."""
    cfg = without_dropout(build_vlm_config)(argparse.Namespace(synthetic=True))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


def run_jax(out, *flags):
    with recording(jvlm, jtrainer) as (runs, init):
        state = jvlm.main(BASE + STEPS + ["--output-dir", str(out), *flags])
    return runs[0], init["params"], jax.tree.map(np.asarray, state.params)


def run_port(out, params, *flags, steps=STEPS):
    with recording(None, ttrainer) as (runs, _):
        state = tvlm.main(BASE + steps + ["--output-dir", str(out), *flags],
                          device="cpu", model=port_model(params))
    return runs[0], state


def assert_losses_equal(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for key in ("loss", "token_acc", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=RTOL, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def mrg(tmp_path_factory):
    root = tmp_path_factory.mktemp("vlm")
    with no_dropout():
        log, init, final = run_jax(root / "jax")
        got, state = run_port(root / "port", init)
    return dict(root=root, jax_log=log, init=init, jax_final=final,
                port_log=got, port_state=state)


def test_mrg_losses_equal_jax(mrg):
    assert_losses_equal(mrg["port_log"], mrg["jax_log"])
    assert mrg["port_state"].step == 3


def test_vlm_deltas_keys_equal_jax(mrg):
    """vlm_deltas holds the JAX export's leaves, after the bridge's names."""
    saved = torch.load(mrg["root"] / "port" / "vlm_deltas", weights_only=True)
    want = flax_to_torch(jax_filter_tree(mrg["jax_final"]["params"], JAX_DELTA_RX))
    assert sorted(saved) == sorted(want)
    assert any(".lora_a" in k for k in saved) and "llm.embed.weight" in saved


@pytest.mark.parametrize("flags", [["--task", "vqa"], ["--grad-accum", "2"]],
                         ids=["vqa", "grad-accum"])
def test_losses_equal_jax(mrg, tmp_path, flags):
    with no_dropout():
        want, _, _ = run_jax(tmp_path / "jax", *flags)
        got, _ = run_port(tmp_path / "port", mrg["init"], *flags)
    assert_losses_equal(got, want)


def test_int8_base_keeps_the_given_models_config(tmp_path):
    """--int8-base rebuilds a model passed to `main` from that model's own
    config (here its LLM cut to one layer), not from the flags'."""
    cfg = without_dropout(build_vlm_config)(argparse.Namespace(synthetic=True))
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=1))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        state = tvlm.main(BASE + ["--total-steps", "1", "--int8-base",
                                  "--output-dir", str(tmp_path)],
                          device="cpu", model=model)
    llm = state.model.config.llm
    assert llm.num_layers == len(state.model.llm.decoder.layers) == 1
    assert llm.quant_int8 and state.model.config.vision == cfg.vision


def test_int8_base_codes_and_trainable_leaves(mrg, tmp_path):
    """The JAX CLI's codes (its `quantize_kernels_int8` of the same float
    init), unchanged by training; only the trainable leaves move; the losses
    equal the JAX int8 run's."""
    with no_dropout():
        want, jax_init, _ = run_jax(tmp_path / "jax", "--int8-base")
        before = port_model(mrg["init"])
        got, state = run_port(tmp_path / "port", mrg["init"], "--int8-base",
                              steps=["--total-steps", "0"])
        start = {k: v.clone() for k, v in state.model.state_dict().items()}
        got, state = run_port(tmp_path / "port3", mrg["init"], "--int8-base")
    assert_losses_equal(got, want)
    jax_codes = {k: v for k, v in flax_to_torch(jax_init).items()
                 if k.endswith("weight_q") or k.endswith("weight_scale")}
    end = state.model.state_dict()
    assert jax_codes and sorted(jax_codes) == sorted(
        k for k in end if k.endswith(("weight_q", "weight_scale")))
    for k, v in jax_codes.items():
        assert end[k].dtype == v.dtype and torch.equal(start[k], v), k
        assert torch.equal(end[k], v), k
    trainable = set(state.params)
    assert trainable == {n for n, p in state.model.named_parameters()
                         if p.requires_grad}
    assert all(".lora_" in k or "mm_projector" in k or k == "llm.embed.weight"
               for k in trainable)
    float_before = before.state_dict()
    for k, v in end.items():
        if k in trainable:
            assert not torch.equal(v, start[k]), k
        else:
            assert torch.equal(v, start[k]), k
            if k in float_before:  # the float leaves came over unchanged
                assert torch.equal(v, float_before[k]), k


def test_resume_auto_is_bit_equal_to_an_unbroken_run(tmp_path):
    """With the LoRA dropout of the configuration on: a run preempted after
    its step-2 checkpoint and relaunched (--resume auto) ends with the
    unbroken 4-step run's trainable leaves and logged losses, bit for bit
    (each step's dropout stream is a function of (seed, step))."""
    argv = [a if a != "1000" else "2" for a in BASE] + [
        "--total-steps", "4", "--resume", "auto"]
    fit = ttrainer.Trainer.fit

    def run(out, cut=None):
        with pytest.MonkeyPatch.context() as mp:
            if cut:
                mp.setattr(ttrainer.Trainer, "fit",
                           lambda self, total_steps=None: fit(self, cut))
            with recording(None, ttrainer) as (runs, _):
                state = tvlm.main(argv + ["--output-dir", str(out)], device="cpu")
        return state, runs[0]

    whole, whole_log = run(tmp_path / "whole")
    run(tmp_path / "cut", cut=2)
    resumed, resumed_log = run(tmp_path / "cut")
    assert [r["step"] for r in resumed_log] == [3, 4]
    for a, b in zip(whole_log[2:], resumed_log):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v), k
    assert os.path.exists(tmp_path / "cut" / "vlm_deltas")


@pytest.mark.parametrize(
    "flags,item",
    # --task seg is ported, with and without --online-slice-features: it
    # trains (test_torch_seg_vlm.py holds its losses to the JAX CLI's).
    # --fsdp and --zero1 run: in one process there is no dp axis to split
    # over, so each equals the plain run; --tp 2, --pp 2 and --sp 2 in a
    # one-process world raise the JAX create_mesh's mesh-size error (the
    # pipeline and the ring run over four ranks in test_torch_pipeline_pp.py
    # and test_torch_sp.py)
    [(["--task", "seg"], None), (["--online-slice-features", "--task", "seg"], None),
     (["--pp", "2"], "mesh 1x2 needs more than 1 devices"),
     (["--sp", "2"], "mesh 1x2 needs more than 1 devices"), (["--fsdp"], "plain"),
     (["--zero1"], "plain"), (["--tp", "2"], "mesh 1x2 needs more than 1 devices")],
    ids=["seg", "online-slices", "pp", "sp", "fsdp", "zero1", "tp"],
)
def test_flags_of_later_slices_raise(flags, item, tmp_path):
    if item is None:
        with recording(None, ttrainer) as (runs, _):
            state = tvlm.main(BASE + flags + ["--total-steps", "1", "--output-dir",
                                              str(tmp_path)], device="cpu")
        assert state.step == 1 and state.model.config.seg_enable
        assert runs[0][0]["seg_loss"] > 0
        return
    if item == "plain":
        logs = []
        for extra in ([], flags):
            with recording(None, ttrainer) as (runs, _):
                tvlm.main(BASE + extra + ["--total-steps", "2", "--output-dir",
                                          str(tmp_path / str(len(logs)))],
                          device="cpu")
            logs.append([{k: v for k, v in r.items() if k != "steps_per_sec"}
                         for r in runs[0]])
        assert len(logs[1]) == 2 and logs[1] == logs[0]
        return
    error = ValueError if item.startswith("mesh") else NotImplementedError
    with pytest.raises(error, match=item):
        tvlm.main(BASE + flags + ["--output-dir", str(tmp_path)], device="cpu")


@pytest.mark.parametrize(
    "flags",
    [["--pp", "2", "--zero1"], ["--pp", "2", "--sp", "2"], ["--fsdp", "--sp", "2"],
     ["--fsdp", "--zero1"], ["--task", "seg", "--pp", "2"]],
    ids=["pp-zero1", "pp-sp", "fsdp-sp", "fsdp-zero1", "seg-pp"],
)
def test_bad_flag_combinations_exit_as_the_jax_cli(flags, tmp_path, capsys):
    """The JAX CLI's argparse errors come first: exit code 2, as there."""
    for main, kw in ((jvlm.main, {}), (tvlm.main, {"device": "cpu"})):
        with pytest.raises(SystemExit) as e:
            main(BASE + flags + ["--output-dir", str(tmp_path)], **kw)
        assert e.value.code == 2


def test_cli_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvlm.main(BASE + ["--output-dir", str(tmp_path)])
