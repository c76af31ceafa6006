"""The port's CLIs over two gloo ranks on the CPU (`torchrun`'s layout, one
process per rank), in f32 at their `--synthetic` sizes.

  * `train_clip_stage1 --dp 2 --zero1` and `train_vlm --dp 2 --fsdp` train
    the JAX CLIs' own initial parameters (captured from their
    `TrainState.create`, as `test_torch_train_cli.py` does) and log the JAX
    CLIs' losses, token or retrieval accuracies and gradient norms at 1e-4
    relative, the JAX CLIs running the same flags on a dp = 2 mesh of their
    virtual CPU devices. Each port rank trains on its own rows; the JAX CLI
    loads the global batch. The word-level `SimpleTokenizer` assigns ids in
    the order it first sees words, so each port rank reads every row of the
    global batch (`DataLoader`) and numbers the words as the JAX CLI's one
    process does: both tokenizers start empty here.
    The VLM runs at dropout 0 (the JAX and torch draws cannot agree).
  * `evaluate --dp 2` (greedy and `--do-sample`), `--tp 2` and `--engine
    --tp 2` report exactly what one process reports.
"""

import contextlib
import io

import numpy as np
import pytest

import hsenet_tpu.cli.train_clip_stage1 as jcli1
import hsenet_tpu.cli.train_vlm as jvlm
import hsenet_tpu.train.trainer as jtrainer
from _torch_parallel_worker import spawn
from hsenet_torch.cli import evaluate as teval
from test_pipeline import TINY_ARGS
from test_torch_train_cli import clip_model, jax_cfg_of, recording
from test_torch_train_vlm_cli import no_dropout, port_model

RTOL = 1e-4
STEPS = ["--total-steps", "3", "--log-every", "1", "--learning-rate", "1e-3",
         "--eval-every", "0"]
CLIP_ARGV = [a for a in TINY_ARGS if a not in ("--dp", "1")] + STEPS + [
    "--dp", "2", "--zero1"]
VLM_ARGV = ["--synthetic", "--batch-size", "4", "--dtype", "float32",
            "--checkpoint-every", "1000", "--dp", "2", "--fsdp"] + STEPS
EVAL_RUNS = {
    "dp2": ["--task", "mrg", "--synthetic", "--dp", "2"],
    "dp2_sampled": ["--task", "mrg", "--synthetic", "--dp", "2", "--do-sample",
                    "--temperature", "1.5", "--gen-seed", "3"],
    "tp2": ["--task", "vqa", "--synthetic", "--tp", "2"],
    "tp2_engine": ["--task", "vqa", "--synthetic", "--tp", "2", "--engine"],
}


def _jax_run(cli, argv):
    with recording(cli, jtrainer) as (runs, init), \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    return runs[0], init["params"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    jclip_log, jclip_init = _jax_run(
        jcli1, CLIP_ARGV + ["--output-dir", str(root / "jax_clip")])
    with no_dropout():
        jvlm_log, jvlm_init = _jax_run(
            jvlm, VLM_ARGV + ["--output-dir", str(root / "jax_vlm")])
    cases = [
        ("train_cli", dict(
            cli="hsenet_torch.cli.train_clip_stage1",
            argv=CLIP_ARGV + ["--output-dir", str(root / "port_clip")],
            model=clip_model(jax_cfg_of(root / "jax_clip"), jclip_init))),
        ("train_vlm_cli", dict(
            cli="hsenet_torch.cli.train_vlm",
            argv=VLM_ARGV + ["--output-dir", str(root / "port_vlm")],
            model=port_model(jvlm_init))),
        ("eval_cli", dict(runs=EVAL_RUNS)),
    ]
    ranks = spawn(root, cases)
    one = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, argv in EVAL_RUNS.items():
            one[name] = teval.main([a for a in argv if a not in ("--dp", "--tp", "2")],
                                   device="cpu")
    return dict(ranks=ranks, clip=jclip_log, vlm=jvlm_log, eval=one)


def _assert_logs(got, want, keys):
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for key in keys:
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=RTOL, atol=1e-6, err_msg=key)


def test_stage1_cli_dp2_zero1_matches_jax(world):
    for r in world["ranks"]:
        assert r["train_cli"]["step"] == 3
        _assert_logs(r["train_cli"]["history"], world["clip"],
                     ("loss", "retrieval_acc", "grad_norm"))


def test_train_vlm_cli_fsdp_matches_jax(world):
    for r in world["ranks"]:
        assert r["train_vlm_cli"]["step"] == 3
        _assert_logs(r["train_vlm_cli"]["history"], world["vlm"],
                     ("loss", "token_acc", "grad_norm"))


@pytest.mark.parametrize("run", list(EVAL_RUNS))
def test_evaluate_over_two_ranks_equals_one_process(world, run):
    for r in world["ranks"]:
        assert r["eval_cli"][run] == world["eval"][run]
