"""The port's CLIP training CLIs (`hsenet_torch.cli.train_clip_stage1`,
`train_clip_stage2`) against the JAX package's, on the CPU in f32 at
`tests/test_pipeline.py`'s TINY_ARGS (a (8, 32, 32) volume in (2, 8, 8)
patches, hidden 32, 2 layers, 4 heads, a 2-layer text encoder of width 32,
16 text tokens, batch 4).

Each port CLI trains the JAX CLI's own initial parameters (captured from
its `TrainState.create` and carried over by the bridge into `main(model=)`)
on the same synthetic batches, and its logged losses must equal the JAX
CLI's step by step within 1e-4 relative: both sides compute in f32 and
differ in the order of their sums. Stage 2 runs with the 2E3 tower's slice
dropout at 0 in both packages (the JAX and torch dropout draws cannot
agree), its teacher the JAX stage 1's export, bridged. The rest holds the
port alone: the three-stage handoff (the VLM's frozen towers equal the CLIP
exports exactly), `--resume auto` bit-equal to an unbroken run,
`--cached-teacher` equal to the recomputed teacher, the profile window's
trace, the flags of later slices and the refusal without CUDA.
"""

import contextlib
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import hsenet_tpu.cli.train_clip_stage1 as jcli1
import hsenet_tpu.cli.train_clip_stage2 as jcli2
import hsenet_tpu.configs as jcfg
import hsenet_tpu.train.trainer as jtrainer
import hsenet_torch.cli.train_clip_stage1 as tcli1
import hsenet_torch.cli.train_clip_stage2 as tcli2
import hsenet_torch.cli.train_vlm as tvlm
import hsenet_torch.configs as tcfg
import hsenet_torch.train.trainer as ttrainer
from hsenet_tpu.utils.checkpoint import restore_params as jax_restore_params
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.clip import CLIPModel
from hsenet_torch.utils.checkpoint import save_params
from test_pipeline import TINY_ARGS
from test_torch_common import to_torch_config

torch.set_num_threads(1)

RTOL = 1e-4
STEPS = ["--total-steps", "3", "--log-every", "1", "--learning-rate", "1e-3"]


def _args(out, *extra):
    return TINY_ARGS + STEPS + ["--output-dir", str(out), *extra]


@contextlib.contextmanager
def recording(cli_module, trainer_module):
    """Within the block, each `Trainer.fit` of `trainer_module` appends its
    history to `runs`, and the params `cli_module` hands to
    `TrainState.create` (the JAX CLI's own init) land in `init`."""
    runs, init = [], {}
    fit = trainer_module.Trainer.fit

    def recorded_fit(self, total_steps=None):
        state = fit(self, total_steps)
        runs.append(self.history)
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_module.Trainer, "fit", recorded_fit)
        if cli_module is not None and hasattr(cli_module, "TrainState"):
            real = cli_module.TrainState

            class Spy:
                @staticmethod
                def create(params, tx, mesh=None):
                    init["params"] = jax.tree.map(np.asarray, params)
                    return real.create(params, tx, mesh=mesh)

            mp.setattr(cli_module, "TrainState", Spy)
        yield runs, init


def no_slice_dropout(mp):
    """The 2E3 tower's slice dropout at 0 in both packages' CLIP CLIs."""
    mp.setattr(jcli2, "ViT3DConfig",
               functools.partial(jcfg.ViT3DConfig, slice_dropout_rate=0.0))
    mp.setattr(tcli1, "ViT3DConfig",
               functools.partial(tcfg.ViT3DConfig, slice_dropout_rate=0.0))


def clip_model(jax_cfg, params):
    model = CLIPModel(to_torch_config(jax_cfg), dtype=torch.float32, device="cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


def assert_losses_equal(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for key in ("loss", "retrieval_acc", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=RTOL, atol=1e-6, err_msg=key)


def exported(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def jax_cfg_of(out):
    """The JAX run's CLIPConfig, rebuilt from its run_config.json."""
    with open(os.path.join(out, "run_config.json")) as f:
        blob = json.load(f)["CLIPConfig"]
    vision = {k: tuple(v) if isinstance(v, list) else v
              for k, v in blob.pop("vision").items()}
    return jcfg.CLIPConfig(vision=jcfg.ViT3DConfig(**vision),
                           text=jcfg.BertConfig(**blob.pop("text")), **blob)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """The JAX stage-1 CLI's run, its init and its export bridged to the
    port's format, and the port CLI's run from that init."""
    root = tmp_path_factory.mktemp("stage1")
    with recording(jcli1, jtrainer) as (jruns, jinit):
        jstate = jcli1.main(_args(root / "jax"))
    cfg = jax_cfg_of(root / "jax")
    final = jax.tree.map(np.asarray, jstate.params)
    jax_export = jax_restore_params(str(root / "jax" / "clip_params"), final)
    teacher = str(root / "teacher.pt")
    save_params(teacher, flax_to_torch(jax_export))
    with recording(None, ttrainer) as (truns, _):
        tstate = tcli1.main(
            _args(root / "port", "--profile", str(root / "prof"),
                  "--profile-start", "1", "--profile-stop", "2"),
            device="cpu", model=clip_model(cfg, jinit["params"]))
    return dict(root=root, cfg=cfg, jax_runs=jruns, port_runs=truns,
                jax_final=final, teacher=teacher, port_state=tstate)


def test_stage1_losses_equal_jax(stage1):
    (got,), (want,) = stage1["port_runs"], stage1["jax_runs"]
    assert_losses_equal(got, want)
    assert stage1["port_state"].step == 3


def test_stage1_exports_equal_jax(stage1):
    """clip_params and tower_params hold the JAX exports' leaves (after the
    bridge's names), at the trained values. BERT's key bias has an exact
    gradient of 0 (the softmax ignores a score added to a whole row), so
    Adam turns each side's rounding noise into steps of up to one learning
    rate: it is held to one learning rate a step."""
    root, final = stage1["root"], stage1["jax_final"]
    want = {"clip_params": flax_to_torch(final),
            "tower_params": flax_to_torch(final["params"]["vision_encoder"])}
    for name, leaves in want.items():
        got = exported(root / "port" / name)
        assert sorted(got) == sorted(leaves), name
        for k, v in leaves.items():
            tol = (dict(atol=1e-3 * 3, rtol=0) if k.endswith(".k.bias")
                   else dict(atol=1e-5, rtol=1e-3))
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **tol,
                                       err_msg=k)


def test_stage1_profile_window_writes_a_trace(stage1):
    traces = os.listdir(stage1["root"] / "prof")
    assert len(traces) == 1 and traces[0].startswith("steps_1-2.")
    with open(stage1["root"] / "prof" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.fixture(scope="module")
def stage2(stage1):
    """The JAX stage-2 CLI and the port's, both from the JAX stage-1 export
    as teacher, the slice dropout at 0."""
    root = stage1["root"]
    with pytest.MonkeyPatch.context() as mp:
        no_slice_dropout(mp)
        with recording(jcli2, jtrainer) as (jruns, jinit):
            jcli2.main(_args(root / "jax2", "--stage1-checkpoint",
                             str(root / "jax" / "clip_params")))
        cfg = dataclasses.replace(stage1["cfg"], vision=dataclasses.replace(
            stage1["cfg"].vision, slice_guided=True, slice_dropout_rate=0.0))
        runs = {}
        for mode in ("recompute", "cached"):
            flags = ["--stage1-checkpoint", stage1["teacher"]]
            flags += ["--cached-teacher"] if mode == "cached" else []
            with recording(None, ttrainer) as (truns, _):
                state = tcli2.main(_args(root / f"port2_{mode}", *flags),
                                   device="cpu",
                                   model=clip_model(cfg, jinit["params"]))
            runs[mode] = (truns[0], state)
    return dict(jax_runs=jruns, port_runs=runs)


def test_stage2_losses_equal_jax(stage2):
    got, _ = stage2["port_runs"]["recompute"]
    (want,) = stage2["jax_runs"]
    assert_losses_equal(got, want)
    for key in ("loss_cl", "loss_relation", "relation_weight"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=RTOL, atol=1e-6, err_msg=key)


def test_cached_teacher_gives_the_recomputed_losses(stage2):
    """The cached run serves each sample's teacher features from the store
    (filled by the teacher's own forward) and takes the same batches: its
    logged metrics equal the recomputed run's."""
    recompute, _ = stage2["port_runs"]["recompute"]
    cached, _ = stage2["port_runs"]["cached"]
    for a, b in zip(recompute, cached):
        for key in ("loss", "loss_cl", "loss_relation", "retrieval_acc",
                    "grad_norm"):
            assert a[key] == b[key], (key, a, b)


def test_stage2_warm_start_copies_the_teacher(stage1, tmp_path):
    """Zero training steps: the student's BERT and projections are the
    teacher's exactly, copies (the teacher's tensors are not the student's),
    and its 2E3 tower keeps its own draw."""
    root = stage1["root"]
    out = tmp_path / "s2"
    tcli2.main(TINY_ARGS + ["--total-steps", "0", "--output-dir", str(out),
                            "--stage1-checkpoint", stage1["teacher"]],
               device="cpu")
    student, teacher = exported(out / "clip_params"), exported(stage1["teacher"])
    for k, v in teacher.items():
        if k.split(".", 1)[0] in tcli2.WARM_STARTED:
            assert torch.equal(student[k], v), k
    assert not torch.equal(student["vision_encoder.patch_embed.proj.weight"],
                           teacher["vision_encoder.patch_embed.proj.weight"])
    assert os.path.exists(root / "port2_recompute" / "tower_params")


def test_three_stage_handoff(stage1, tmp_path):
    """The reference recipe through the port's CLIs: the VLM grafts both
    CLIP stages' tower exports and keeps them frozen, so after training its
    towers equal the exports exactly (tests/test_pipeline.py:88-97)."""
    root = stage1["root"]
    tower1 = root / "port" / "tower_params"
    tower2 = root / "port2_recompute" / "tower_params"
    state = tvlm.main(["--synthetic", "--task", "mrg", "--total-steps", "2",
                       "--batch-size", "2", "--log-every", "1", "--dtype",
                       "float32", "--dp", "1", "--output-dir", str(tmp_path / "vlm"),
                       "--clip-stage1-checkpoint", str(tower1),
                       "--clip-stage2-checkpoint", str(tower2)], device="cpu")
    vlm = state.model.state_dict()
    for path, prefix in ((tower1, tvlm.TOWER_PREFIX["stage1"]),
                         (tower2, tvlm.TOWER_PREFIX["stage2"])):
        export = exported(path)
        got = {k[len(prefix):]: v for k, v in vlm.items() if k.startswith(prefix)}
        assert sorted(got) == sorted(export)
        for k, v in export.items():
            assert torch.equal(got[k], v), k
    assert os.path.exists(tmp_path / "vlm" / "vlm_deltas")


def test_resume_auto_is_bit_equal_to_an_unbroken_run(tmp_path):
    """A run preempted after its step-2 checkpoint and relaunched with the
    same command (--resume auto) ends with the parameters, moments and
    logged losses of an unbroken 4-step run, bit for bit."""
    argv = TINY_ARGS + ["--total-steps", "4", "--log-every", "1",
                        "--learning-rate", "1e-3", "--resume", "auto"]
    argv[argv.index("--checkpoint-every") + 1] = "2"

    def run(out, cut=None):
        fit = ttrainer.Trainer.fit
        with pytest.MonkeyPatch.context() as mp:
            if cut:
                mp.setattr(ttrainer.Trainer, "fit",
                           lambda self, total_steps=None: fit(self, cut))
            with recording(None, ttrainer) as (runs, _):
                state = tcli1.main(argv + ["--output-dir", str(out)], device="cpu")
        return state, runs[0]

    whole, whole_log = run(tmp_path / "whole")
    _, first_log = run(tmp_path / "cut", cut=2)
    resumed, resumed_log = run(tmp_path / "cut")
    assert [r["step"] for r in first_log] == [1, 2]
    assert [r["step"] for r in resumed_log] == [3, 4]
    for a, b in zip(whole_log, first_log + resumed_log):
        assert {k: v for k, v in a.items() if k != "steps_per_sec"} == \
            {k: v for k, v in b.items() if k != "steps_per_sec"}
    assert resumed.step == whole.step == 4
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v), k
    for m in ("mu", "nu"):
        for a, b in zip(getattr(whole.opt_state, m), getattr(resumed.opt_state, m)):
            assert torch.equal(a, b)


@pytest.mark.parametrize(
    "cli,flags,error,match",
    # --zero1 runs (one process: no dp axis to split the moments over, so
    # the run is the plain one); --dp / --tp / --sp above 1 in a
    # one-process world raise the JAX create_mesh's mesh-size error (the
    # (dp, sp) mesh: --sp runs over four ranks in test_torch_sp.py)
    [(tcli1, ["--sp", "2"], ValueError, "mesh 1x2 needs more than 1 devices"),
     (tcli1, ["--zero1"], None, None),
     (tcli1, ["--dp", "2"], ValueError, "mesh 2x1 needs more than 1 devices"),
     (tcli1, ["--tp", "2"], ValueError, "mesh 1x2 needs more than 1 devices"),
     (tcli2, ["--sp", "2"], ValueError, "mesh 1x2 needs more than 1 devices"),
     (tcli2, ["--zero1"], None, None)],
    ids=["stage1-sp", "stage1-zero1", "stage1-dp", "stage1-tp", "stage2-sp",
         "stage2-zero1"],
)
def test_flags_of_the_parallel_slice_raise(cli, flags, error, match, tmp_path):
    args = [a for a in TINY_ARGS if a not in ("--dp", "1")]
    if error is not None:
        with pytest.raises(error, match=match):
            cli.main(args + flags + ["--output-dir", str(tmp_path)], device="cpu")
        return
    runs = []
    for extra in ([], flags):
        with recording(None, ttrainer) as (hist, _):
            state = cli.main(args + STEPS + extra + ["--output-dir",
                                                     str(tmp_path / str(len(runs)))],
                             device="cpu")
        runs.append((hist[0], state))
    (plain, plain_state), (zero1, zero1_state) = runs
    assert zero1 and [{k: v for k, v in r.items() if k != "steps_per_sec"}
                      for r in zero1] == [
        {k: v for k, v in r.items() if k != "steps_per_sec"} for r in plain]
    for k, v in plain_state.params.items():
        assert torch.equal(zero1_state.params[k], v), k


@pytest.mark.parametrize("cli", [tcli1, tcli2], ids=["stage1", "stage2"])
def test_cli_refuses_missing_cuda(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(TINY_ARGS + ["--output-dir", str(tmp_path)])
