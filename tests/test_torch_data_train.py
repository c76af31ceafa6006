"""What the port's training CLIs read and write, against the JAX package:
the training datasets (CT-RATE CLIP pairs, closed and yes/no VQA, the M3D
sets, the task mix) on the same manifests, CSVs and JSON, sample for
sample; `lora_trainable_mask` on a bridged Phi tree; the CLIs' parsers and
`run_config.json`; and the TensorBoard event file, read back with
TensorFlow's record reader beside the JAX logger's.

Arrays compare exactly (values and dtypes), strings and the other fields
with `==`. The CLIP sets' sentence sampling draws from one generator per
dataset, so each side reads its samples in one shuffled order.
"""

import argparse
import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.cli.common as jcommon
import hsenet_tpu.cli.train_clip_stage1 as jcli1
import hsenet_tpu.cli.train_clip_stage2 as jcli2
import hsenet_tpu.cli.train_vlm as jvlm
import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jds
import hsenet_torch.cli.common as tcommon
import hsenet_torch.cli.train_clip_stage1 as tcli1
import hsenet_torch.cli.train_clip_stage2 as tcli2
import hsenet_torch.cli.train_vlm as tvlm
import hsenet_torch.configs as tcfg
import hsenet_torch.data.datasets as tds
from hsenet_tpu.models.lora import lora_trainable_mask as jax_lora_mask
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxPhi3
from hsenet_tpu.train.trainer import TensorBoardLogger as JaxTensorBoardLogger
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.lora import lora_trainable_mask
from hsenet_torch.train.trainer import TensorBoardLogger

REPORTS = [
    'The "heart" is normal (size). Lungs are clear. No effusion. Mild '
    "atelectasis at the bases. A 4 mm nodule in the right upper lobe. "
    "Degenerative changes of the spine. No lymphadenopathy.",
    "Small left pleural effusion. The airways are patent. Stable "
    "emphysema. Calcified granuloma. The liver is unremarkable.",
    "No acute findings.",
    "Cardiomegaly. 'Trace' fluid. The aorta is ectatic. Old rib fracture. "
    "Thyroid nodule. Hiatal hernia. Gallstones noted. Renal cyst.",
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Volumes, slice features, seg masks, report .txt files, a manifest
    whose entries carry every field the manifest sets read, a yes/no manifest without
    choices, an M3D-Cap JSON and an M3D-VQA CSV, from a numpy seed."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(5)
    entries = []
    for i, report in enumerate(REPORTS):
        np.save(root / f"vol{i}.npy", rng.random((1, 4, 8, 8), np.float64))
        np.save(root / f"feat{i}.npy", rng.standard_normal((4, 16)))
        with open(root / f"report{i}.txt", "w") as f:
            f.write(report)
        seg = np.zeros((4, 8, 8), np.float32)
        if i != 2:  # an empty mask: the grounding sets' "no" answers
            seg[i % 2:3, 1:5 + i, 2:7] = 1.0
        np.save(root / f"seg{i}.npy", seg)
        entries.append({
            "image": f"vol{i}.npy", "biomedclip_features": f"feat{i}.npy",
            "seg": f"seg{i}.npy", "target": ["liver", "kidney", "spleen",
                                             "lung"][i],
            "text": report if i % 2 else f"report{i}.txt",
            "abnormality": ["nodule", "effusion", "emphysema", "hernia"][i],
            "anatomy": ["right lung", "pleura", "lung", "abdomen"][i],
            "question": f"Is finding {i} present?",
            "choices": ["yes", "no", "maybe"][: 2 + i % 2],
            "answer_idx": i % 2,
        })
    manifest = root / "manifest.json"
    with open(manifest, "w") as f:
        json.dump({"train": entries, "validation": entries[::-1][:3]}, f)
    yn = root / "yn.json"
    with open(yn, "w") as f:
        json.dump({s: [{k: v for k, v in e.items() if k != "choices"}
                       for e in entries] for s in ("train", "validation")}, f)
    cap = root / "cap.json"
    with open(cap, "w") as f:
        json.dump({"train": [{"image": e["image"], "text": f"report{i}.txt"}
                             for i, e in enumerate(entries)],
                   "validation": [{"image": "vol0.npy", "text": "report0.txt"}]}, f)
    vqa_csv = root / "m3d.csv"
    with open(vqa_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image Path", "Question", "Choice A", "Choice B", "Choice C",
                    "Choice D", "Answer Choice", "Answer", "Question Type"])
        for i in range(4):
            w.writerow([f"vol{i}.npy", f"Which organ {i}?", "Lung", "Liver",
                        "Heart", "Kidney", "ABCD"[i], ["Lung", "Liver", "Heart",
                                                       "Kidney"][i], str(i % 3)])
    return dict(root=str(root), manifest=str(manifest), yn=str(yn),
                cap=str(cap), csv=str(vqa_csv))


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def pair(data, name, split, source, **kw):
    """The dataset `name` of both packages over `source`, each with its own
    word-level tokenizer."""
    sets = []
    for ds in (tds, jds):
        tok = ds.SimpleTokenizer(vocab_size=512)
        tok.add_special_tokens({"additional_special_tokens": ds.SPECIAL_TOKENS})
        args = ds.DataArgs(data_root=data["root"], max_text_len=24,
                           max_length=160, proj_out_num=4)
        sets.append(getattr(ds, name)(args, tok, source, split=split, **kw))
    return sets


ORDER = [2, 0, 3, 1, 0, 2]  # a shuffled order, with repeats


@pytest.mark.parametrize("split", ["train", "validation"])
@pytest.mark.parametrize(
    "name,source",
    [("CTRateCLIPDataset", "manifest"), ("ITRDataset", "manifest"),
     ("CTRateCLIPStage2Dataset", "manifest"), ("ClosedVQADataset", "manifest"),
     ("YesNoVQADataset", "yn"), ("M3DCapDataset", "cap"),
     ("M3DVQADataset", "csv"), ("M3DVQAYNDataset", "csv")],
)
def test_datasets_equal_jax(data, name, source, split):
    port, ref = pair(data, name, split, data[source])
    assert len(port) == len(ref) > 0
    order = [i for i in ORDER if i < len(ref)]
    for i in order:
        assert_samples_equal(port[i], ref[i])
    if name == "YesNoVQADataset":  # the choices written back on first read
        assert port.data_list == ref.data_list
        assert all(e["choices"] == ["yes", "no"] for e in port.data_list[:3])


def test_clip_sentence_sampling_follows_the_read_order(data):
    """The CLIP pairs' sampling draws from the dataset's one generator: the
    second read of a long report differs from the first, in both
    packages alike."""
    port, ref = pair(data, "CTRateCLIPDataset", "train", data["manifest"])
    texts = [port[0]["text"], port[0]["text"], port[3]["text"]]
    assert texts == [ref[0]["text"], ref[0]["text"], ref[3]["text"]]
    assert texts[0] != texts[1]


def test_m3d_vqa_open_ended_equals_jax(data):
    port, ref = pair(data, "M3DVQADataset", "train", data["csv"],
                     close_ended=False)
    for i in range(4):
        assert_samples_equal(port[i], ref[i])
    assert port[1]["answer_choice"] == "B" and port[2]["question_type"] == "2"


@pytest.mark.parametrize("spec", ["caption", "closedvqa_and_caption",
                                  "caption_and_openvqa", "yn+caption"])
def test_build_task_mix_equals_jax(data, spec):
    manifest = data["yn"] if spec.startswith("yn") else data["manifest"]
    mixes = []
    for ds in (tds, jds):
        tok = ds.SimpleTokenizer(vocab_size=512)
        tok.add_special_tokens({"additional_special_tokens": ds.SPECIAL_TOKENS})
        args = ds.DataArgs(data_root=data["root"], max_length=160, proj_out_num=4)
        mixes.append(ds.build_task_mix(spec, args, tok, manifest, "train",
                                       pad_seg_shape=(1, 4, 8, 8)
                                       if spec == "yn+caption" else None))
    port, ref = mixes
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref)
    for i in range(len(ref)):
        assert_samples_equal(port[i], ref[i])


@pytest.mark.parametrize("spec", ["bogus", "caption+bogus"])
def test_build_task_mix_refuses_an_unknown_task(data, spec):
    for ds in (tds, jds):
        with pytest.raises(ValueError, match="unknown task 'bogus'"):
            ds.build_task_mix(spec, ds.DataArgs(), ds.SimpleTokenizer(),
                              data["manifest"])


@pytest.mark.parametrize("spec", ["seg", "caption+rec", "reg"])
def test_grounding_tasks_raise_when_built(data, spec):
    """The grounding tasks (seg QA, REC, REG) build as the JAX package's do:
    the same samples, the mix padding zero seg masks where a task has
    none."""
    mixes = []
    for ds in (tds, jds):
        tok = ds.SimpleTokenizer(vocab_size=512)
        tok.add_special_tokens({"additional_special_tokens": ds.SPECIAL_TOKENS})
        args = ds.DataArgs(data_root=data["root"], max_length=160, proj_out_num=4)
        mixes.append(ds.build_task_mix(spec, args, tok, data["manifest"], "train",
                                       pad_seg_shape=(1, 4, 8, 8)))
    port, ref = mixes
    assert type(port).__name__ == type(ref).__name__ == "MixDataset"
    assert len(port) == len(ref) == 4 * len(spec.split("+"))
    for i in range(len(ref)):
        got = port[i]  # one read: a caption read draws from its generator
        assert_samples_equal(got, ref[i])
        assert got["seg"].shape == (1, 4, 8, 8)


@pytest.mark.parametrize("extra", [(), ("embed",), ("o_proj", "norm")])
def test_lora_trainable_mask_equals_jax(extra):
    cfg = jcfg.Phi3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                          lora=jcfg.LoRAConfig(rank=2, alpha=4))
    params = jax.jit(JaxPhi3(cfg).init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 4), jnp.int32))
    mask = jax_lora_mask(params, extra_trainable=extra)
    # the mask as a tree of the params' shapes (all ones or all zeros), so
    # the bridge carries it to the port's names
    as_leaves = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                             mask, params)
    want = {k: bool(v.all()) for k, v in flax_to_torch(as_leaves).items()}
    state = flax_to_torch(jax.tree.map(np.asarray, params))
    got = lora_trainable_mask(state, extra_trainable=extra)
    assert got == want
    assert any(got.values()) and not all(got.values())


class Captured(Exception):
    pass


def parser_of(main, **kw):
    """The ArgumentParser `main` builds (caught at its parse_args)."""
    def parse(self, args=None, namespace=None):
        raise Captured(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(Captured) as e:
            main([], **kw)
    return e.value.args[0]


def options(parser):
    return {tuple(a.option_strings): (type(a).__name__, a.default, a.type, a.nargs,
                                      a.choices, a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize(
    "port,ref",
    [(tcli1.main, jcli1.main), (tcli2.main, jcli2.main), (tvlm.main, jvlm.main)],
    ids=["stage1", "stage2", "vlm"],
)
def test_cli_parsers_equal_jax(port, ref):
    got, want = options(parser_of(port, device="cpu")), options(parser_of(ref))
    assert got == want
    assert [a.option_strings for a in parser_of(port, device="cpu")._actions] == \
        [a.option_strings for a in parser_of(ref)._actions]


def test_add_train_args_equals_jax():
    got, want = argparse.ArgumentParser(), argparse.ArgumentParser()
    tcommon.add_train_args(got)
    jcommon.add_train_args(want)
    assert options(got) == options(want)
    args = got.parse_args([])
    assert (args.dp, args.tp, args.batch_size, args.remat, args.resume) == \
        (-1, 1, 24, None, "")
    train = tcommon.train_config_from_args(args)
    want_train = jcommon.train_config_from_args(want.parse_args([]))
    assert dataclasses.asdict(train) == dataclasses.asdict(want_train)
    assert tcommon.dtype_from_args(args) == torch.bfloat16


# config fields of the JAX package that the port leaves out: the Pallas
# kernels' query block (a TPU tiling knob)
TPU_ONLY = {"attn_block_q"}


def _strip(blob):
    if isinstance(blob, dict):
        return {k: _strip(v) for k, v in blob.items() if k not in TPU_ONLY}
    return blob


@pytest.mark.parametrize("name", ["CLIPConfig", "VLMConfig"])
def test_dump_config_writes_the_jax_keys(tmp_path, name):
    for pkg, dump, out in ((tcfg, tcommon.dump_config, "port"),
                           (jcfg, jcommon.dump_config, "jax")):
        dump(str(tmp_path / out), getattr(pkg, name)(), pkg.TrainConfig())
    got, want = (json.load(open(tmp_path / d / "run_config.json"))
                 for d in ("port", "jax"))
    assert list(got) == list(want) == [name, "TrainConfig"]
    assert got["TrainConfig"] == want["TrainConfig"]
    assert got[name] == _strip(want[name])


def test_resolve_resume_dir(tmp_path):
    from hsenet_torch.utils.checkpoint import CheckpointManager

    args = argparse.Namespace(resume="auto", output_dir=str(tmp_path / "run"))
    assert tcommon.resolve_resume_dir(args) == ""
    os.makedirs(tmp_path / "run" / "2")
    (tmp_path / "run" / "2" / "state.pt").write_bytes(b"")
    assert tcommon.resolve_resume_dir(args, CheckpointManager(args.output_dir)) \
        == args.output_dir
    assert tcommon.resolve_resume_dir(argparse.Namespace(resume="x")) == "x"


def _read_events(path):
    import tensorflow as tf

    rows = []
    for event in tf.compat.v1.train.summary_iterator(path):
        for v in event.summary.value:
            value = (float(tf.make_ndarray(v.tensor)) if v.HasField("tensor")
                     else v.simple_value)
            rows.append((event.step, v.tag, np.float32(value)))
    return rows


def test_tensorboard_logger_reads_back_as_the_jax_loggers(tmp_path, capsys):
    """The same calls to both loggers: TensorFlow's record reader (which
    checks every CRC) gives the same steps, tags and f32 values from both
    files, and both print the same lines."""
    calls = [(1, {"loss": 2.5, "token_acc": 0.125, "grad_norm": 3.75}),
             (2, {"loss": 2.25, "token_acc": 0.25, "grad_norm": 1e-3}),
             (4, {"loss": 1.0 / 3.0, "token_acc": 0.5, "grad_norm": 123.456})]
    paths = {}
    for name, cls in (("port", TensorBoardLogger), ("jax", JaxTensorBoardLogger)):
        logger = cls(str(tmp_path / name))
        for step, metrics in calls:
            logger(step, metrics)
        files = os.listdir(tmp_path / name)
        assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
        paths[name] = str(tmp_path / name / files[0])
        if name == "port":
            logger.close()
    printed = capsys.readouterr().out.splitlines()
    assert printed[:3] == printed[3:] and printed[0].startswith("step 1: loss=2.5000")
    got, want = _read_events(paths["port"]), _read_events(paths["jax"])
    assert got == want and len(got) == 9
    # a flipped byte in a record's data breaks its CRC, which the reader checks
    import tensorflow as tf

    blob = bytearray(open(paths["port"], "rb").read())
    blob[-10] ^= 0xFF
    with open(paths["port"], "wb") as f:
        f.write(blob)
    with pytest.raises(tf.errors.DataLossError):
        _read_events(paths["port"])
