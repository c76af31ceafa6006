"""The port's CT preprocessing CLI (`hsenet_torch.cli.preprocess_ct`), the
BiomedCLIP converter's CLI (`convert_checkpoint --kind biomedclip`) and
`train_vlm --online-slice-features` against the JAX package's CLIs, on the
CPU.

Both preprocessing CLIs run on one directory of NIfTI files (a gzipped
int16 volume with an intercept of -1024, a plain float32 one in a
subdirectory) and a CT-RATE metadata CSV, with `PreprocessConfig` (and
`ViT2DConfig` for `--vit2d-checkpoint`) rebound to toy sizes in both CLI
modules' namespaces. Tolerances:
  * manifests equal;
  * volumes and linear slices 1e-5 absolute, faithful (cubic) slices as
    in tests/test_torch_ct_data.py (1e-4 where the uint8 codes behind them
    agree, a few codes one apart at rounding edges);
  * `--slice-jpeg-roundtrip` slices equal where the two packages' uint8
    codes are equal;
  * (32, 768)-like features of the bf16 trunk: 2e-2 relative L2 (bf16
    products in both packages), and equal to the port's trunk called on
    the CLI's own slices;
  * `train_vlm --online-slice-features`: the logged losses at the
    training-CLI tests' 1e-4 relative.
"""

import argparse
import contextlib
import csv
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.cli.convert_checkpoint as jconvert
import hsenet_tpu.cli.preprocess_ct as jcli
import hsenet_tpu.cli.train_vlm as jvlm
import hsenet_tpu.configs as jcfg
import hsenet_tpu.data.datasets as jdata
import hsenet_tpu.train.trainer as jtrainer
import hsenet_torch.cli.convert_checkpoint as tconvert
import hsenet_torch.cli.preprocess_ct as tcli
import hsenet_torch.cli.train_vlm as tvlm
import hsenet_torch.configs as tcfg
import hsenet_torch.data.datasets as tdata
import hsenet_torch.train.trainer as ttrainer
from hsenet_tpu.data import preprocess as jpre
from hsenet_tpu.models.vit import ViT2D as JaxViT2D
from hsenet_tpu.utils.checkpoint import restore_params as jax_restore
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.data import nifti as tnifti
from hsenet_torch.data import preprocess as tpre
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.vit import ViT2D
from test_torch_ct_data import ATOL, assert_faithful_slices_close
from test_torch_train_cli import recording
from test_torch_train_vlm_cli import BASE, without_dropout

torch.set_num_threads(1)

RTOL = 1e-4
FEATURE_REL_L2 = 2e-2
PRE = dict(target_shape=(8, 24, 24), num_slices=6, slice_size=28)
# the trunk at 224 (the JAX CLI builds its template on a 224 x 224 image)
VIT2D = dict(image_size=224, patch_size=16, hidden_size=32, mlp_dim=64,
             num_layers=1, num_heads=2)


@contextlib.contextmanager
def toy_configs(pre=PRE):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "PreprocessConfig", functools.partial(jcfg.PreprocessConfig, **pre))
        mp.setattr(tcli, "PreprocessConfig", functools.partial(tcfg.PreprocessConfig, **pre))
        # the JAX CLI imports ViT2DConfig from its configs module when it runs
        mp.setattr(jcfg, "ViT2DConfig", functools.partial(jcfg.ViT2DConfig, **VIT2D))
        mp.setattr(tcli, "ViT2DConfig", functools.partial(tcfg.ViT2DConfig, **VIT2D))
        yield


@pytest.fixture(scope="module")
def nii(tmp_path_factory):
    """Two NIfTI volumes and a metadata CSV; returns (dir, csv, raws): the
    stored values and the slope/intercept each CLI applies, by name."""
    root = tmp_path_factory.mktemp("nii")
    rng = np.random.default_rng(0)
    z, y, x = np.meshgrid(np.arange(14), np.arange(36), np.arange(30), indexing="ij")
    body = ((y - 18) ** 2 / 14 ** 2 + (x - 15) ** 2 / 11 ** 2) < 1
    a = np.where(body, 1024 + rng.integers(-400, 1400, z.shape), 0).astype(np.int16)
    b = np.where(body[:10], rng.normal(-200, 500, (10, 36, 30)), -1000).astype(np.float32)
    tnifti.write_nifti(str(root / "a.nii.gz"), a.transpose(2, 1, 0),
                       spacing=(0.7, 0.7, 1.5), scl_inter=-1024.0)
    (root / "sub").mkdir()
    tnifti.write_nifti(str(root / "sub" / "b.nii"), b.transpose(2, 1, 0),
                       spacing=(0.8, 0.8, 5.0))
    meta = root / "meta.csv"
    with open(meta, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VolumeName", "RescaleSlope", "RescaleIntercept"])
        w.writerow(["b.nii", "1.0", "-24"])
    raws = {"a": (a.astype(np.float32), 1.0, -1024.0, (1.5, 0.7, 0.7)),
            "b": (b, 1.0, -24.0, (5.0, 0.8, 0.8))}
    return root, str(meta), raws


def run_both(tmp_path, nii, *flags, jax_flags=(), port_flags=()):
    root, meta, _ = nii
    out = {}
    for name, main, kw, extra in (("jax", jcli.main, {}, jax_flags),
                                  ("port", tcli.main, {"device": "cpu"}, port_flags)):
        out[name] = tmp_path / name
        main(["--input-dir", str(root), "--output-dir", str(out[name]),
              "--metadata", meta, *flags, *extra], **kw)
    manifests = [json.loads((out[n] / "dataset_manifest.json").read_text())
                 for n in ("jax", "port")]
    assert manifests[0] == manifests[1]
    return out, manifests[1]


def load(out, name):
    return np.load(out["jax"] / name), np.load(out["port"] / name)


def edge_slices(raw, slope, inter, spacing, cfg_kw):
    """The slices whose floor(x * 255) codes differ between the packages."""
    inter_shape = jpre.spacing_resample_shape(raw.shape, spacing,
                                              jcfg.PreprocessConfig(**cfg_kw))
    want = np.asarray(jpre.extract_slices_uint8(
        jnp.asarray(raw), jnp.float32(slope), jnp.float32(inter),
        jcfg.PreprocessConfig(**cfg_kw), inter_shape))
    got = tpre.extract_slices_uint8(torch.tensor(raw), slope, inter,
                                    tcfg.PreprocessConfig(**cfg_kw), inter_shape).numpy()
    return (got != want).any(axis=(1, 2))


@pytest.mark.parametrize("faithful", [False, True], ids=["fused", "faithful"])
def test_preprocess_cli_matches_jax(tmp_path, nii, faithful):
    with toy_configs():
        out, manifest = run_both(tmp_path, nii, "--slices",
                                 *(["--faithful"] if faithful else []))
    assert [e["image"] for e in manifest["train"]] == [
        "a_3D_features.npy", "b_3D_features.npy"]
    assert manifest["validation"] == manifest["train"]
    for entry in manifest["train"]:
        want, got = load(out, entry["image"])
        assert got.shape == want.shape == (1, *PRE["target_shape"])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        want, got = load(out, entry["slices"])
        assert got.shape == want.shape == (6, 28, 28, 3)
        if not faithful:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
            continue
        assert_faithful_slices_close(got, want)


def test_slice_jpeg_roundtrip_matches_jax(tmp_path, nii):
    with toy_configs():
        out, manifest = run_both(tmp_path, nii, "--slices", "--slice-jpeg-roundtrip")
    for entry in manifest["train"]:
        want, got = load(out, entry["slices"])
        edge = edge_slices(*nii[2][entry["image"][0]], PRE)
        np.testing.assert_array_equal(got[~edge], want[~edge])


def _trunk_file(path, seed=0):
    """An open_clip-named BiomedCLIP trunk at VIT2D's widths, from a seed."""
    rng = np.random.default_rng(seed)
    h, m, p = VIT2D["hidden_size"], VIT2D["mlp_dim"], VIT2D["patch_size"]
    n = (VIT2D["image_size"] // p) ** 2

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.2)

    sd = {"patch_embed.proj.weight": t(h, 3, p, p), "patch_embed.proj.bias": t(h),
          "cls_token": t(1, 1, h), "pos_embed": t(1, n + 1, h),
          "norm.weight": 1 + t(h), "norm.bias": t(h),
          "blocks.0.norm1.weight": 1 + t(h), "blocks.0.norm1.bias": t(h),
          "blocks.0.norm2.weight": 1 + t(h), "blocks.0.norm2.bias": t(h)}
    for name, (o, i) in (("attn.qkv", (3 * h, h)), ("attn.proj", (h, h)),
                         ("mlp.fc1", (m, h)), ("mlp.fc2", (h, m))):
        sd[f"blocks.0.{name}.weight"], sd[f"blocks.0.{name}.bias"] = t(o, i), t(o)
    sd = {f"visual.trunk.{k}": v for k, v in sd.items()}
    sd["text.proj"] = t(4, 4)  # the rest of the open_clip model is left out
    torch.save(sd, path)
    return path


def test_vit2d_checkpoint_and_biomedclip_conversion(tmp_path, nii):
    """convert_checkpoint --kind biomedclip in both packages (the port's
    file holds the JAX file's tree, bridged), then preprocess_ct
    --vit2d-checkpoint on each: the features of the two bf16 trunks agree,
    and the port's equal its trunk called on the slices the CLI made."""
    src = _trunk_file(tmp_path / "open_clip.bin")
    jfile, tfile = tmp_path / "vit2d_jax", tmp_path / "vit2d.pt"
    argv = ["--kind", "biomedclip", "--input", str(src), "--num-layers", "1"]
    with pytest.MonkeyPatch.context() as mp:  # the JAX CLI reads sys.argv
        mp.setattr(sys, "argv", ["convert_checkpoint", *argv, "--output", str(jfile)])
        jconvert.main()
    state = tconvert.main(argv + ["--output", str(tfile)], device="cpu")
    jax_vit = JaxViT2D(jcfg.ViT2DConfig(**VIT2D))
    tpl = jax.eval_shape(jax_vit.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    tpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tpl)
    want_state = flax_to_torch(jax.tree.map(np.asarray, jax_restore(str(jfile), tpl)))
    assert sorted(state) == sorted(want_state)
    assert all(torch.equal(state[k], v) for k, v in want_state.items())

    pre = dict(PRE, slice_size=224)
    with toy_configs(pre):
        out, manifest = run_both(tmp_path, nii, jax_flags=["--vit2d-checkpoint", str(jfile)],
                                 port_flags=["--vit2d-checkpoint", str(tfile)])
        model = tcli.load_vit2d(str(tfile), "cpu")
    for entry in manifest["train"]:
        want, got = load(out, entry["biomedclip_features"])
        assert got.shape == want.shape == (6, VIT2D["hidden_size"])
        assert got.dtype == np.float32
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= FEATURE_REL_L2, rel
        raw, slope, inter, _ = nii[2][entry["image"][0]]
        sl = tpre.extract_slices(torch.tensor(raw), slope, inter,
                                 tcfg.PreprocessConfig(**pre))
        with torch.inference_mode():
            direct = model(sl).float().numpy()
        np.testing.assert_array_equal(got, direct)
    assert isinstance(model, ViT2D)


ONLINE_VIT2D = dict(image_size=16, patch_size=8, hidden_size=32, mlp_dim=64,
                    num_layers=1, num_heads=2)


def with_trunk(build, vit2d_cls):
    def build_vlm_config(args):
        return dataclasses.replace(without_dropout(build)(args),
                                   vit2d=vit2d_cls(**ONLINE_VIT2D))

    return build_vlm_config


def without_slice_features(get):
    def wrapped(self, idx):
        sample = dict(get(self, idx))
        sample.pop("image_2d", None)
        return sample

    return wrapped


def test_train_vlm_online_slice_features_matches_jax(tmp_path):
    """`--synthetic --online-slice-features` on samples without image_2d
    (the synthetic datasets' `get` rebound to drop it), a toy trunk as wide
    as the synthetic tower and every dropout at 0, rebound in both CLIs:
    the port CLI trains the JAX CLI's init, trunk included, to the same
    losses."""
    flags = BASE + ["--total-steps", "1", "--online-slice-features"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvlm, "build_vlm_config", with_trunk(jvlm.build_vlm_config,
                                                        jcfg.ViT2DConfig))
        mp.setattr(tvlm, "build_vlm_config", with_trunk(tvlm.build_vlm_config,
                                                        tcfg.ViT2DConfig))
        for mod in (jdata, tdata):
            mp.setattr(mod.SyntheticCTDataset, "get",
                       without_slice_features(mod.SyntheticCTDataset.get))
        with recording(jvlm, jtrainer) as (runs, init):
            jvlm.main(flags + ["--output-dir", str(tmp_path / "jax")])
        want = runs[0]
        assert "slice_encoder" in init["params"]["params"]
        cfg = tvlm.build_vlm_config(argparse.Namespace(synthetic=True,
                                                       online_slice_features=True))
        model = HSENetVLM(cfg, dtype=torch.float32, device="cpu")
        model.load_state_dict(flax_to_torch(init["params"]), strict=True)
        trunk = {k: v.clone() for k, v in model.state_dict().items()
                 if k.startswith("slice_encoder.")}
        with recording(None, ttrainer) as (runs, _):
            state = tvlm.main(flags + ["--output-dir", str(tmp_path / "port")],
                              device="cpu", model=model)
    got = runs[0]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1]
    for key in ("loss", "token_acc", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=RTOL, atol=1e-6, err_msg=key)
    end = state.model.state_dict()
    assert all(torch.equal(end[k], v) for k, v in trunk.items())
    assert not any(k.startswith("slice_encoder.") for k in state.params)


def test_train_vlm_without_slice_features_exits_as_the_jax_cli(tmp_path):
    """No image_2d and no --online-slice-features: the JAX CLI's argparse
    error (exit code 2) in both."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdata, tdata):
            mp.setattr(mod.SyntheticCTDataset, "get",
                       without_slice_features(mod.SyntheticCTDataset.get))
        for main, kw in ((jvlm.main, {}), (tvlm.main, {"device": "cpu"})):
            with pytest.raises(SystemExit) as e:
                main(BASE + ["--total-steps", "1", "--output-dir", str(tmp_path)], **kw)
            assert e.value.code == 2
