"""The port's CT data path against the JAX package's, on the CPU: the NIfTI
reader and its native decoder (`hsenet_torch.data.nifti`,
`hsenet_torch.native`), the preprocessing (`data.preprocess`), the
augmentation (`data.augment`), the prefetcher (`data.prefetch`) and the
trainer's use of the last two (`train.trainer`).

Tolerances, each stated where it is held:
  * NIfTI: arrays, spacing, slope and intercept exactly equal.
  * `scale_and_translate` / `resize` against the JAX image functions:
    1e-5 absolute (f32 weight matrices; the contraction order differs).
  * volumes, `trilinear_resize` and linear slices: 1e-5 absolute; the
    faithful (cubic) slices 1e-4.
  * `extract_slices_uint8`: equal codes, except a code that sits on a
    rounding edge of floor(x * 255) may differ by one (at most
    U8_EDGE_CODES of them; ROADMAP §C records it as no fault); the
    faithful slices alike in the codes behind them (floor before the
    resize, round after it), and within 1e-4 where those are equal.
  * `reference_preprocess` (numpy in both packages): equal.
  * augmentation: `apply_augment` at the JAX draws equals `augment_batch`
    bit for bit; the port's own draws hit each probability within 5
    binomial standard deviations over AUG_SAMPLES samples.
  * prefetch and trainer: equal order and bit-equal losses.
"""

import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_torch.configs as tcfg
from hsenet_tpu.data import augment as jaug
from hsenet_tpu.data import nifti as jnifti
from hsenet_tpu.data import preprocess as jpre
from hsenet_torch import native as tnative
from hsenet_torch.data import augment as taug
from hsenet_torch.data import nifti as tnifti
from hsenet_torch.data import prefetch as tprefetch
from hsenet_torch.data import preprocess as tpre
from hsenet_torch.train import train_state as tts
from hsenet_torch.train import trainer as ttrainer
from hsenet_torch.train.vlm import make_masked_train_step

torch.set_num_threads(1)

ATOL = 1e-5
CUBIC_ATOL = 1e-4
U8_EDGE_CODES = 8
AUG_SAMPLES = 4000
DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64, np.int8,
          np.uint16, np.uint32]
J_CFG = jcfg.PreprocessConfig(target_shape=(16, 32, 32), num_slices=12,
                              slice_size=24)
T_CFG = tcfg.PreprocessConfig(target_shape=(16, 32, 32), num_slices=12,
                              slice_size=24)
SPACING = (1.2, 0.7, 0.8)  # zyx mm


# ---------------------------------------------------------------------------
# NIfTI
# ---------------------------------------------------------------------------


def _volume(dtype, shape=(7, 9, 11), seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -900), min(info.max, 900)
        return rng.integers(lo, hi, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _assert_same_volume(got, want):
    """Equal, after `want` is taken to `got`'s dtype (the native decoder
    gives float32, as the JAX package's does)."""
    np.testing.assert_array_equal(got.zyx_data,
                                  want.zyx_data.astype(got.zyx_data.dtype))
    assert got.zyx_spacing == want.zyx_spacing
    assert (got.scl_slope, got.scl_inter) == (want.scl_slope, want.scl_inter)


@pytest.mark.parametrize("gz", [False, True], ids=["nii", "gz"])
@pytest.mark.parametrize("dtype", DTYPES, ids=[np.dtype(d).name for d in DTYPES])
def test_reader_matches_jax_on_both_writers(tmp_path, dtype, gz):
    """Both packages' writers, both readers of the port (Python and native)
    against the JAX Python reader: every datatype, .gz and not."""
    data = _volume(dtype)
    suffix = ".nii.gz" if gz else ".nii"
    for i, write in enumerate((jnifti.write_nifti, tnifti.write_nifti)):
        path = str(tmp_path / f"v{i}{suffix}")
        write(path, data, spacing=(0.7, 0.8, 1.5), scl_slope=2.0, scl_inter=-3.0)
        want = jnifti.read_nifti(path, native="never")
        py = tnifti.read_nifti(path, native="never")
        assert py.data.dtype == want.data.dtype
        _assert_same_volume(py, want)
        _assert_same_volume(tnifti.read_nifti(path, native="require"), want)
    assert (tmp_path / f"v0{suffix}").read_bytes() == (tmp_path / f"v1{suffix}").read_bytes() \
        or gz  # gzip headers carry a time stamp


def _big_endian(path, data, spacing, slope, inter):
    """A big-endian NIfTI-1 file of int16 `data` (nx, ny, nz)."""
    header = bytearray(348)
    struct.pack_into(">i", header, 0, 348)
    struct.pack_into(">8h", header, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into(">h", header, 70, 4)
    struct.pack_into(">h", header, 72, 16)
    struct.pack_into(">8f", header, 76, 1.0, *spacing, 0, 0, 0, 0)
    struct.pack_into(">f", header, 108, 352.0)
    struct.pack_into(">f", header, 112, slope)
    struct.pack_into(">f", header, 116, inter)
    header[344:348] = b"n+1\x00"
    body = data.astype(">i2").tobytes(order="F")
    with open(path, "wb") as f:
        f.write(bytes(header) + b"\x00" * 4 + body)


def test_big_endian_header(tmp_path):
    data = _volume(np.int16, (5, 6, 4))
    path = str(tmp_path / "be.nii")
    _big_endian(path, data, (0.5, 0.6, 2.5), 1.5, -7.0)
    want = jnifti.read_nifti(path, native="never")
    np.testing.assert_array_equal(want.data, data)
    for native in ("never", "require"):
        _assert_same_volume(tnifti.read_nifti(path, native=native), want)


@pytest.mark.parametrize("slope,inter,want", [
    (0.0, 5.0, (1.0, 5.0)), (float("nan"), 5.0, (1.0, 5.0)),
    (2.0, float("nan"), (2.0, 0.0))], ids=["slope0", "slope-nan", "inter-nan"])
def test_slope_and_intercept_defaults(tmp_path, slope, inter, want):
    path = str(tmp_path / "s.nii")
    tnifti.write_nifti(path, _volume(np.int16), scl_slope=slope, scl_inter=inter)
    j = jnifti.read_nifti(path, native="never")
    for native in ("never", "require"):
        t = tnifti.read_nifti(path, native=native)
        assert (t.scl_slope, t.scl_inter) == (j.scl_slope, j.scl_inter) == want


def test_native_decode_probe_and_batch(tmp_path):
    """The native entry points against the Python parser: the decode with
    the slope and intercept folded in, the probe, the thread-pool batch."""
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"b{i}.nii.gz"))
        tnifti.write_nifti(paths[-1], _volume(np.int16, seed=i),
                           spacing=(1.0, 2.0, 3.0), scl_slope=0.5, scl_inter=10.0)
    py = [tnifti.read_nifti(p, native="never") for p in paths]
    assert tnative.probe(paths[0]) == ((11, 9, 7), (3.0, 2.0, 1.0), 0.5, 10.0)
    scl, spacing, s, i = tnative.decode(paths[0], apply_scl=True)
    assert (s, i, spacing) == (1.0, 0.0, (3.0, 2.0, 1.0))
    np.testing.assert_array_equal(
        scl, np.float32(0.5) * py[0].zyx_data.astype(np.float32) + np.float32(10.0))
    batch = tnative.decode_batch(paths, (11, 9, 7), num_threads=2)
    np.testing.assert_array_equal(batch, np.stack([v.zyx_data for v in py]))


@pytest.mark.parametrize("corrupt", ["magic", "sizeof", "header", "data"])
def test_corrupt_and_truncated_files_raise(tmp_path, corrupt):
    path = str(tmp_path / "c.nii")
    tnifti.write_nifti(path, _volume(np.int16))
    raw = bytearray(Path(path).read_bytes())
    if corrupt == "magic":
        raw[344:348] = b"xx1\x00"
    elif corrupt == "sizeof":
        raw[0:4] = struct.pack("<i", 1234)
    elif corrupt == "header":
        raw = raw[:200]
    else:
        raw = raw[:352 + 100]
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        jnifti.read_nifti(path, native="never")
    for native in ("never", "require"):
        with pytest.raises(ValueError):
            tnifti.read_nifti(path, native=native)


_BUILD_SCRIPT = """
import sys, time
from pathlib import Path
import hsenet_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
print(n.available(), n.load_error, flush=True)
"""


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two processes building into one empty directory at the same moment:
    both load the library (one compiles, the other waits on the lock), and
    no temporary file is left behind."""
    start = time.time() + 4.0  # past both interpreters' start-up
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path), str(start)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=Path(__file__).resolve().parent.parent) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [o.strip() for o in outs] == ["True None", "True None"], outs
    built = sorted(p.name for p in tmp_path.iterdir())
    assert [b for b in built if b.endswith(".so")] == [tnative.library_path().name]
    assert not [b for b in built if b.endswith(".tmp")]


# ---------------------------------------------------------------------------
# Resampling and preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["linear", "cubic"])
@pytest.mark.parametrize("antialias", [True, False], ids=["aa", "no-aa"])
@pytest.mark.parametrize("shape", [(3, 41, 9), (3, 7, 30)], ids=["up-down", "down-up"])
def test_resize_and_scale_and_translate_match_jax(kernel, antialias, shape):
    x = np.random.default_rng(1).random((3, 20, 17), np.float32)
    want = jax.image.resize(jnp.asarray(x), shape, kernel, antialias=antialias)
    got = tpre.resize(torch.tensor(x), shape, kernel, antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    scale, shift = [1.3, 0.45], [2.5, -1.7]
    want = jax.image.scale_and_translate(
        jnp.asarray(x), shape, (1, 2), jnp.array(scale), jnp.array(shift),
        kernel, antialias=antialias)
    got = tpre.scale_and_translate(torch.tensor(x), shape, (1, 2), scale, shift,
                                   kernel, antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _raw(shape=(20, 48, 40), seed=0, background=True):
    """Stored values of a toy CT: noise in HU, with air borders that the
    foreground box crops away."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-1024, 1500, shape).astype(np.float32)
    if background:
        raw[:, :5] = -1024
        raw[:3] = -2000
        raw[:, :, -7:] = -1500
    return raw


@pytest.mark.parametrize("case", ["background", "full", "shallow"])
def test_preprocess_volumes_match_jax(case):
    raw = _raw((20, 48, 40) if case != "shallow" else (6, 30, 26),
               background=case != "full")
    want = np.asarray(jpre.preprocess_volume(jnp.asarray(raw), jnp.float32(1.0),
                                             jnp.float32(-24.0), J_CFG))
    got = tpre.preprocess_volume(torch.tensor(raw), 1.0, -24.0, T_CFG).numpy()
    assert got.shape == want.shape == (1, *T_CFG.target_shape)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    inter = jpre.spacing_resample_shape(raw.shape, SPACING, J_CFG)
    assert inter == tpre.spacing_resample_shape(raw.shape, SPACING, T_CFG)
    want = np.asarray(jpre.preprocess_volume_faithful(
        jnp.asarray(raw), jnp.float32(1.0), jnp.float32(-24.0), inter, J_CFG))
    got = tpre.preprocess_volume_faithful(torch.tensor(raw), 1.0, -24.0, inter,
                                          T_CFG).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_preprocess_batch_matches_jax():
    raws = np.stack([_raw(seed=2), _raw(seed=3, background=False)])
    slopes, inters = np.array([1.0, 2.0], np.float32), np.array([0.0, -10.0], np.float32)
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(raws), jnp.asarray(slopes),
                                            jnp.asarray(inters), J_CFG))
    got = tpre.preprocess_batch(torch.tensor(raws), torch.tensor(slopes),
                                torch.tensor(inters), T_CFG).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # each volume of the batch is the volume alone
    alone = tpre.preprocess_volume(torch.tensor(raws[1]), 2.0, -10.0, T_CFG).numpy()
    np.testing.assert_allclose(got[1], alone, atol=ATOL, rtol=0)


@pytest.mark.parametrize("box", [False, True], ids=["plain", "bbox"])
def test_trilinear_resize_matches_jax(box):
    vol = np.random.default_rng(4).random((11, 19, 14), np.float32)
    out = (7, 25, 9)
    if box:
        lo, hi = np.array([2, 3, 0], np.int32), np.array([9, 19, 8], np.int32)
        want = jpre.trilinear_resize(jnp.asarray(vol), out, jnp.asarray(lo),
                                     jnp.asarray(hi))
        got = tpre.trilinear_resize(torch.tensor(vol), out, torch.tensor(lo),
                                    torch.tensor(hi))
    else:
        want = jpre.trilinear_resize(jnp.asarray(vol), out)
        got = tpre.trilinear_resize(torch.tensor(vol), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _u8_codes(raw, inter):
    """Both packages' floor(x * 255) slice codes of `raw`."""
    want = np.asarray(jpre.extract_slices_uint8(
        jnp.asarray(raw), jnp.float32(1.0), jnp.float32(0.0), J_CFG, inter))
    got = tpre.extract_slices_uint8(torch.tensor(raw), 1.0, 0.0, T_CFG, inter).numpy()
    return got, want


@pytest.mark.parametrize("resample", [False, True], ids=["raw-grid", "spacing"])
@pytest.mark.parametrize("faithful", [False, True], ids=["fast", "faithful"])
@pytest.mark.parametrize("depth", [20, 8], ids=["deep", "shallow"])
def test_extract_slices_match_jax(depth, faithful, resample):
    """Linear slices within ATOL. Faithful slices within CUBIC_ATOL where
    the uint8 codes behind them (floor before the resize, round after it)
    are equal; where a value sits on a rounding edge the codes may be one
    apart (at most U8_EDGE_CODES of them)."""
    raw = _raw((depth, 48, 40), seed=5)
    inter = (jpre.spacing_resample_shape(raw.shape, SPACING, J_CFG)
             if resample else None)
    want = np.asarray(jpre.extract_slices(
        jnp.asarray(raw), jnp.float32(1.0), jnp.float32(0.0), J_CFG, inter, faithful))
    got = tpre.extract_slices(torch.tensor(raw), 1.0, 0.0, T_CFG, inter,
                              faithful).numpy()
    assert got.shape == want.shape == (12, 24, 24, 3)
    if not faithful:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        return
    assert_faithful_slices_close(got, want)


def slice_codes(slices):
    """The uint8 codes behind CLIP-normalised faithful slices (n, S, S, 3):
    round((x * std + mean) * 255) of the first channel."""
    gray = slices[..., 0] * np.float32(tpre._CLIP_STD[0]) + np.float32(tpre._CLIP_MEAN[0])
    return np.round(gray * 255).astype(np.int16)


def assert_faithful_slices_close(got, want):
    codes, jax_codes = slice_codes(got), slice_codes(want)
    moved = codes != jax_codes
    assert np.abs(codes - jax_codes).max() <= 1
    assert moved.sum() <= U8_EDGE_CODES
    assert np.abs(got - want)[~moved].max() <= CUBIC_ATOL


def test_extract_slices_uint8_match_jax():
    """Codes equal but where floor(x * 255) sits on a rounding edge: there
    the slice value before the floor is within ATOL of a code's edge (the
    two packages' f32 values differ within ATOL) and the codes differ by
    one; at most U8_EDGE_CODES such codes over the three inputs."""
    edges = 0
    for depth, resample in ((20, False), (20, True), (8, True), (8, False)):
        raw = _raw((depth, 48, 40), seed=5)
        inter = (jpre.spacing_resample_shape(raw.shape, SPACING, J_CFG)
                 if resample else None)
        got, want = _u8_codes(raw, inter)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        diff = got.astype(int) - want.astype(int)
        assert np.abs(diff).max(initial=0) <= 1
        if diff.any():
            x = torch.rot90(tpre._slices_from_hu(torch.tensor(raw), 1.0, 0.0, T_CFG,
                                                 inter), -1, (1, 2)).numpy() * 255
            near = np.abs(x - np.round(x))[diff != 0]
            assert near.max() < 255 * ATOL
        edges += int(np.count_nonzero(diff))
    assert edges <= U8_EDGE_CODES


def test_slice_indices_match_jax_linspace():
    for d in range(32, 700):
        want = np.asarray(jnp.linspace(0, d - 1, 32).astype(jnp.int32)).tolist()
        assert tpre._slice_indices(d, 32) == want, d


@pytest.mark.parametrize("mode", ["trilinear", "area", "nearest"])
def test_reference_preprocess_equals_jax(mode):
    raw = _raw((12, 30, 26), seed=7)
    want = jpre.reference_preprocess(raw, 1.0, -24.0, SPACING, J_CFG, mode)
    got = tpre.reference_preprocess(raw, 1.0, -24.0, SPACING, T_CFG, mode)
    np.testing.assert_array_equal(got, want)


def test_jpeg_roundtrip_equals_jax():
    u8 = (np.random.default_rng(8).random((3, 40, 30)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tpre.slices_jpeg_roundtrip_host(u8, T_CFG),
                                  jpre.slices_jpeg_roundtrip_host(u8, J_CFG))


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

AUG = dict(rot90_prob=0.6, flip_prob=0.5, scale_intensity_prob=0.5,
           scale_intensity_factor=0.1, shift_intensity_prob=0.5,
           shift_intensity_offset=0.1)


def jax_draws(key, batch, cfg):
    """The draws `augment_batch` makes under `key`, by `_augment_one`'s own
    calls."""
    rot, flip, scale, shift = [], [], [], []
    for k1 in jax.random.split(key, batch):
        k = jax.random.split(k1, 8)
        do_rot = jax.random.uniform(k[0]) < cfg.rot90_prob
        rot.append(int(jnp.where(do_rot, jax.random.randint(k[1], (), 1, 4), 0)))
        flip.append([bool(jax.random.uniform(k[2 + i]) < cfg.flip_prob)
                     for i in range(3)])
        factor = 1.0 + jax.random.uniform(k[6], minval=-cfg.scale_intensity_factor,
                                          maxval=cfg.scale_intensity_factor)
        do_scale = jax.random.uniform(k[5]) < cfg.scale_intensity_prob
        scale.append(float(jnp.where(do_scale, factor, 1.0)))
        offset = jax.random.uniform(jax.random.fold_in(k[7], 1),
                                    minval=-cfg.shift_intensity_offset,
                                    maxval=cfg.shift_intensity_offset)
        do_shift = jax.random.uniform(k[7]) < cfg.shift_intensity_prob
        shift.append(float(jnp.where(do_shift, offset, 0.0)))
    return taug.AugmentDraws(
        rot90=torch.tensor(rot), flip=torch.tensor(flip),
        scale=torch.tensor(scale, dtype=torch.float32),
        shift=torch.tensor(shift, dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augment_at_jax_draws_is_augment_batch(seed):
    vols = np.random.default_rng(seed).random((8, 1, 4, 6, 6), np.float32)
    key = jax.random.PRNGKey(seed)
    cfg = jcfg.AugmentConfig(**AUG)
    want = np.asarray(jaug.augment_batch(jnp.asarray(vols), key, cfg))
    draws = jax_draws(key, 8, cfg)
    assert draws.rot90.any() and draws.flip.any()
    got = taug.apply_augment(torch.tensor(vols), draws).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_draws_hit_their_probabilities():
    cfg = tcfg.AugmentConfig(**AUG)
    d = taug.draw_augment(torch.Generator().manual_seed(0), AUG_SAMPLES, cfg)
    n = AUG_SAMPLES

    def within(hits, p):
        assert abs(int(hits) - n * p) <= 5 * np.sqrt(n * p * (1 - p)), (hits, p)

    within((d.rot90 != 0).sum(), cfg.rot90_prob)
    for axis in range(3):
        within(d.flip[:, axis].sum(), cfg.flip_prob)
    within((d.scale != 1).sum(), cfg.scale_intensity_prob)
    within((d.shift != 0).sum(), cfg.shift_intensity_prob)
    turned = d.rot90[d.rot90 != 0]
    for k in (1, 2, 3):
        within((turned == k).sum() * n / len(turned), 1 / 3)
    assert (d.scale - 1).abs().max() <= cfg.scale_intensity_factor
    assert d.shift.abs().max() <= cfg.shift_intensity_offset
    again = taug.draw_augment(torch.Generator().manual_seed(0), AUG_SAMPLES, cfg)
    assert torch.equal(again.scale, d.scale) and torch.equal(again.rot90, d.rot90)


def test_zero_probabilities_pass_the_batch_unchanged():
    vols = torch.rand(4, 1, 3, 5, 5)
    cfg = tcfg.AugmentConfig(rot90_prob=0, flip_prob=0, scale_intensity_prob=0,
                             shift_intensity_prob=0)
    out = taug.augment_batch(vols, torch.Generator().manual_seed(1), cfg)
    assert torch.equal(out, vols)


# ---------------------------------------------------------------------------
# Prefetch and the trainer
# ---------------------------------------------------------------------------


def _producers():
    return [t for t in threading.enumerate() if t.name == tprefetch.PRODUCER_NAME]


def test_prefetch_keeps_order_and_stops_on_break():
    batches = [{"x": np.full((2,), i, np.float32), "name": f"b{i}"} for i in range(7)]
    got = [b["x"] for b in tprefetch.DevicePrefetcher(batches, depth=2)]
    assert [int(x[0]) for x in got] == list(range(7))
    assert all(isinstance(x, torch.Tensor) for x in got)

    def endless():
        i = 0
        while True:
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    for i, b in enumerate(tprefetch.DevicePrefetcher(endless(), depth=2)):
        assert int(b["x"][0]) == i
        if i == 3:
            break
    deadline = time.time() + 5
    while _producers() and time.time() < deadline:
        time.sleep(0.01)
    assert not _producers()


def test_prefetch_reraises_the_producers_exception():
    def failing():
        yield {"x": np.zeros(1, np.float32)}
        raise KeyError("manifest entry")

    it = iter(tprefetch.DevicePrefetcher(failing(), depth=2))
    assert float(next(it)["x"][0]) == 0.0
    with pytest.raises(KeyError, match="manifest entry"):
        next(it)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(2 * 4 * 6 * 6, generator=g) * 0.1)

    def forward(self, image):
        return (image.flatten(1) @ self.w).square().mean()


def _fit(cfg, total, state=None, augment=tcfg.AugmentConfig(**AUG)):
    """A toy model trained on 5 batches an epoch of 2 (2, 4, 6, 6) volumes,
    from `state` if given; returns (state, logged (step, loss) pairs)."""
    rng = np.random.default_rng(9)
    data = [{"image": rng.random((2, 2, 4, 6, 6), np.float32)} for _ in range(5)]
    tx = tts.make_optimizer(cfg)
    if state is None:
        state = tts.TrainState.create(_Toy(), tx)
    model = state.model

    def loss_fn(batch, generator):
        loss = model(batch["image"])
        return loss, {"loss": loss}

    trainer = ttrainer.Trainer(make_masked_train_step(loss_fn, tx), state,
                               lambda: data, cfg, augment=augment)
    state = trainer.fit(total)
    return state, [(r["step"], r["loss"]) for r in trainer.history]


def test_trainer_augments_and_prefetch_changes_nothing():
    """Trainer(augment=AugmentConfig(), device_prefetch=2) equals
    device_prefetch=0 bit for bit, and differs from the run without
    augmentation."""
    base = tcfg.TrainConfig(learning_rate=1e-2, log_every=1, warmup_ratio=0.0,
                            total_steps=7, device_prefetch=0)
    _, plain = _fit(base, 7)
    _, fetched = _fit(tcfg.TrainConfig(**{**base.__dict__, "device_prefetch": 2}), 7)
    _, bare = _fit(base, 7, augment=None)
    assert fetched == plain
    assert [s for s, _ in plain] == list(range(1, 8))
    assert plain != bare


def test_resumed_augmented_run_equals_the_unbroken_run():
    """Stopped at step 3 (inside the first epoch of 5) and resumed to 7: the
    same batches, augmentations and losses as the unbroken run."""
    cfg = tcfg.TrainConfig(learning_rate=1e-2, log_every=1, warmup_ratio=0.0,
                           total_steps=7)
    _, whole = _fit(cfg, 7)
    state, first = _fit(cfg, 3)
    _, rest = _fit(cfg, 7, state=state)
    assert first + rest == whole
