"""CT preprocessing on the device (the port of the JAX package's
data/preprocess.py).

The reference runs this offline as a farm of scripts writing .npy files
(`Data/data_processing/CT-RATE/*.py`). Here each volume is one sequence of
tensor ops on the card, with the foreground box kept on the device:

  reference chain (nii_to_3D:41-124):
    HU = slope*raw + inter -> clamp[-1000, 200] -> trilinear resample to
    (1.5, 0.75, 0.75) mm -> min-max normalize -> CropForeground(>0) ->
    Resize (32,256,256)
  `preprocess_volume` (the fast default):
    HU window -> min-max normalize -> foreground bbox (>0) -> ONE
    `scale_and_translate` from the bbox straight to (32,256,256).
  `preprocess_volume_faithful`: the reference's two interpolations (a
    spacing resample to an intermediate grid computed on the host from
    the voxel spacing, then crop-foreground + trilinear resize).

`reference_preprocess` is the reference chain in numpy, the oracle of both.

The 2D-slice path (CT-RATE_nii_to_2D_slices.py:183-242): clamp [-1000,1000]
-> /1000 -> spacing resample -> 32 evenly spaced z-slices (trilinear
z-upsample when depth < 32) -> per-slice min-max. `extract_slices` gives
BiomedCLIP-ready (32, 224, 224, 3) tensors.

`scale_and_translate` and `resize` compute what the JAX package's image
resampling computes: one (in, out) weight matrix per axis (a triangle or
Keys cubic kernel, widened by 1/scale when antialiasing a downsample,
columns normalised by their sum, zero where the sample lies wholly outside
the input), applied one axis at a time as an f32 product without TF32.
`F.interpolate` is another function (its antialias differs and it takes
no per-volume translation), so nothing here calls it. With a (B, K) scale
and translation the matrices are per volume, (B, in, out), as under the
JAX package's vmap: `preprocess_batch` needs no host sync.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hsenet_torch.configs import PreprocessConfig

# open_clip BiomedCLIP normalization (OpenAI CLIP stats)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_F32_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def _triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle_kernel, "bilinear": _triangle_kernel,
            "trilinear": _triangle_kernel, "cubic": _keys_cubic_kernel,
            "bicubic": _keys_cubic_kernel}


def compute_weight_mat(input_size: int, output_size: int,
                       inv_scale: torch.Tensor, shift: torch.Tensor,
                       kernel: str, antialias: bool) -> torch.Tensor:
    """(..., input_size, output_size) f32 resampling weights for output
    coordinate o = scale * i + translation (pixel centres at i + 0.5), given
    inv_scale = 1 / scale and shift = translation / scale as f32 tensors of
    shape (...)."""
    fill = _KERNELS[kernel]
    dev = inv_scale.device
    # a downsample widens the kernel to low-pass filter; an upsample only
    # interpolates
    kernel_scale = (torch.clamp_min(inv_scale, 1.0) if antialias
                    else torch.ones_like(inv_scale))
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale[..., None] - shift[..., None] - 0.5)
    x = (torch.abs(sample_f[..., None, :]
                   - torch.arange(input_size, dtype=torch.float32, device=dev)[:, None])
         / kernel_scale[..., None, None])
    weights = fill(x)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    # zero where the sample lies wholly outside the input (sample_f has the
    # 0.5 taken off already)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


@contextlib.contextmanager
def _exact_f32():
    """f32 products on the card without TF32 for the duration."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _apply_axis(x: torch.Tensor, axis: int, w: torch.Tensor) -> torch.Tensor:
    """Contract `x`'s `axis` with w (in, out), or per leading batch row with
    w (B, in, out)."""
    moved = x.movedim(axis, -1)
    if w.dim() == 3:
        w = w.view(w.shape[0], *([1] * (moved.dim() - 3)), *w.shape[1:])
    with _exact_f32():
        return torch.matmul(moved, w).movedim(-1, axis)


def _resample(x, out_shape, axes, inv_scale, shift, kernel, antialias):
    for i, axis in enumerate(axes):
        axis = axis % x.dim()
        w = compute_weight_mat(x.shape[axis], out_shape[axis], inv_scale[..., i],
                               shift[..., i], kernel, antialias)
        x = _apply_axis(x, axis, w)
    return x


def scale_and_translate(x: torch.Tensor, out_shape: Sequence[int],
                        axes: Sequence[int], scale, translation,
                        kernel: str = "linear",
                        antialias: bool = True) -> torch.Tensor:
    """Resample f32 `x` to `out_shape` over `axes`: output coordinate o =
    scale * i + translation along each axis (half-centred pixels; samples
    outside the input give 0).

    `scale` and `translation` hold one value per axis, shape (K,), or one
    row per leading batch entry of `x`, shape (B, K): then each volume has
    its own matrices. They are taken as f32 tensors first, as the JAX
    function takes them. `kernel` is "linear" or "cubic" (Keys, a = -0.5)."""
    x = x.float()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=x.device)
    if scale.shape[-1] != len(axes) or translation.shape != scale.shape:
        raise ValueError(f"scale {tuple(scale.shape)} and translation "
                         f"{tuple(translation.shape)} for axes {tuple(axes)}")
    if scale.dim() == 2 and (scale.shape[0] != x.shape[0] or 0 in axes):
        raise ValueError("per-volume scales need the batch on axis 0 of x, "
                         "which is not resampled")
    inv_scale = 1.0 / scale
    return _resample(x, out_shape, axes, inv_scale, translation * inv_scale,
                     kernel, antialias)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """Resize every axis whose size changes (scale out/in, no translation);
    the others are left as they are. As in the JAX function, 1/scale is
    taken in double precision on the host, then rounded to f32."""
    x = x.float()
    axes = [d for d in range(x.dim()) if x.shape[d] != shape[d]]
    if not axes:
        return x
    inv_scale = torch.tensor([1.0 / (shape[d] / x.shape[d]) for d in axes],
                             dtype=torch.float32, device=x.device)
    return _resample(x, shape, axes, inv_scale, torch.zeros_like(inv_scale),
                     method, antialias)


def _foreground_bbox(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (..., D, H, W) bool -> (lo, hi) int32 (..., 3), MONAI
    CropForeground(>0); an empty mask gives the full extent."""
    los, his = [], []
    nd = mask.dim()
    for axis in range(3):
        others = tuple(nd - 3 + a for a in range(3) if a != axis)
        line = mask.any(dim=others[1]).any(dim=others[0])  # (..., n)
        n = line.shape[-1]
        idx = torch.arange(n, device=mask.device)
        lo = torch.where(line, idx, n).amin(dim=-1)
        hi = torch.where(line, idx, -1).amax(dim=-1) + 1
        lo = torch.where(hi <= lo, 0, lo)
        hi = torch.where(hi <= 0, n, hi)
        los.append(lo)
        his.append(hi)
    return (torch.stack(los, dim=-1).to(torch.int32),
            torch.stack(his, dim=-1).to(torch.int32))


def _as_f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded once. The CUDA kernel of a division by a Python
    number multiplies by its reciprocal (one rounding more), which at a
    sample coordinate near 512 moves an output next to a sharp edge by
    up to ~3e-5 (a card run, H100); a divisor on the device divides."""
    return x / _as_f32(d, x)


def _linear_resize_axis(vol, axis, n_out, lo, hi):
    """align_corners=False linear resample of one axis onto [lo, hi): the
    reference's crop-then-resize as one gather + lerp, sampling clamped to
    the box so that no value from outside it leaks in. `lo`/`hi` are ints
    or int tensors on the device."""
    dev = vol.device
    lo = torch.as_tensor(lo, dtype=torch.int32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=dev)
    extent = (hi - lo).float()
    coords = (lo.float()
              + _div((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
                     * extent, n_out) - 0.5)
    low = torch.floor(coords)
    frac = coords - low
    low = low.to(torch.int64)
    i0 = torch.minimum(torch.maximum(low, lo), hi - 1)
    i1 = torch.minimum(torch.maximum(low + 1, lo), hi - 1)
    a = torch.index_select(vol, axis, i0)
    b = torch.index_select(vol, axis, i1)
    shape = [1] * vol.dim()
    shape[axis] = n_out
    frac = frac.view(shape)
    return a * (1.0 - frac) + b * frac


def trilinear_resize(vol: torch.Tensor, out_shape, blo=None, bhi=None):
    """Separable align_corners=False trilinear resize (F.interpolate
    semantics, done as gathers). With `blo`/`bhi` (int32 (3,) tensors) the
    source region is that box: crop + resize as one op."""
    for axis in range(3):
        lo = 0 if blo is None else blo[axis]
        hi = vol.shape[axis] if bhi is None else bhi[axis]
        if blo is None and vol.shape[axis] == out_shape[axis]:
            continue  # the reference skips an axis of equal size
        vol = _linear_resize_axis(vol, axis, out_shape[axis], lo, hi)
    return vol


def spacing_resample_shape(shape, spacing_zyx,
                           config: PreprocessConfig = PreprocessConfig()):
    """Host helper: the intermediate grid of the reference's spacing
    resample (nii_to_3D resize_array, :24-38). The reference computes the
    per-axis factor first, then truncates shape*factor: 40 voxels at 1.2 mm
    -> int(40 * (1.2/0.75)) == 63, not 64."""
    factors = [spacing_zyx[i] / config.target_spacing[i] for i in range(3)]
    return tuple(max(1, int(shape[i] * factors[i])) for i in range(3))


# ---------------------------------------------------------------------------
# Volumes
# ---------------------------------------------------------------------------




def preprocess_volume_faithful(
    raw: torch.Tensor,  # (D, H, W) raw stored values
    slope,
    intercept,
    intermediate_shape: Tuple[int, int, int],
    config: PreprocessConfig = PreprocessConfig(),
) -> torch.Tensor:
    """The reference's two-interpolation chain -> (1, 32, 256, 256) f32.

    `intermediate_shape` is the spacing-resample grid, from
    `spacing_resample_shape(raw.shape, spacing_zyx)`. Chain
    (nii_to_3D:41-124): HU -> clamp -> trilinear resample to the target
    spacing -> min-max -> CropForeground(>0) -> trilinear resize to
    target_shape (crop and resize as one gather)."""
    hu = _as_f32(slope, raw) * raw.float() + _as_f32(intercept, raw)
    hu = torch.clamp(hu, config.hu_min, config.hu_max)
    hu = trilinear_resize(hu, intermediate_shape)
    lo, hi = hu.amin(), hu.amax()
    vol = (hu - lo) / torch.clamp_min(hi - lo, 1e-8)
    # CropForeground(>0) with an epsilon: after interpolation the background
    # is the minimum only up to f32 rounding
    blo, bhi = _foreground_bbox(vol > 1e-6)
    out = trilinear_resize(vol, config.target_shape, blo, bhi)
    return torch.clamp(out, 0.0, 1.0)[None]


def _preprocess_fused(raws, slopes, intercepts, config, antialias):
    """The fused chain over a batch: raws (B, D, H, W), slopes and
    intercepts (B,) -> (B, 1, *target_shape)."""
    hu = slopes[:, None, None, None] * raws.float() + intercepts[:, None, None, None]
    hu = torch.clamp(hu, config.hu_min, config.hu_max)
    lo = hu.amin(dim=(1, 2, 3), keepdim=True)
    hi = hu.amax(dim=(1, 2, 3), keepdim=True)
    vol = (hu - lo) / torch.clamp_min(hi - lo, 1e-8)
    blo, bhi = _foreground_bbox(vol > 0)  # (B, 3)
    out_shape = config.target_shape
    scale = (torch.tensor(out_shape, dtype=torch.float32, device=raws.device)
             / (bhi - blo).float())
    # input pixel centre i maps to o = scale*i + translation; aligning the
    # box's edges [blo-0.5, bhi-0.5) with the output's [-0.5, out-0.5) gives
    # t = -blo*s + (s-1)/2 (align_corners=False, like the reference)
    translation = -blo.float() * scale + 0.5 * (scale - 1.0)
    out = scale_and_translate(vol, (vol.shape[0], *out_shape), (1, 2, 3), scale,
                              translation, "linear", antialias)
    return torch.clamp(out, 0.0, 1.0)[:, None]


def preprocess_volume(
    raw: torch.Tensor,  # (D, H, W) raw stored values
    slope,
    intercept,
    config: PreprocessConfig = PreprocessConfig(),
    antialias: bool = False,
) -> torch.Tensor:
    """The fused fast path -> (1, 32, 256, 256) f32 in [0, 1]."""
    return _preprocess_fused(raw[None], _as_f32(slope, raw).reshape(1),
                             _as_f32(intercept, raw).reshape(1), config,
                             antialias)[0]


def preprocess_batch(raws, slopes, intercepts, config=PreprocessConfig()):
    """The fused path over a stacked batch of same-shape raws (B, D, H, W)
    with (B,) slopes and intercepts -> (B, 1, 32, 256, 256); each volume's
    box and matrices stay on the device."""
    return _preprocess_fused(raws, _as_f32(slopes, raws).reshape(-1),
                             _as_f32(intercepts, raws).reshape(-1), config, False)


# ---------------------------------------------------------------------------
# Slices
# ---------------------------------------------------------------------------


def _slice_indices(d: int, n: int) -> list:
    """The z index of each of n evenly spaced slices over depth d, with the
    JAX package's f32 linspace (start (1 - t) + stop t, t = i/(n-1), the last
    one stop itself) truncated to int, so an index on a rounding edge lands
    where it lands there."""
    if n == 1:
        return [0]
    t = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    pos = np.float32(0) * (np.float32(1) - t) + np.float32(d - 1) * t
    return [int(v) for v in pos.astype(np.int32)] + [d - 1]


def _slices_from_hu(raw, slope, intercept, config, intermediate_shape):
    """The shared HU / resample / slice-selection head of the 2D path ->
    (n, H, W) in [0, 1] after a per-slice min-max."""
    hu = _as_f32(slope, raw) * raw.float() + _as_f32(intercept, raw)
    hu = _div(torch.clamp(hu, config.slice_hu_min, config.slice_hu_max),
              abs(config.slice_hu_max))
    if intermediate_shape is not None:
        hu = trilinear_resize(hu, intermediate_shape)
    d, n = hu.shape[0], config.num_slices
    if d >= n:
        # evenly spaced slices (reference :204-214: linspace + index)
        slices = hu[torch.tensor(_slice_indices(d, n), device=hu.device)]
    else:
        # depth < n: trilinear z-upsample, align_corners=False (:216-221)
        slices = trilinear_resize(hu, (n, *hu.shape[1:]))
    # per-slice min-max (reference :231-236)
    mn = slices.amin(dim=(1, 2), keepdim=True)
    mx = slices.amax(dim=(1, 2), keepdim=True)
    return (slices - mn) / torch.clamp_min(mx - mn, 1e-8)


def clip_normalize(gray: torch.Tensor) -> torch.Tensor:
    """(..., H, W) in [0, 1] -> (..., H, W, 3) CLIP-normalised."""
    rgb = gray[..., None].expand(*gray.shape, 3)
    mean = torch.tensor(_CLIP_MEAN, dtype=torch.float32, device=gray.device)
    std = torch.tensor(_CLIP_STD, dtype=torch.float32, device=gray.device)
    return (rgb - mean) / std


def extract_slices(
    raw: torch.Tensor,  # (D, H, W)
    slope,
    intercept,
    config: PreprocessConfig = PreprocessConfig(),
    intermediate_shape: Optional[Tuple[int, int, int]] = None,
    faithful: bool = False,
) -> torch.Tensor:
    """-> (num_slices, S, S, 3) f32, CLIP-normalised, for the 2D trunk.

    `intermediate_shape` (from `spacing_resample_shape`) reproduces the
    reference's spacing resample before slice selection
    (CT-RATE_nii_to_2D_slices.py:189-196); without it slices are picked on
    the raw z grid and the final resize takes the xy geometry.

    `faithful=True` is the reference's offline image chain, the one every
    released stage-2/VLM checkpoint's (32, 768) features went through
    (CT-RATE_nii_to_2D_slices.py:230-242 + CT-RATE_2D_to_npy_file.py:49-98):
    per-slice [0,255] quantization with torch's truncating uint8 cast ->
    -90 degree rotation (PIL rotate(-90, expand=True)) -> antialiased
    bicubic resize to 224 (+ the uint8 quantization PIL applies after it)
    -> CLIP normalize. For byte-exact regeneration through the reference's
    JPEG codec use `cli/preprocess_ct --slice-jpeg-roundtrip`."""
    slices = _slices_from_hu(raw, slope, intercept, config, intermediate_shape)
    n, s = config.num_slices, config.slice_size
    if not faithful:
        return clip_normalize(resize(slices, (n, s, s), "linear"))

    # [0,1] -> 0..255 with torch's `.to(torch.uint8)` truncation
    # (nii_to_2D_slices.py:71)
    u8 = torch.clamp(torch.floor(slices * 255.0), 0, 255)
    # PIL rotate(-90, expand=True): (n, H, W) -> (n, W, H)
    x = _div(torch.rot90(u8, k=-1, dims=(1, 2)), 255.0)
    h, w = x.shape[1], x.shape[2]
    if h == w:
        x = resize(x, (n, s, s), "cubic", antialias=True)
    else:
        # shorter side -> S, then centre crop (torchvision semantics)
        if h < w:
            nh, nw = s, int(round(w * s / h))
        else:
            nh, nw = int(round(h * s / w)), s
        x = resize(x, (n, nh, nw), "cubic", antialias=True)
        top, left = (nh - s) // 2, (nw - s) // 2
        x = x[:, top:top + s, left:left + s]
    # the resized PIL image is still uint8 before ToTensor divides by 255
    x = _div(torch.clamp(torch.round(x * 255.0), 0, 255), 255.0)
    return clip_normalize(x)


def extract_slices_uint8(
    raw: torch.Tensor,
    slope,
    intercept,
    config: PreprocessConfig = PreprocessConfig(),
    intermediate_shape: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """-> (num_slices, W, H) uint8: the reference's rotated full-resolution
    slices as PIL saw them before the JPEG save
    (CT-RATE_nii_to_2D_slices.py:230-242); `slices_jpeg_roundtrip_host`
    finishes the chain on the host."""
    slices = _slices_from_hu(raw, slope, intercept, config, intermediate_shape)
    u8 = torch.clamp(torch.floor(slices * 255.0), 0, 255)
    return torch.rot90(u8, k=-1, dims=(1, 2)).to(torch.uint8)


# ---------------------------------------------------------------------------
# The reference chain on the host (the parity oracle)
# ---------------------------------------------------------------------------


def _trilinear_resize_np(vol: np.ndarray, out_shape) -> np.ndarray:
    """align_corners=False trilinear, F.interpolate semantics."""
    in_shape = vol.shape
    out = vol
    for axis in range(3):
        n_in, n_out = in_shape[axis], out_shape[axis]
        if n_in == n_out:
            continue
        coords = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
        lo = np.floor(coords).astype(int)
        frac = coords - lo
        lo0 = np.clip(lo, 0, n_in - 1)
        lo1 = np.clip(lo + 1, 0, n_in - 1)
        a = np.take(out, lo0, axis=axis)
        b = np.take(out, lo1, axis=axis)
        shape = [1, 1, 1]
        shape[axis] = n_out
        frac = frac.reshape(shape)
        out = a * (1 - frac) + b * frac
    return out


def _nearest_resize_np(vol: np.ndarray, out_shape) -> np.ndarray:
    """F.interpolate mode='nearest': src index = floor(dst * n_in / n_out)."""
    out = vol
    for axis in range(3):
        n_in, n_out = out.shape[axis], out_shape[axis]
        if n_in == n_out:
            continue
        idx = np.floor(np.arange(n_out) * n_in / n_out).astype(int)
        out = np.take(out, np.clip(idx, 0, n_in - 1), axis=axis)
    return out


def _area_resize_np(vol: np.ndarray, out_shape) -> np.ndarray:
    """F.interpolate mode='area' (adaptive average pooling), separable per
    axis with floor/ceil window boundaries."""
    out = vol
    for axis in range(3):
        n_in, n_out = out.shape[axis], out_shape[axis]
        if n_in == n_out:
            continue
        starts = np.floor(np.arange(n_out) * n_in / n_out).astype(int)
        ends = np.ceil((np.arange(n_out) + 1) * n_in / n_out).astype(int)
        moved = np.moveaxis(out, axis, 0)
        pooled = np.stack([moved[s:e].mean(axis=0) for s, e in zip(starts, ends)])
        out = np.moveaxis(pooled, 0, axis)
    return out


def reference_preprocess(
    raw: np.ndarray,
    slope: float,
    intercept: float,
    spacing_zyx: Tuple[float, float, float],
    config: PreprocessConfig = PreprocessConfig(),
    final_resize_mode: str = "trilinear",
) -> np.ndarray:
    """The reference chain (two interpolations) in float64 on the host.

    `final_resize_mode`: the reference's final resize is MONAI
    `Resize(spatial_size=[32,256,256], mode="bilinear")`
    (CT-RATE_nii_to_3D_volume_npy_file.py:121-124), which raises on 5-D
    input as pinned; "trilinear" (the default, and what the device paths
    implement) is its natural resolution, "area" and "nearest" the other
    two an author could have landed on."""
    hu = np.clip(slope * raw.astype(np.float64) + intercept,
                 config.hu_min, config.hu_max)
    factors = [spacing_zyx[i] / config.target_spacing[i] for i in range(3)]
    new_shape = [max(1, int(hu.shape[i] * factors[i])) for i in range(3)]
    hu = _trilinear_resize_np(hu, new_shape)
    lo, hi = hu.min(), hu.max()
    vol = (hu - lo) / max(hi - lo, 1e-8)
    mask = vol > 0  # CropForeground(>0)
    box = []
    for axis in range(3):
        axes = tuple(a for a in range(3) if a != axis)
        nz = np.nonzero(mask.any(axis=axes))[0]
        box.append(slice(0, vol.shape[axis]) if len(nz) == 0
                   else slice(int(nz[0]), int(nz[-1]) + 1))
    vol = vol[tuple(box)]
    resize_np = {"trilinear": _trilinear_resize_np, "area": _area_resize_np,
                 "nearest": _nearest_resize_np}
    if final_resize_mode not in resize_np:
        raise ValueError(f"final_resize_mode {final_resize_mode!r} not in "
                         f"{sorted(resize_np)}")
    vol = resize_np[final_resize_mode](vol, config.target_shape)
    return np.clip(vol, 0.0, 1.0)[None].astype(np.float32)


def slices_jpeg_roundtrip_host(
    u8_slices: np.ndarray,  # (n, H, W) uint8 from extract_slices_uint8
    config: PreprocessConfig = PreprocessConfig(),
    jpeg_quality: int = 95,
) -> np.ndarray:
    """Finish the reference's offline 2D chain byte-exactly on the host:
    PIL JPEG quality-95 encode/decode (nii_to_2D_slices.py:242), RGB
    convert + bicubic shorter-side resize + centre crop (the open_clip
    BiomedCLIP preprocess, CT-RATE_2D_to_npy_file.py:74-80), /255, CLIP
    normalize -> (n, S, S, 3) float32. Needs Pillow (imported here, so
    that the rest of the module does not)."""
    import io

    from PIL import Image

    s = config.slice_size
    out = []
    for sl in np.asarray(u8_slices):
        buf = io.BytesIO()
        Image.fromarray(sl).save(buf, format="JPEG", quality=jpeg_quality)
        img = Image.open(io.BytesIO(buf.getvalue())).convert("RGB")
        w, h = img.size
        if w == h:
            nw = nh = s
        elif w < h:
            nw, nh = s, int(round(h * s / w))
        else:
            nw, nh = int(round(w * s / h)), s
        img = img.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - s) // 2, (nh - s) // 2
        img = img.crop((left, top, left + s, top + s))
        out.append(np.asarray(img, np.float32) / 255.0)
    x = np.stack(out)
    mean = np.asarray(_CLIP_MEAN, np.float32)
    std = np.asarray(_CLIP_STD, np.float32)
    return ((x - mean) / std).astype(np.float32)
