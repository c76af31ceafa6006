"""CT preprocessing entry point: NIfTI -> preprocessed .npy + manifest (the
port of the JAX package's cli/preprocess_ct.py).

Counterpart of the reference's four offline scripts
(`Data/data_processing/CT-RATE/*.py`, `BIMCV_R/*.py`): one pass per volume
writes the (1, 32, 256, 256) volume npy and, with `--slices`, the
(32, 224, 224, 3) CLIP-ready slices, or with `--vit2d-checkpoint` the
(32, 768) BiomedCLIP slice features the 2E3 tower and the VLM read. The
volume work runs on the card (`data.preprocess`); the NIfTI decode runs on
the host (`data.nifti`, the native decoder where it builds).

    python -m hsenet_torch.cli.preprocess_ct --input-dir /data/nii \\
        --output-dir /data/npy --metadata metadata.csv
    # with slice features from a converted trunk
    python -m hsenet_torch.cli.convert_checkpoint --kind biomedclip \\
        --input open_clip_pytorch_model.bin --output vit2d.pt
    python -m hsenet_torch.cli.preprocess_ct --input-dir /data/nii \\
        --output-dir /data/npy --vit2d-checkpoint vit2d.pt
    # on a host without a card
    python -c "from hsenet_torch.cli.preprocess_ct import main; \\
        main(['--input-dir', 'nii', '--output-dir', 'npy'], device='cpu')"
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from hsenet_torch.configs import PreprocessConfig, ViT2DConfig
from hsenet_torch.data.nifti import read_nifti
from hsenet_torch.data.preprocess import (
    extract_slices,
    extract_slices_uint8,
    preprocess_volume,
    preprocess_volume_faithful,
    slices_jpeg_roundtrip_host,
    spacing_resample_shape,
)


def load_metadata(path: Optional[str]):
    """CSV with VolumeName, RescaleSlope, RescaleIntercept (CT-RATE format,
    nii_to_3D:60-64). Returns name -> (slope, intercept)."""
    if not path:
        return {}
    import csv

    out = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            out[row["VolumeName"]] = (
                float(row.get("RescaleSlope", 1.0)),
                float(row.get("RescaleIntercept", 0.0)),
            )
    return out


def find_nii_files(root: str):
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith((".nii", ".nii.gz")):
                yield os.path.join(dirpath, name)


def load_vit2d(path: str, device):
    """A `ViT2D(ViT2DConfig())` computing in bf16 with the `save_params`
    file at `path` (from `convert_checkpoint --kind biomedclip`), in eval
    mode."""
    from hsenet_torch.models.vit import ViT2D
    from hsenet_torch.utils.checkpoint import restore_params

    model = ViT2D(ViT2DConfig(), dtype=torch.bfloat16, device=device)
    model.load_state_dict(restore_params(path, model.state_dict()), strict=True)
    return model.eval()


def main(argv=None, *, device="cuda"):
    """Preprocess every NIfTI under --input-dir as `argv` says; returns the
    manifest written. Runs on the CUDA card unless the caller passes
    `device="cpu"`."""
    from hsenet_torch import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--metadata", default="", help="CT-RATE metadata CSV")
    p.add_argument("--slices", action="store_true",
                   help="also emit CLIP-ready slice tensors")
    p.add_argument("--vit2d-checkpoint", default="",
                   help="BiomedCLIP 2D trunk params: emit (32,768) features")
    p.add_argument("--manifest", default="dataset_manifest.json")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument(
        "--faithful", action="store_true",
        help="reference-exact chains for checkpoint-parity evals: volumes "
        "use the two-interpolation spacing-resample+crop+resize, slices "
        "add the reference's per-slice uint8 quantization + -90deg "
        "rotation + BICUBIC 224 (CT-RATE_nii_to_2D_slices.py:230-242); "
        "default is the fused fast path",
    )
    p.add_argument(
        "--slice-jpeg-roundtrip", action="store_true",
        help="byte-exact offline slice chain: the device computes the "
        "rotated uint8 slices, host PIL does the JPEG(q95) encode/decode + "
        "BICUBIC resize exactly like the reference scripts (implies the "
        "faithful slice path; needs Pillow)",
    )
    args = p.parse_args(argv)
    device = resolve_device(device)

    os.makedirs(args.output_dir, exist_ok=True)
    meta = load_metadata(args.metadata)
    cfg = PreprocessConfig()
    vit2d = load_vit2d(args.vit2d_checkpoint, device) if args.vit2d_checkpoint else None

    entries = []
    n = 0
    t0 = time.perf_counter()
    for path in find_nii_files(args.input_dir):
        name = os.path.basename(path)
        slope, intercept = meta.get(name, (1.0, 0.0))
        vol = read_nifti(path)
        raw = torch.as_tensor(vol.zyx_data.astype(np.float32), device=device)
        # the CSV's rescale on top of the header's
        s = vol.scl_slope * slope
        i = vol.scl_slope * intercept + vol.scl_inter
        inter = spacing_resample_shape(raw.shape, vol.zyx_spacing, cfg)
        if args.faithful:
            out = preprocess_volume_faithful(raw, s, i, inter, cfg)
        else:
            out = preprocess_volume(raw, s, i, cfg)
        stem = name.replace(".nii.gz", "").replace(".nii", "")
        vol_path = f"{stem}_3D_features.npy"
        np.save(os.path.join(args.output_dir, vol_path), out.cpu().numpy())
        entry = {"image": vol_path}

        if args.slices or vit2d is not None:
            if args.slice_jpeg_roundtrip:
                u8 = extract_slices_uint8(raw, s, i, cfg, intermediate_shape=inter)
                sl = torch.as_tensor(slices_jpeg_roundtrip_host(
                    u8.cpu().numpy(), cfg), device=device)
            elif args.faithful:
                sl = extract_slices(raw, s, i, cfg, intermediate_shape=inter,
                                    faithful=True)
            else:
                sl = extract_slices(raw, s, i, cfg)
            if vit2d is not None:
                with torch.inference_mode():
                    feats = vit2d(sl)
                feat_path = f"{stem}_biomedclip_features.npy"
                np.save(os.path.join(args.output_dir, feat_path),
                        feats.float().cpu().numpy())
                entry["biomedclip_features"] = feat_path
            else:
                sl_path = f"{stem}_slices.npy"
                np.save(os.path.join(args.output_dir, sl_path), sl.cpu().numpy())
                entry["slices"] = sl_path

        entries.append(entry)
        n += 1
        if n % 20 == 0:
            rate = n / (time.perf_counter() - t0)
            print(f"{n} volumes ({rate:.2f} vol/s)", flush=True)
        if args.limit and n >= args.limit:
            break

    manifest = {"train": entries, "validation": entries[:512]}
    manifest_path = os.path.join(args.output_dir, args.manifest)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"wrote {n} volumes + {manifest_path}")
    return manifest


if __name__ == "__main__":
    main()
