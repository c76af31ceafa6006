"""Minimal NIfTI-1 reader and writer (host side, numpy only; the port of the
JAX package's data/nifti.py).

A from-scratch parser of the 348-byte NIfTI-1 header and the raw or gzip
data section (nibabel is not a dependency): the eight datatypes of
`_DTYPES`, either byte order, scl_slope/inter (a slope of 0 or NaN reads
as 1, a NaN intercept as 0), pixdim spacing, optional `.gz`. It returns
the stored array; HU conversion and geometry are `data.preprocess`'s.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


@dataclass
class NiftiVolume:
    data: np.ndarray  # as stored (i, j, k) fastest-first -> shape (nx, ny, nz)
    spacing: Tuple[float, float, float]  # (dx, dy, dz) in mm
    scl_slope: float
    scl_inter: float

    @property
    def zyx_data(self) -> np.ndarray:
        """(nz, ny, nx): the z-leading layout the pipeline consumes."""
        return np.ascontiguousarray(self.data.transpose(2, 1, 0))

    @property
    def zyx_spacing(self) -> Tuple[float, float, float]:
        dx, dy, dz = self.spacing
        return (dz, dy, dx)


def read_nifti(path: str, native: str = "auto") -> NiftiVolume:
    """Parse one NIfTI-1 volume.

    native: 'auto' uses the C++ decoder (`hsenet_torch.native`) where it
    builds (one fused inflate + convert pass, float32 out) and this
    pure-Python parser where it does not; 'never' forces Python; 'require'
    raises if the native library is unavailable.
    """
    if native not in ("auto", "never", "require"):
        raise ValueError(f"native must be 'auto', 'never' or 'require', got {native!r}")
    if native != "never":
        from hsenet_torch import native as native_mod

        if native_mod.available():
            data, spacing_zyx, slope, inter = native_mod.decode(path)
            # stored (nx, ny, nz) like the Python path: a view of the zyx
            # buffer, whose zyx_data is the contiguous buffer again
            return NiftiVolume(
                data=data.transpose(2, 1, 0),
                spacing=(spacing_zyx[2], spacing_zyx[1], spacing_zyx[0]),
                scl_slope=slope,
                scl_inter=inter,
            )
        if native == "require":
            raise RuntimeError(
                f"native nifti decoder unavailable: {native_mod.load_error}")

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        if struct.unpack("<i", header[:4])[0] == 348:
            end = "<"
        elif struct.unpack(">i", header[:4])[0] == 348:
            end = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        magic = header[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        dim = struct.unpack(end + "8h", header[40:56])
        shape = tuple(int(d) for d in dim[1:1 + max(dim[0], 3)][:3])
        datatype = struct.unpack(end + "h", header[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported datatype {datatype}")
        np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(end)
        pixdim = struct.unpack(end + "8f", header[76:108])
        vox_offset = int(struct.unpack(end + "f", header[108:112])[0])
        scl_slope = struct.unpack(end + "f", header[112:116])[0]
        scl_inter = struct.unpack(end + "f", header[116:120])[0]
        if scl_slope == 0 or not np.isfinite(scl_slope):
            scl_slope = 1.0
        if not np.isfinite(scl_inter):
            scl_inter = 0.0

        f.seek(vox_offset)
        count = int(np.prod(shape))
        raw = f.read(count * np_dtype.itemsize)
        if len(raw) < count * np_dtype.itemsize:
            raise ValueError(f"{path}: truncated data section")
        # NIfTI stores x fastest: Fortran order gives (nx, ny, nz)
        data = np.frombuffer(raw, dtype=np_dtype, count=count).reshape(
            shape, order="F")

    return NiftiVolume(
        data=data,
        spacing=(float(pixdim[1]), float(pixdim[2]), float(pixdim[3])),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
    )


def write_nifti(path: str, data: np.ndarray, spacing=(1.0, 1.0, 1.0),
                scl_slope: float = 1.0, scl_inter: float = 0.0,
                compresslevel: int = 9) -> None:
    """Tiny little-endian NIfTI-1 writer (tests and synthetic data); data
    is (nx, ny, nz). `compresslevel` applies to a `.gz` path."""
    dtype_code = {np.dtype(v): k for k, v in _DTYPES.items()}[np.dtype(data.dtype)]
    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, *[3, *data.shape, 1, 1, 1, 1][:8])
    struct.pack_into("<h", header, 70, dtype_code)
    struct.pack_into("<h", header, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", header, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     0, 0, 0, 0)
    struct.pack_into("<f", header, 108, 352.0)
    struct.pack_into("<f", header, 112, scl_slope)
    struct.pack_into("<f", header, 116, scl_inter)
    header[344:348] = b"n+1\x00"
    if str(path).endswith(".gz"):
        f = gzip.open(path, "wb", compresslevel=compresslevel)
    else:
        f = open(path, "wb")
    with f:
        f.write(bytes(header))
        f.write(b"\x00" * 4)  # pad to vox_offset 352
        f.write(np.asfortranarray(data).tobytes(order="F"))
