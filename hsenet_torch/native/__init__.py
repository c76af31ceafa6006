"""The port's native NIfTI decoder (`nifti_native.cc`), loaded with ctypes.

`nifti_native.cc` fuses zlib inflate, header parse, dtype conversion and
scl scaling into one pass per volume, and decodes batches on a std::thread
pool. `data.nifti.read_nifti` uses it where it builds and falls back to its
pure-Python parser where it does not (`native="auto"`).

The library is compiled with the system g++ at first use into
`hsenet_torch/_build/libnifti-<hash>.so`, keyed by a hash of the source and
the flags. The compiler writes a file of its own (named after the process)
that `os.replace` then moves into place, under an exclusive `flock` on
`_build/libnifti.lock`: processes that start at once (test workers) wait
for the first build and load its library; none sees half a file or takes a
lost race for a failed build.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "nifti_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# why the library is unavailable in this process (None: not tried yet or
# loaded); a failed build is not retried
load_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lands."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libnifti-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library, compiled unless already built; raises if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libnifti.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SRC} (rc {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and open the library; None if that failed (the
    reason is in `load_error`)."""
    global _lib, load_error
    with _lock:
        if _lib is not None or load_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            load_error = str(e)
            return None
        lib.nifti_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.nifti_probe.restype = ctypes.c_int
        lib.nifti_decode_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.nifti_decode_f32.restype = ctypes.c_int
        lib.nifti_decode_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.nifti_decode_batch_f32.restype = ctypes.c_int
        lib.nifti_errstr.argtypes = [ctypes.c_int]
        lib.nifti_errstr.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native nifti library unavailable: {load_error}")
    return lib


def _check(lib, rc: int, path: str) -> None:
    if rc != 0:
        raise ValueError(f"{path}: {lib.nifti_errstr(rc).decode()} (native rc={rc})")


def probe(path: str):
    """-> (zyx_shape, zyx_spacing, scl_slope, scl_inter)."""
    lib = _require()
    shape = (ctypes.c_int64 * 3)()
    spacing = (ctypes.c_float * 3)()
    slope, inter = ctypes.c_float(), ctypes.c_float()
    _check(lib, lib.nifti_probe(str(path).encode(), shape, spacing, slope, inter),
           path)
    return (tuple(int(s) for s in shape), tuple(float(s) for s in spacing),
            float(slope.value), float(inter.value))


def decode(path: str, apply_scl: bool = False):
    """One volume -> (float32 (nz, ny, nx) array, zyx_spacing, slope,
    inter). With apply_scl the slope and intercept are folded in and
    reported back as (1, 0)."""
    lib = _require()
    shape, spacing, slope, inter = probe(path)
    out = np.empty(shape, np.float32)
    rc = lib.nifti_decode_f32(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size, int(apply_scl),
    )
    _check(lib, rc, path)
    if apply_scl:
        slope, inter = 1.0, 0.0
    return out, spacing, slope, inter


def decode_batch(paths: List[str], shape: Tuple[int, int, int],
                 apply_scl: bool = False,
                 num_threads: Optional[int] = None) -> np.ndarray:
    """Thread-pool decode of same-shape volumes -> (N, nz, ny, nx) f32."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, *shape), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.nifti_decode_batch_f32(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(np.prod(shape)), int(apply_scl),
        num_threads or min(n, os.cpu_count() or 1),
    )
    _check(lib, rc, paths[0] if paths else "<empty>")
    return out
