"""Build the port's CUDA sources into plain-C shared libraries.

`load(name)` compiles `csrc/<name>.cu` with `nvcc` for `sm_90a` into
`_build/lib<name>-<hash>.so` and opens it with ctypes. The hash covers that
source, the shared headers (`csrc/*.cuh`) and the compiler flags, so an
edited source builds anew and an unchanged one is reused. Nothing is built
at import: the first call that launches a kernel builds its library.
`load_all(names)` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc's output (ptxas register and spill lines) of each source built here
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use"
        )
    return path


def _compile(name: str) -> Path:
    """The library of `csrc/<name>.cu`, compiled unless already built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    BUILD_LOGS[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _LIBS[name] = lib
        return lib


def load_all(names: Sequence[str]) -> None:
    """Build and open several sources, one nvcc each, all started at once."""
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_compile, names)))
    with _LOCK:
        for name, path in paths.items():
            _LIBS.setdefault(name, ctypes.CDLL(str(path)))
