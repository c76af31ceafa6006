"""The port's package data covers every source file it compiles at first use.

An installed port builds its CUDA kernels from `hsenet_torch/csrc/` with nvcc
(`ops/_build.py`: each `<name>.cu`, hashed with every `csrc/*.cuh`) and its
NIfTI decoder from `native/nifti_native.cc` with g++ (`native/__init__.py`).
A file the package-data globs of `pyproject.toml` miss is left out of a wheel,
and the build fails outside the source tree. The globs are read from the
file and matched against the files the build reads; no wheel is built.
"""

import fnmatch
import re
import tomllib
from pathlib import Path

import hsenet_torch
from hsenet_torch import native
from hsenet_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(hsenet_torch.__file__).resolve().parent


def _shipped(path: Path) -> bool:
    """Whether a package-data glob of `hsenet_torch` matches `path`."""
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    rel = path.resolve().relative_to(PACKAGE).as_posix()
    return any(fnmatch.fnmatchcase(rel, g) for g in data.get("hsenet_torch", []))


def _compiled_files():
    """Every file the port's two builds read: the kernel sources, the
    headers they include and `_build.py` hashes, and the NIfTI decoder."""
    sources = sorted(_build.CSRC.glob("*.cu"))
    headers = set(_build.CSRC.glob("*.cuh"))
    for src in sources:
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            headers.add(_build.CSRC / name)
    return [*sources, *sorted(headers), native.SRC]


def test_every_compiled_source_is_package_data():
    files = _compiled_files()
    assert any(f.suffix == ".cuh" for f in files) and native.SRC in files
    missing = [f.relative_to(PACKAGE).as_posix() for f in files if not _shipped(f)]
    assert not missing, f"left out of the package data: {missing}"


def test_included_headers_exist_in_the_source_tree():
    for f in _compiled_files():
        assert f.is_file(), f
