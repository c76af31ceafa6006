"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module name; the plain references import nothing of the program;
the harness reads nothing of the repository's older measurement code."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

FOLDER = Path(__file__).resolve().parents[1]
ROOT = FOLDER.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hsenet_tpu"}
# the JAX package's benchmark and smoke scripts, which measured the TPU
OLD_MEASUREMENT = {"bench", "chip_smoke", "scripts"}


def imported_roots(path: Path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_old_measurement():
    for path in FOLDER.rglob("*.py"):
        assert not imported_roots(path) & (FORBIDDEN | OLD_MEASUREMENT), path


def test_the_references_import_nothing_of_the_program():
    for path in (FOLDER / "reference").glob("*.py"):
        assert "hsenet_torch" not in imported_roots(path), path
    code = ("import sys, benchmark.reference.clip, benchmark.reference.vlm, "
            "benchmark.check; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert "hsenet_torch" not in json.loads(out.replace("'", '"'))


@pytest.mark.parametrize("name", ["clip-s1-b24", "vlm-ft-vqa-int8-b24"])
def test_a_run_loads_no_jax(name):
    code = (
        "import sys, json\n"
        "from benchmark.harness import run\n"
        "from benchmark.tests.toy import toy_cell\n"
        f"r = run({name!r}, 5, 0.1, True, device='cpu', cell=toy_cell({name!r}))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    roots = set(json.loads(out.strip().splitlines()[-1]))
    assert "hsenet_torch" in roots
    assert not roots & FORBIDDEN


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result and a failing exit code."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(FOLDER, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "clip-s1-b24",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
