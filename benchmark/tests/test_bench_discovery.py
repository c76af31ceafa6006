"""The harness finds a configuration, a traffic mix, a cell's limits and a
per-layer metric by their names alone: files added beside the benchmark's
own, and entries added to BENCHMARK.json, with no edit to any file that is
there."""

import json
import shutil
from pathlib import Path

from benchmark.harness import find_cell, metric_reader, run
from benchmark.tests.toy import toy_cell

ROOT = Path(__file__).resolve().parents[2]


def checkout_copy(tmp: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files under `tmp`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "workloads", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, tmp / "benchmark" / sub)
    return tmp


def test_added_files_are_found_by_name(tmp_path):
    root = checkout_copy(tmp_path)
    toy = toy_cell("clip-s1-b24")
    folder = root / "benchmark"
    (folder / "configs" / "toy-clip.json").write_text(json.dumps(toy.config))
    (folder / "workloads" / "toy-contrastive.json").write_text(json.dumps(toy.traffic))
    (folder / "limits" / "toy-cell.json").write_text(json.dumps(toy.limits))
    (folder / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-clip", "source": "a test",
                             "file": "benchmark/configs/toy-clip.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-clip",
                               "traffic": "toy-contrastive", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer and train steps",
                               "moves": "train_samples_per_s",
                               "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell("toy-cell", root)
    assert cell.config == toy.config and cell.traffic == toy.traffic
    assert cell.limits == toy.limits
    assert [m["name"] for m in cell.per_layer][-1] == "steps_seen.train"
    assert metric_reader("steps_seen.train", root)(type("C", (), {"steps": 3})) == 3.0
    result = run("toy-cell", 8, 0.1, True, device="cpu", cell=cell)
    assert result["metrics"]["steps_seen.train"]["value"] >= 1
    others = find_cell("clip-s1-b24", root).per_layer
    assert "steps_seen.train" not in [m["name"] for m in others]


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        find_cell(w["name"])
    for m in bench["per_layer"]:
        assert callable(metric_reader(m["name"]))
