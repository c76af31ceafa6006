"""One run of one cell: set-up, the checked first steps, the measured
window, an optional trace, the reference's check, the result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program and its feed from the seed, then drives the
first `CHECK_STEPS` steps through the window's own call and feed (they
also warm every shape the window uses), keeping the program's readings of
them. They run with the model's dropout rates at 0, as the reference
does; a model with dropout then takes one more step with its rates
restored, as the window runs them. The window then runs whole steps for `--seconds` of host time and
closes on a synchronise: the rate is every sample of every step over the
whole time. With `--trace 1` a few more steps follow under the profiler,
between two synchronisations, and the per-layer metrics are read; without,
the end-to-end metrics. After the window the program is freed and the
plain reference runs the checked steps again from the same weights and
batches; the comparison decides `correct`.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOLDER = HERE.name  # the benchmark's folder under the checkout's root
CHECK_STEPS = 3
# modules that may not be loaded in a run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "hsenet_tpu")


class RunError(RuntimeError):
    """A run that may not print a result."""


def process_start_time() -> float:
    """This process's start, on the clock of `time.time()`."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_layer: List[dict]
    end_to_end: List[dict]
    root: Path = ROOT


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`: its configuration file, and
    its traffic and limits found by name under `root/benchmark/`."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    folder = root / FOLDER
    return Cell(name, cell["chips"], load_json(root / config["file"]),
                load_json(folder / "workloads" / f"{cell['traffic']}.json"),
                load_json(folder / "limits" / f"{name}.json"), per_layer,
                end_to_end, root)


def metric_reader(name: str, root: Path = ROOT):
    """`read(ctx)` of `benchmark/metrics/<name>.py` under `root`."""
    path = root / FOLDER / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Context:
    """What the per-layer readers read: the window's steps and, in a traced
    run, the traced steps' summary (`trace.TraceSummary`)."""

    window_s: float
    steps: int
    waits_s: List[float] = field(default_factory=list)
    step_ms: List[float] = field(default_factory=list)
    flops: List[float] = field(default_factory=list)
    trace: object = None
    attention_bound_ms: Optional[float] = None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite_or_none(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def build(cell: Cell, seed: int, device, fault=None):
    """(program, feed) of a run: the pool of samples, the program's model,
    optimizer and step, and its feed, all from the seed."""
    from benchmark import traffic as traffic_gen
    from benchmark.program import Feed, Program

    family = importlib.import_module(f"benchmark.families.{cell.config['family']}")
    samples = traffic_gen.samples(cell.config, cell.traffic, seed, device)
    program = Program(family, cell.config, cell.traffic, seed, device, fault)
    return program, Feed(samples, cell.traffic["batch"], seed, device,
                         keep=CHECK_STEPS)


def checked_steps(program, feed):
    """The program's readings (`check.Readings`) of its first `CHECK_STEPS`
    steps, driven through the window's own call and feed with the model's
    dropout rates at 0."""
    from benchmark import check

    start = {n: p.detach().clone() for n, p in program.trainable().items()}
    losses, first_grad = [], {}
    with program.dropout_off():
        for i in range(CHECK_STEPS):
            losses.append(program.step(next(feed))["loss"])
            if i == 0:
                first_grad = program.first_grad_norms()
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in program.trainable().items()}
    return check.Readings([float(x) for x in losses], first_grad, change)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: Optional[str] = None, cell: Optional[Cell] = None,
        fault: Optional[str] = None) -> dict:
    """The result of one run (see the module docstring). `cell` replaces the
    one `BENCHMARK.json` names (the tests' toy cells), `device` the card,
    `fault` plants a fault in the program (`program.FAULTS`)."""
    started = process_start_time()
    cell = cell or find_cell(workload)
    import torch

    from benchmark import check, roofline
    from benchmark.trace import SPAN, reduce

    cuda = device is None
    if cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} CUDA device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    config, traffic = cell.config, cell.traffic
    reference = importlib.import_module(f"benchmark.reference.{config['family']}")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- set-up: the program, its feed, the checked first steps
    program, feed = build(cell, seed, device, fault)
    mine = checked_steps(program, feed)
    first = CHECK_STEPS  # the steps before the window
    if program.has_dropout:  # its masks' kernels warmed as the window runs them
        program.step(next(feed))
        first += 1
    gc.collect()
    sync()

    # ---- the window; the objects of set-up are kept out of the
    # collector's full passes
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - started
    marks, waits, window_losses = [], [], []
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        batch = next(feed)
        waits.append(time.perf_counter() - t)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        window_losses.append(program.step(batch)["loss"])
        if time.perf_counter() - t_start >= seconds:
            break
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    sync()
    window_s = time.perf_counter() - t_start
    steps = len(window_losses)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    flops = [reference.step_flops(config, traffic, feed.info[first + i])
             for i in range(steps)]

    # ---- the traced steps
    summary, bound_ms, traced, launches = None, None, 0, {}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from hsenet_torch.data.prefetch import PRODUCER_NAME

        traced = traffic["trace_steps"]
        loader = {t.native_id for t in threading.enumerate()
                  if t.name == PRODUCER_NAME}
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync()
        port_launches(reset=True)
        with profile(activities=activities) as prof:
            with record_function(SPAN):
                for _ in range(traced):
                    window_losses.append(program.step(next(feed))["loss"])
                sync()
        launches = port_launches()
        summary = reduce(prof, traced, skip_threads=loader)
        del prof
        at = first + steps
        bound_ms = sum(roofline.calls_bound_ms(reference.attention_launches(
            config, traffic, feed.info[at + i])) for i in range(traced))
    gc.unfreeze()
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    feed.close()
    kept = feed.kept
    program.close()
    del program, feed, batch, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the metrics
    samples_per_step = traffic["batch"]
    if trace:
        ctx = Context(window_s, steps, waits, step_ms, flops, summary, bound_ms)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"train_samples_per_s": steps * samples_per_step / window_s,
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    # ---- the check
    t_ref = time.perf_counter()
    theirs = reference.train_readings(config, traffic, seed, kept, device)
    reference_s = time.perf_counter() - t_ref
    correct, checks = check.verdict(check.numbers(mine, theirs), cell.limits)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules that may not be loaded were loaded: {found}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": bool(correct), "attempted": steps + traced,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = {n: {"value": finite_or_none(c["value"]), "limit": c["limit"]}
                        for n, c in checks.items()}
    result["_launches"] = {k: v / traced for k, v in launches.items()}
    result["_reference_s"] = reference_s
    return result


def port_launches(reset: bool = False) -> Dict[str, int]:
    """The port's own count of flash launches by (kind, batch, heads, sq,
    skv, head dim) since its last reset, a cross-check of the attention
    work that the roofline counts; `reset` starts the count anew."""
    from hsenet_torch.ops import flash_attention

    if reset:
        flash_attention.reset_launch_counts()
    return {" ".join(map(str, k)): v for k, v in flash_attention.shape_launches.items()}


def emit(result: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    launches = result.pop("_launches", {})
    print(f"reference: {result.pop('_reference_s'):.1f} s", file=sys.stderr)
    if launches:
        print("port flash launches a traced step by (kind, batch, heads, sq, "
              "skv, d): " + json.dumps(launches), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
