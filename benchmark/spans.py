"""The program's spans (`hsenet_torch.utils.profiling.span`) in a traced run:
device time, launches and idle put down to the train step's phases and
modules, and what the span metrics in `metrics/` read.

Two kinds of steps are read. **Profiled steps** run under the profiler
with spans on (no events); their kernels are attributed to spans from the
trace. **Span steps** follow them with spans on and CUDA events recorded at
each span's edges, without the profiler, so their times are the untraced
step's.

A kernel belongs to a span by these rules, in order:

  1. the innermost program span among the ancestors of the host operation
     that launched it;
  2. launched on the autograd engine's thread (one that runs backward
     nodes, other than the training thread) with no span among its
     ancestors: the span of the forward operation its backward node came
     from, found by the node's `sequence_nr` under its `fwd_thread`, else
     under the training thread;
  3. failing that, on the engine's thread, `train.backward` where the
     launch falls inside one of the training thread's `train.backward`
     spans;
  4. anything left, and kernels linked to no host operation, are
     "outside".

The profiler gives each kernel to every host event whose id is the id of
the operation that launched it; a CUDA runtime call made outside any
operation (a stream's wait for the prefetcher's copy, a synchronise) may
carry the same number from another counter, so runtime calls hold no
kernel here. A span's busy time is the summed duration of its device
activities: they run in order on the step's one stream. The kernel total, copies and fills
left out, is `trace.reduce`'s, so attributed plus outside equals it.

    python -m benchmark.spans --workload clip-s1-b24 --seed 7 --seconds 10

runs a cell's set-up, a window of `--seconds` with spans off, the cell's
traced steps under the profiler with spans on, `--span-steps` span steps
(the cell's `trace_steps` by default), then as many steps with spans off
and with spans on, in turns; it prints the attribution on standard error
and, as the last line of standard output, the per-layer metrics of the
cell with the span metrics and the steps' times in turns (the spans'
cost: the median of each pair's ratio). It draws no
reference and decides no `correct`.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import statistics
import sys
import threading
from collections import Counter
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.trace import COPY_PREFIXES, SPAN, TOP, union

# every span the program opens (`hsenet_torch`'s `span` calls)
SPANS = ("data.wait", "train.step", "train.forward", "train.backward",
         "train.optimizer", "model.vision", "model.text", "model.projector",
         "model.llm", "model.head_loss")
# the spans whose kernel time the module table splits
MODULES = ("model.vision", "model.text", "model.projector", "model.llm",
           "model.head_loss")
OUTSIDE = "outside"
BACKWARD_NODE = "autograd::engine::evaluate_function:"
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")  # cudaStreamWaitEvent, cuLaunchKernelEx


@dataclass
class SpanSummary:
    """Per span over the profiled steps: kernel microseconds, launches,
    busy microseconds; the outside remainder and the kernel total; idle
    seconds by the innermost span open at each gap; how many kernels each
    rule placed; the kernel names launched more (or fewer) times by the
    trace's host operations than the trace holds, with an operation that
    launched one. From the span steps: each step's event time (from its
    `train.step` start to the next one's, the last to its end), each
    step's `train.optimizer` event time, and the host milliseconds a step
    in `data.wait`."""

    steps: int
    kernel_us: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    busy_us: Dict[str, float] = field(default_factory=dict)
    kernel_total_us: float = 0.0
    launches_total: int = 0
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    rules: Dict[str, int] = field(default_factory=dict)
    unmatched: List[Tuple[str, int, str]] = field(default_factory=list)
    span_steps: int = 0
    step_event_ms: List[float] = field(default_factory=list)
    optimizer_event_ms: List[float] = field(default_factory=list)
    wait_host_ms: Optional[float] = None

    def kernel_ms_per_step(self, name: str) -> Optional[float]:
        """Device milliseconds a profiled step of the kernels attributed
        to `name`; None where it has none."""
        if not self.launches.get(name) or not self.steps:
            return None
        return self.kernel_us[name] / 1e3 / self.steps


def _is_span(e) -> bool:
    return e.name in SPANS


def _ancestors(e) -> Iterable:
    while e is not None:
        yield e
        e = e.cpu_parent


def _innermost_span(e) -> Optional[str]:
    return next((a.name for a in _ancestors(e) if _is_span(a)), None)


def attribute(prof, steps: int) -> SpanSummary:
    """The attribution (module docstring) of a profile of `steps` steps
    whose host span `trace.SPAN` covers them."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    window = next(e for e in cpu if e.name == SPAN)
    t0, t1 = window.time_range.start, window.time_range.end
    steps_open = [e for e in cpu if e.name == "train.step"]
    main = steps_open[0].thread if steps_open else window.thread
    engine = {e.thread for e in cpu if e.name.startswith(BACKWARD_NODE)} - {main}
    # forward operations by sequence number, the last to open of each: the
    # one that made the autograd node
    forward: Dict[Tuple[int, int], object] = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD_NODE):
            key = (e.thread, e.sequence_nr)
            if key not in forward or forward[key].time_range.start <= e.time_range.start:
                forward[key] = e
    backward = union((e.time_range.start, e.time_range.end) for e in cpu
                     if e.name == "train.backward" and e.thread == main)
    back_starts = [iv[0] for iv in backward]

    def place(e) -> Tuple[str, str]:
        name = _innermost_span(e)
        if name is not None:
            return name, "ancestor"
        if e.thread not in engine:
            return OUTSIDE, "outside"
        node = next((a for a in _ancestors(e) if a.name.startswith(BACKWARD_NODE)), None)
        if node is not None and node.sequence_nr >= 0:
            for key, rule in (((node.fwd_thread, node.sequence_nr), "sequence"),
                              ((main, node.sequence_nr), "sequence_main")):
                op = forward.get(key)
                name = _innermost_span(op) if op is not None else None
                if name is not None:
                    return name, rule
        i = bisect.bisect_right(back_starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= backward[i][1]:
            return "train.backward", "interval"
        return OUTSIDE, "outside"

    s = SpanSummary(steps=steps)
    linked: Counter = Counter()
    owner: Dict[str, str] = {}
    for e in cpu:
        if RUNTIME_CALL.match(e.name):
            continue
        kernels = [k for k in e.kernels if k.name not in SPANS and k.name != SPAN]
        if not kernels:
            continue
        name, rule = place(e)
        for k in kernels:
            s.busy_us[name] = s.busy_us.get(name, 0.0) + k.duration
            if k.name.startswith(COPY_PREFIXES):
                continue
            s.kernel_us[name] = s.kernel_us.get(name, 0.0) + k.duration
            s.launches[name] = s.launches.get(name, 0) + 1
            s.rules[rule] = s.rules.get(rule, 0) + 1
            linked[k.name] += 1
            owner[k.name] = f"{e.name} under {name}"
    device = _device(events)
    traced: Counter = Counter()
    for e in device:
        if not e.name.startswith(COPY_PREFIXES):
            s.kernel_total_us += e.time_range.end - e.time_range.start
            s.launches_total += 1
            traced[e.name] += 1
    diff = [(n, linked[n] - traced[n], owner.get(n, "")) for n in linked | traced
            if linked[n] != traced[n]]
    s.unmatched = sorted(diff, key=lambda d: -abs(d[1]))[:TOP]
    # what no span holds: the outside kernels and those linked to no op
    s.kernel_us[OUTSIDE] = s.kernel_total_us - sum(
        v for k, v in s.kernel_us.items() if k != OUTSIDE)
    s.launches[OUTSIDE] = s.launches_total - sum(
        v for k, v in s.launches.items() if k != OUTSIDE)
    s.idle_gaps = _gaps_by_span(device, [e for e in cpu if _is_span(e)], t0, t1)
    return s


def _device(events) -> list:
    """The device activities: kernels, copies and fills, without the
    ranges the profiler draws for host annotations on the device."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and e.name not in SPANS and e.name != SPAN]


def _gaps_by_span(device, spans, t0: float, t1: float) -> List[Tuple[str, float]]:
    """Idle seconds inside [t0, t1] by the innermost span (the latest to
    open) running at each gap's middle ("none" where none was)."""
    busy = union((max(e.time_range.start, t0), min(e.time_range.end, t1))
                 for e in device if min(e.time_range.end, t1) > max(e.time_range.start, t0))
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    by: Dict[str, float] = {}
    for i in range(0, len(edges), 2):
        start, end = edges[i], edges[i + 1]
        if end <= start:
            continue
        mid = (start + end) / 2
        around = [e for e in spans if e.time_range.start <= mid <= e.time_range.end]
        label = max(around, key=lambda e: e.time_range.start).name if around else "none"
        by[label] = by.get(label, 0.0) + (end - start) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])


def without_spans(prof):
    """`prof` whose events leave the program's spans out, for
    `trace.reduce`: its idle gaps are then labelled by operations, as in a
    run without spans."""
    events = [e for e in prof.events() if not _is_span(e)]
    return SimpleNamespace(events=lambda: events)


def read_span_steps(summary: SpanSummary, records) -> SpanSummary:
    """`summary` with the span steps' times from their records
    (`profiling.collect()` after `spans_on(events=True)`)."""
    main = [r for r in records if r.name == "train.step"]
    if not main:
        return summary
    thread = main[0].thread
    starts = [r for r in main if r.thread == thread]
    for r, nxt in zip(starts, starts[1:] + [None]):
        r.end_event.synchronize()
        end = nxt.start_event if nxt is not None else r.end_event
        summary.step_event_ms.append(r.start_event.elapsed_time(end))
    summary.optimizer_event_ms = [r.device_ms() for r in records
                                  if r.name == "train.optimizer"]
    summary.span_steps = len(starts)
    waits = sum(r.host_ms() for r in records if r.name == "data.wait")
    summary.wait_host_ms = waits / len(starts)
    return summary


def table(s: SpanSummary) -> str:
    """Kernel ms and launches a profiled step by span, the outside
    remainder, the share the modules and the optimizer cover, and the idle
    gaps by innermost span."""
    n = max(s.steps, 1)
    lines = [f"spans over {s.steps} profiled step(s): kernel ms, launches, busy ms "
             f"a step (kernel total {s.kernel_total_us / 1e3 / n:.3f} ms, "
             f"{s.launches_total / n:.0f} launches)"]
    for name in sorted(s.kernel_us, key=lambda k: -s.kernel_us[k]):
        lines.append(f"  {name:<18} {s.kernel_us[name] / 1e3 / n:10.3f} "
                     f"{s.launches.get(name, 0) / n:9.1f} "
                     f"{s.busy_us.get(name, 0.0) / 1e3 / n:10.3f}")
    lines.append(f"  modules and optimizer cover {coverage_pct(s):.2f}% of kernel time; "
                 f"rules {json.dumps(s.rules)}")
    lines.append("  idle ms a step by innermost span: " + ", ".join(
        f"{k} {v * 1e3 / n:.3f}" for k, v in s.idle_gaps))
    for name, count, op in s.unmatched:
        lines.append(f"  launched {count:+d} times against the trace: {name[:80]} ({op})")
    return "\n".join(lines)


def coverage_pct(s: SpanSummary) -> float:
    """The share of the kernel total attributed to a module span or to
    `train.optimizer`."""
    covered = sum(s.kernel_us.get(k, 0.0) for k in MODULES + ("train.optimizer",))
    return 100.0 * covered / s.kernel_total_us if s.kernel_total_us else 0.0


# ---- the metrics' arithmetic (`metrics/<name>.py` read through these)

def module_ms(ctx, name: str) -> Optional[float]:
    s = getattr(ctx, "spans", None)
    return None if s is None else s.kernel_ms_per_step(name)


def optimizer_launches(ctx) -> Optional[float]:
    s = getattr(ctx, "spans", None)
    if s is None or not s.launches.get("train.optimizer") or not s.steps:
        return None
    return s.launches["train.optimizer"] / s.steps


def optimizer_idle_ms(ctx) -> Optional[float]:
    s = getattr(ctx, "spans", None)
    if s is None or not s.optimizer_event_ms or not s.steps:
        return None
    busy = s.busy_us.get("train.optimizer", 0.0) / 1e3 / s.steps
    return statistics.fmean(s.optimizer_event_ms) - busy


def untraced_idle_pct(ctx) -> Optional[float]:
    s, t = getattr(ctx, "spans", None), getattr(ctx, "trace", None)
    if s is None or t is None or not s.step_event_ms or not t.steps:
        return None
    busy_ms = t.busy_s * 1e3 / t.steps
    return 100.0 * (1.0 - busy_ms / statistics.fmean(s.step_event_ms))


def prefetch_wait_ms(ctx) -> Optional[float]:
    s = getattr(ctx, "spans", None)
    return None if s is None else s.wait_host_ms


# ---- one run of a cell with spans

SPAN_METRICS = (
    "vision_ms_per_step.train", "text_ms_per_step.train",
    "projector_ms_per_step.train", "llm_ms_per_step.train",
    "head_loss_ms_per_step.train", "optimizer_ms_per_step.train",
    "optimizer_launches_per_step.train", "optimizer_idle_ms_per_step.train",
    "device_idle_untraced_pct.train", "prefetch_wait_ms_per_step.train")


def _steps_in_turns(program, feed, pairs: int):
    """Device milliseconds of steps with spans off and with spans on (with
    events), in turns, `pairs` of each: each from its start to the next
    step's start (the last to its end), marked as the harness marks them."""
    import torch

    from hsenet_torch.utils.profiling import collect, spans_on

    marks = []
    for i in range(2 * pairs):
        batch = next(feed)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        if i % 2:
            with spans_on(events=True):
                program.step(batch)
        else:
            program.step(batch)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    collect()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return ms[0::2], ms[1::2]


def run(workload: str, seed: int, seconds: float, span_steps: Optional[int] = None,
        *, device: Optional[str] = None, cell=None) -> dict:
    """Set-up, a window with spans off, the profiled steps, the span steps,
    then as many steps with spans off and on in turns (the spans' cost) of
    a cell (module docstring); the metrics, the cost and the attribution."""
    import gc
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import Context, build, checked_steps, find_cell, metric_reader
    from benchmark.trace import reduce
    from hsenet_torch.data.prefetch import PRODUCER_NAME
    from hsenet_torch.utils.profiling import collect, spans_on

    cell = cell or find_cell(workload)
    cuda = device is None
    device = device or "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    program, feed = build(cell, seed, device)
    checked_steps(program, feed)  # warms every shape, as the harness's set-up
    if program.has_dropout:
        program.step(next(feed))
    gc.collect()
    sync()
    gc.freeze()  # as the harness keeps set-up's objects out of full passes
    # the window, spans off, its steps' starts marked as the harness marks them
    marks, waits = [], []
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        batch = next(feed)
        waits.append(time.perf_counter() - t)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        program.step(batch)
        if time.perf_counter() - t_start >= seconds:
            break
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    sync()
    window_s = time.perf_counter() - t_start
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    # the profiled steps, spans on
    traced = cell.traffic["trace_steps"]
    loader = {t.native_id for t in threading.enumerate() if t.name == PRODUCER_NAME}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    collect()
    with profile(activities=activities) as prof, spans_on():
        with record_function(SPAN):
            for _ in range(traced):
                program.step(next(feed))
            sync()
    collect()
    summary = reduce(without_spans(prof), traced, skip_threads=loader)
    spans = attribute(prof, traced)
    del prof
    gc.unfreeze()
    gc.collect()  # the trace's events hold cycles: freed now, not in a step
    # the span steps: spans on with events; then steps off and on in turns
    n = span_steps or traced
    off_ms = on_ms = []
    if cuda:
        with spans_on(events=True):
            for _ in range(n):
                program.step(next(feed))
        sync()
        read_span_steps(spans, collect())
        off_ms, on_ms = _steps_in_turns(program, feed, n)
    feed.close()
    program.close()
    ctx = Context(window_s, len(step_ms) or 1, waits, step_ms, [], summary, None)
    ctx.spans = spans
    names = [m["name"] for m in cell.per_layer] + list(SPAN_METRICS)
    metrics = {}
    for name in names:
        value = metric_reader(name, cell.root)(ctx)
        if value is not None:
            metrics[name] = value
    cost = {}
    if on_ms and step_ms:
        cost = {"window_step_ms_p50": statistics.median(step_ms),
                "off_step_ms": off_ms, "on_step_ms": on_ms,
                "on_over_off_p50": statistics.median(b / a for a, b in zip(off_ms, on_ms))}
    card = {"kind": torch.cuda.get_device_name(0) if cuda else "cpu"}
    return {"workload": cell.name, "seed": seed, "device": card,
            "metrics": metrics, "span_cost": cost,
            "coverage_pct": coverage_pct(spans), "_table": table(spans)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--span-steps", type=int, default=None)
    args = p.parse_args(argv)
    from benchmark.run import HOST_THREADS

    os.environ.update(HOST_THREADS)  # before PyTorch is loaded
    result = run(args.workload, args.seed, args.seconds, args.span_steps)
    print(f"[{result['workload']}] " + result.pop("_table"), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
