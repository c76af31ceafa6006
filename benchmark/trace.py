"""The reduction of a `torch.profiler` trace of a few training steps to what
the per-layer metrics read.

The harness profiles host and device over `steps` whole steps, between two
synchronisations, inside a host span named `SPAN`. Every device activity
(kernel, copy, fill) counts as busy time; the idle share is the part of
the span that no activity covers. The profiler links each kernel to the
host operation that launched it; a kernel is attention work where that
operation or one of its parents is one of `ATTENTION_OPS` (the port's
flash forward, its autograd forward and backward nodes).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from benchmark.roofline import is_gemm

SPAN = "benchmark.traced_steps"
ATTENTION_OPS = ("hsenet_torch::flash_fwd", "_FlashAttention",
                 "_FlashAttentionBackward")
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # a breakdown name's length
GAP_LOOKBACK = 4000  # host operations searched for the one around a gap


def is_attention_op(name: str) -> bool:
    return any(name == op or name.endswith(": " + op) for op in ATTENTION_OPS)


@dataclass
class TraceSummary:
    """Device time of `steps` traced steps: kernel microseconds by kind
    (attention work, library matrix products outside it, the rest), the
    kernels launched, the traced span and the time some device activity
    covered in it, and the breakdowns."""

    steps: int
    window_s: float
    busy_s: float
    launches: int
    attention_us: float
    gemm_us: float
    glue_us: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _label_gaps(gaps, host_ops) -> Dict[str, float]:
    """Gap seconds by the host operation that last began among those running
    at each gap's middle ("python" where none was)."""
    starts = [op[0] for op in host_ops]
    by_label: Dict[str, float] = {}
    for start, end in gaps:
        mid = (start + end) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "python"
        for j in range(i, max(i - GAP_LOOKBACK, -1), -1):
            if host_ops[j][1] >= mid:
                label = host_ops[j][2]
                break
        by_label[label] = by_label.get(label, 0.0) + (end - start) / 1e6
    return by_label


def reduce(prof, steps: int, skip_threads=()) -> TraceSummary:
    """The summary of a profile whose host span `SPAN` covers `steps` steps.
    The idle gaps are labelled by host operations of every thread but
    `skip_threads` (the loader's, which prepares batches ahead)."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    span = next(e for e in cpu if e.name == SPAN)
    t0, t1 = span.time_range.start, span.time_range.end
    intervals, by_name = [], {}
    launches = gemm_us = kernel_us = 0.0
    for e in events:
        if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
            continue
        start, end = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if end > start:
            intervals.append((start, end))
        if e.name.startswith(COPY_PREFIXES):
            continue
        us = e.time_range.end - e.time_range.start
        launches += 1
        kernel_us += us
        gemm_us += us if is_gemm(e.name) else 0.0
        key = e.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + us / 1e6
    # the kernels each host operation launched itself, under an attention op
    attention_us = attention_gemm_us = 0.0
    for e in cpu:
        if not e.kernels:
            continue
        op, inside = e, False
        while op is not None and not inside:
            inside = is_attention_op(op.name)
            op = op.cpu_parent
        if inside:
            for k in e.kernels:
                if not k.name.startswith(COPY_PREFIXES):
                    attention_us += k.duration
                    attention_gemm_us += k.duration if is_gemm(k.name) else 0.0
    busy = union(intervals)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    launchers = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                       if e.thread not in skip_threads and e.name != SPAN)
    gap_s = _label_gaps(gaps, launchers)
    return TraceSummary(
        steps=steps, window_s=(t1 - t0) / 1e6,
        busy_s=sum(end - start for start, end in busy) / 1e6,
        launches=int(launches), attention_us=attention_us,
        gemm_us=gemm_us - attention_gemm_us,
        glue_us=kernel_us - gemm_us - (attention_us - attention_gemm_us),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(gap_s.items(), key=lambda kv: -kv[1])[:TOP])
