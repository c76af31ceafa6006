"""Profiling and timing helpers (the port of the JAX package's
utils/profiling.py).

`trace` records a torch.profiler trace of the block (host and CUDA
activity) and writes it as a Chrome/Perfetto trace file; `time_fn` times a
call with warm-up, synchronising the device of its outputs; and simple
FLOP and MFU accounting for the encode path.

Spans name the phases and modules of the training path (`span`): the
train step, its forward, backward and optimizer, the towers, packers, LLM,
head and loss, the wait for a batch. They are off unless `spans_on` turns
them on for a block; `trace` and the Trainer's profile window turn them on
for as long as they record. While off, `span` returns one shared no-op
context and records nothing. While on, each span keeps a `SpanRecord` in
memory (`collect` hands them over) and, inside a torch.profiler session,
also opens `record_function(name)`, so the trace shows the span as an
ancestor of every operation it covers. Code being traced by
`torch.compile` or `torch.export` sees no span.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

# one H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, without
# sparsity, at the 700 W power limit)
H100_BF16_PEAK_FLOPS = 989e12


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Record host and CUDA activity of the block with torch.profiler and
    write it to `<logdir>/trace.json` (open it in Perfetto or
    chrome://tracing). `logdir` defaults to `hsenet_trace` under the
    temporary directory. Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "hsenet_trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profiled_spans(), profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


# ---- spans

_OFF = contextlib.nullcontext()  # what `span` returns while spans are off
_on = False  # spans on (`spans_on`)
_events = False  # spans record CUDA events
_records: List["SpanRecord"] = []  # kept until `collect`
_threads = threading.local()  # each thread's stack of open spans


@dataclass(eq=False)
class SpanRecord:
    """One span: its name, the span open around it on the same thread
    (None at the top), the thread (`threading.get_ident()`), the host's
    `perf_counter_ns` at its start and end (0 while open), and, where
    spans record events, the CUDA events recorded on the current stream
    as it opened and closed."""

    name: str
    parent: Optional["SpanRecord"]
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    start_event: Optional[torch.cuda.Event] = None
    end_event: Optional[torch.cuda.Event] = None

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> float:
        """Milliseconds between the two events on the stream (waits for
        the end event)."""
        self.end_event.synchronize()
        return self.start_event.elapsed_time(self.end_event)


def _stack() -> List[SpanRecord]:
    stack = getattr(_threads, "stack", None)
    if stack is None:
        stack = _threads.stack = []
    return stack


class _Span:
    __slots__ = ("name", "record", "function")

    def __init__(self, name: str):
        self.name = name
        self.record = self.function = None

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        rec = SpanRecord(self.name, stack[-1] if stack else None,
                         threading.get_ident())
        if torch.autograd._profiler_enabled():
            self.function = torch.autograd.profiler.record_function(self.name)
            self.function.__enter__()
        if _events:
            rec.start_event = torch.cuda.Event(enable_timing=True)
            rec.end_event = torch.cuda.Event(enable_timing=True)
            rec.start_event.record()
        stack.append(rec)
        _records.append(rec)
        self.record = rec
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if rec.end_event is not None:
            rec.end_event.record()
        _stack().pop()
        if self.function is not None:
            self.function.__exit__(*exc)


def span(name: str):
    """A context manager that records the block as the span `name` while
    spans are on; while they are off (the default), one shared no-op
    context."""
    if not _on:
        return _OFF
    if torch.compiler.is_compiling():  # a traced program holds no span
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def spans_on(events: bool = False):
    """Spans on for the block, as they were after it. With `events` each
    span also records a CUDA event on the current stream as it opens and
    as it closes (its device time; needs a CUDA device). The records stay
    in memory until `collect`."""
    global _on, _events
    if events and not torch.cuda.is_available():
        raise RuntimeError("span events need a CUDA device")
    before = _on, _events
    _on, _events = True, events
    try:
        yield
    finally:
        _on, _events = before


@contextlib.contextmanager
def profiled_spans():
    """Spans on for a profiler's window (`trace`, the Trainer's profile
    window), so its trace shows them; the records are dropped after unless
    spans were on already (someone else collects them then)."""
    kept = _on
    with spans_on(events=_events):
        try:
            yield
        finally:
            if not kept:
                collect()


def collect() -> List[SpanRecord]:
    """The records kept so far, in the order the spans opened; clears
    them."""
    out = _records[:]
    del _records[:len(out)]
    return out


def _sync(out) -> None:
    """Wait for the devices of the tensors in `out` (nested tuples, lists
    and dicts) to finish their work."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _sync(v)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            **kwargs) -> Dict[str, float]:
    """Best and mean wall-clock seconds of `fn(*args, **kwargs)`, each call
    closed by a synchronise of its outputs' devices, after `warmup` calls."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times),
            "iters": iters}


def transformer_flops(batch: int, seq: int, hidden: int, mlp: int, layers: int,
                      extra_matmul_flops: float = 0.0) -> float:
    """Forward FLOPs of a standard pre-LN transformer stack (2 x MACs)."""
    per_layer = (
        4 * seq * hidden * hidden * 2  # qkv + out projections
        + 2 * seq * seq * hidden * 2  # attention score + weighted sum
        + 2 * seq * hidden * mlp * 2  # mlp
    )
    return batch * (layers * per_layer + extra_matmul_flops)


def vit3d_encode_flops(batch: int, cfg) -> float:
    """Forward FLOPs of one ViT3D tower (patch embed + blocks)."""
    patch_embed = cfg.num_patches * cfg.patch_dim * cfg.hidden_size * 2
    return transformer_flops(batch, cfg.seq_len, cfg.hidden_size, cfg.mlp_dim,
                             cfg.num_layers, extra_matmul_flops=patch_embed)


def mfu(flops: float, seconds: float,
        peak_flops: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilisation against a peak; the default is one H100
    SXM's dense bf16 peak, 989 TFLOP/s (a card set below its 700 W power
    limit reaches less)."""
    return flops / seconds / peak_flops
