"""The span steps' mean event time of `train.optimizer` (CUDA events at its
edges, no profiler) minus that span's busy milliseconds a profiled step:
the time the device waits for the optimizer's launches
(`benchmark/spans.py`). Layer: trainer and train steps."""

from benchmark.spans import optimizer_idle_ms


def read(ctx):
    return optimizer_idle_ms(ctx)
