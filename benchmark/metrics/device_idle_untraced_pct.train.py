"""The share of an untraced step in which the device is idle: 1 - busy ms a
profiled step (the trace's union of device intervals) / the span steps'
mean event time from each `train.step` start to the next (the last to its
end), in percent (`benchmark/spans.py`). Layer: device."""

from benchmark.spans import untraced_idle_pct


def read(ctx):
    return untraced_idle_pct(ctx)
