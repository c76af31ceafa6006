"""Host milliseconds per span step in the span `data.wait`: the prefetcher's
queue read and the hand-over to the step's stream (`benchmark/spans.py`).
Layer: data."""

from benchmark.spans import prefetch_wait_ms


def read(ctx):
    return prefetch_wait_ms(ctx)
