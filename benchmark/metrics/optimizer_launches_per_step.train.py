"""Kernels launched per profiled step under the span `train.optimizer`
(`benchmark/spans.py`; copies and fills left out). Layer: dispatch."""

from benchmark.spans import optimizer_launches


def read(ctx):
    return optimizer_launches(ctx)
