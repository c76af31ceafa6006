"""Device milliseconds per profiled step of the kernels attributed to the span
`model.projector` (`benchmark/spans.py`): the packers `mm_projector` and
`mm_projector2`, forward and backward. Layer: models."""

from benchmark.spans import module_ms


def read(ctx):
    return module_ms(ctx, "model.projector")
