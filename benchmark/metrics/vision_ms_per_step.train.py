"""Device milliseconds per profiled step of the kernels attributed to the span
`model.vision` (`benchmark/spans.py`): the 3D towers' forward, remat's
recompute and their backward. Layer: models."""

from benchmark.spans import module_ms


def read(ctx):
    return module_ms(ctx, "model.vision")
