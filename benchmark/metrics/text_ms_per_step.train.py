"""Device milliseconds per profiled step of the kernels attributed to the span
`model.text` (`benchmark/spans.py`): BERT and its projection, forward and
backward. Layer: models."""

from benchmark.spans import module_ms


def read(ctx):
    return module_ms(ctx, "model.text")
