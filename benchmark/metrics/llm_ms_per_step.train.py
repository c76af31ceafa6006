"""Device milliseconds per profiled step of the kernels attributed to the span
`model.llm` (`benchmark/spans.py`): the token embedding, the decoder blocks
and the final norm, forward, remat's recompute and backward. Layer: models."""

from benchmark.spans import module_ms


def read(ctx):
    return module_ms(ctx, "model.llm")
