"""Device milliseconds per profiled step of the kernels attributed to the span
`train.optimizer` (`benchmark/spans.py`): the global norm, the clip and
AdamW. Layer: trainer and train steps."""

from benchmark.spans import module_ms


def read(ctx):
    return module_ms(ctx, "train.optimizer")
