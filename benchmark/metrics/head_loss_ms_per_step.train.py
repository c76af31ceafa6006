"""Device milliseconds per profiled step of the kernels attributed to the span
`model.head_loss` (`benchmark/spans.py`): the LM head and the masked LM
loss, or the contrastive loss, forward and backward. Layer: models."""

from benchmark.spans import module_ms


def read(ctx):
    return module_ms(ctx, "model.head_loss")
