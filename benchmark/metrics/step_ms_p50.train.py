"""The median time between consecutive step starts on the device's stream,
from CUDA events recorded at the window's step boundaries with no added
synchronise. A steadier statistic beside the window's rate, never a
decider. Layer: trainer and train steps."""

import statistics


def read(ctx):
    if not ctx.step_ms:
        return None
    return statistics.median(ctx.step_ms)
