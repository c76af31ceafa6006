"""Model FLOPs of the window's steps over the window's wall time and the
card's dense bf16 peak, in percent: the forward, input gradients wherever
a trained leaf lies upstream, weight gradients of the trained leaves; dense
work over valid tokens, attention over valid pairs, nothing recomputed
(the family's `step_flops` in `reference/`). Layer: whole step."""

from benchmark.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.flops or ctx.window_s <= 0:
        return None
    return 100.0 * sum(ctx.flops) / ctx.window_s / PEAK_BF16_FLOPS
