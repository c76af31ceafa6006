"""The share of the traced steps' span in which no device activity ran:
1 - (union of kernel, copy and fill intervals) / (the span from the first
step's start to the device's end of the last), both from one trace.
Layer: device."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
