"""The attention kernels' share of their roofline over the traced steps:
the summed least time of the attention launches the steps need (the
frozen `roofline.kernel_bound` at the cell's shapes and generated valid
lengths: each forward with its log-sum-exp and each backward once, a frozen
tower's forward without) over the device time of the kernels launched
under the port's attention operations (remat's second forward included).
Layer: kernels."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.attention_bound_ms is None:
        return None
    spent_ms = t.attention_us / 1e3
    if spent_ms <= 0:
        return None
    return 100.0 * ctx.attention_bound_ms / spent_ms
