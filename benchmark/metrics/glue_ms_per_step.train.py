"""Device milliseconds per traced step of every kernel that is neither
attention work nor a library matrix product: elementwise, norms,
reductions, casts, copies inside the step, the optimizer. Layer: models."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    return t.glue_us / 1e3 / t.steps
