"""Kernel launches per traced step (device kernels in the trace; copies and
fills left out): the host work that paces a step whose kernels are short.
Layer: dispatch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    return t.launches / t.steps
