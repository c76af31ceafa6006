"""Device milliseconds per traced step of the library's matrix products
(kernels named as cuBLAS or CUTLASS name theirs), outside the attention
operations. Layer: models."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    return t.gemm_us / 1e3 / t.steps
