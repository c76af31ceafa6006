"""Host time the step loop waited for its next batch from the loader (the
port's DataLoader behind its DevicePrefetcher), per step of the window.
Layer: data."""


def read(ctx):
    if not ctx.waits_s:
        return None
    return 1e3 * sum(ctx.waits_s) / len(ctx.waits_s)
