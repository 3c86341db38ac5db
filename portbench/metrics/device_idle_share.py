"""The device's idle share over the traced window: 1 - busy / window, with
busy each card's union of its kernels', copies' and sets' intervals,
averaged over the cell's cards (`tracing.reduce`)."""


def read(ctx):
    t = ctx.trace
    if not t.window_s or not t.busy_s:
        return None
    return 1.0 - t.busy_s / t.window_s
