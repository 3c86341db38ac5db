"""Kernels, copies and sets on the device per query completed in the traced
window, counted on every card of the cell: the launches and transfers the
host pays for."""


def read(ctx):
    if not ctx.queries or not ctx.trace.device_ops:
        return None
    return ctx.trace.device_ops / len(ctx.queries)
