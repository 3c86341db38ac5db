"""The port's `hdb:kernel_build` ranges, each a miss of its kernel cache,
per query completed in the traced window (`spans.account`)."""

from portbench import spans


def read(ctx):
    return spans.account(ctx.trace.spans).get("kernel_builds_per_query")
