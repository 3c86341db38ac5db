"""The port's `hdb:retry` ranges, each a Compound run again after a missed
capacity or a changed tier, per query completed in the traced window
(`spans.account`)."""

from portbench import spans


def read(ctx):
    return spans.account(ctx.trace.spans).get("retries_per_query")
