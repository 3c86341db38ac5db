"""The host time of the port's `hdb:parse` ranges per query completed in the
traced window (`spans.account`)."""

from portbench import spans


def read(ctx):
    return spans.account(ctx.trace.spans).get("parse_ms")
