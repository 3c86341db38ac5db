"""The device time per query of the operations launched inside the port's
`hdb:join#<level>` ranges, the join's build and probe (`spans.account`).
None where no join ran or the device ran nothing."""

from portbench import spans


def read(ctx):
    return spans.account(ctx.trace.spans).get("join_device_ms")
