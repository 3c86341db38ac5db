"""The device's idle time per query while the host was in the front end:
inside `hdb:parse`, `hdb:plan` or the `hdb:query` root outside its
execute, fetch and egress (`spans.account`).  None where the device ran
nothing."""

from portbench import spans


def read(ctx):
    return spans.account(ctx.trace.spans).get("front_end_idle_ms")
