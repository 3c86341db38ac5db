"""The device's idle time per query while the host was in the executor:
inside `hdb:execute`, `hdb:fetch` or `hdb:egress` (`spans.account`).  None
where the device ran nothing."""

from portbench import spans


def read(ctx):
    return spans.account(ctx.trace.spans).get("executor_idle_ms")
