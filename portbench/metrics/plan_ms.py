"""The mean host time of the `plan` scope per query (bind, plan, optimise),
from the port's debug timer (`Config(enable_debug_timer=True)`, read from
`Database.last_query_timings` after each query; sound with one client)."""


def read(ctx):
    v = [q.plan_ms for q in ctx.queries if q.plan_ms is not None]
    return sum(v) / len(v) if v else None
