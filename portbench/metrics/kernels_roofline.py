"""The traced window's queries' necessary bytes over the card's memory
bandwidth, as a share (%) of the device's busy time.

A query's bytes are every column its template reads, over all rows of that
column's table, read once, plus its result's columns written once: what any
implementation must move, whatever the port does.  Busy time is every
kernel, copy and set on the device, summed over the cell's cards: the share
is of what the cards could have moved while busy, so it cannot pass 100 %
on honest work however many cards stream at once.  None where the card's
bandwidth is not in the table of peaks."""

from portbench.peaks import hbm_bytes_per_s


def column_bytes(ctx, template: str) -> int:
    tpl = ctx.cell.templates[template]
    return sum(ctx.widths[table][c] * ctx.table_rows[table]
               for table, cols in tpl.READS.items() for c in cols)


def read(ctx):
    bw = hbm_bytes_per_s(ctx.kind)
    if bw is None or not ctx.trace.busy_s or not ctx.queries:
        return None
    per = {}
    total = 0
    for q in ctx.queries:
        if q.template not in per:
            per[q.template] = column_bytes(ctx, q.template)
        total += per[q.template] + q.result_bytes
    return 100.0 * total / bw / sum(ctx.trace.busy_s_by_card)
