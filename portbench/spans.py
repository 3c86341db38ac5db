"""The port's own spans in a traced run: its `hdb:` ranges
(heavydb_tpu_torch/utils/timer.py) on the profiler's clock, beside the
device's work.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `python3 -m portbench.run --trace 1` does, prints that
result line, then one JSON line {"spans": ...}: per query completed in the
traced window, the host time of `hdb:parse`; the device's idle time inside
`hdb:execute` / `hdb:fetch` / `hdb:egress` (executor), inside the rest of
`hdb:parse` / `hdb:plan` / `hdb:query` (front end: parse, plan and the
root's own time in api.py between its scopes), and outside every `hdb:`
range, three parts that add up to the idle time;
the `hdb:retry` and `hdb:kernel_build` ranges; the device time of the
operations launched inside `hdb:join#<level>`; and each span name's host
time, idle time and device time, each template's retries and kernel
builds, and the longest device operations by name.

On a cell of several cards, idle time is each card's (the window less the
union of that card's operations), averaged over the cell's cards, a card
that ran nothing idle for the whole window; device time is each card's
union, summed over the cards; operations are counted on every card.  On
one card each is the card's own.

A device operation belongs to the spans its launch ran in: the host
runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...) with the operation's
correlation id, on that call's thread.  A call that no aten op encloses
(the hand kernels' launches through ctypes) carries the profiler's default
thread, not its own, so it is placed by its time alone: exact with one
client thread, as every cell has.  The device-side copies of the
ranges are only counted (`device_ranges`): kineto ties each launch to the
innermost annotation open at it, and a device-side range spans the first
to the last operation launched directly inside its scope, so it leaves
out the work of nested scopes and takes in what runs between.

`tracing.reduce` keeps `reduce_spans(prof)` on its Trace as `spans` (the
window, the busy intervals, the host and device `hdb:` ranges, the
launches), and the per-layer metrics `parse_ms`, `front_end_idle_ms`,
`executor_idle_ms`, `retries_per_query`, `kernel_builds_per_query` and
`join_device_ms` (`portbench/metrics/`) each read one number of
`account(trace.spans)`.  Nothing here imports the port; `main` runs it
through `portbench.harness`.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
from dataclasses import dataclass, field

from portbench import tracing

PREFIX = "hdb:"
FRONT_END = ("parse", "plan", "query")
EXECUTOR = ("execute", "fetch", "egress")
# kineto's activity types of the host's CUDA calls, whose correlation ids
# the device operations they launched carry
LAUNCH_KINDS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Spans:
    window: tuple = (0, 0)                           # (w0, w1), ns
    # each card's union of its device ops, [[a, b]], one a card of the cell
    busy: list = field(default_factory=list)
    spans: list = field(default_factory=list)        # host [start, end, name, thread]
    device_spans: list = field(default_factory=list)  # device-side [start, end, name]
    queries: list = field(default_factory=list)      # pb:<template> [start, end, name, thread]
    # each device operation in the window: [launch ns, launching thread,
    # start, end, name, card] (launch None where no host call carries its
    # id; thread None where the call's thread is not known)
    launches: list = field(default_factory=list)
    # account(self), once it was asked for: each reader asks
    reading: dict = field(default=None, compare=False, repr=False)


def _thread(e):
    f = getattr(e, "start_thread_id", None)
    return f() if f is not None else 0


def _launch_thread(e):
    """The thread of a CUDA call, or None for a call with no enclosing aten
    op, which the profiler files under its default thread."""
    f = getattr(e, "linked_correlation_id", None)
    return _thread(e) if f is None or f() != 0 else None


def _is_launch(e, name: str) -> bool:
    """A host CUDA runtime or driver call (cudaLaunchKernel,
    cudaMemcpyAsync, cuLaunchKernel, ...).  Where torch reports no
    activity type, by its name."""
    kind = tracing._kind(e)
    if kind is not None:
        return kind in LAUNCH_KINDS
    return name.startswith("cu") and "::" not in name


def reduce_spans(prof, cards: int = 1) -> Spans:
    """The Spans of the profiler `prof` over its tracing.WINDOW_RANGE, on a
    cell of `cards` cards: device operations as `tracing.reduce` counts them
    (kernels, copies and sets, not the device-side copies of ranges),
    clipped to the window."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window, host, queries, dev, dev_ops, calls = None, [], [], [], [], {}
    for e in events:
        name, s = e.name(), e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            kind = tracing._kind(e)
            if name.startswith(PREFIX):
                dev.append([s, t, name[len(PREFIX):]])
            elif (kind in tracing.DEVICE_KINDS if kind is not None
                  else not name.startswith(tracing.QUERY_PREFIX)) \
                    and name not in tracing.NOT_OPS:
                dev_ops.append((s, t, e.device_index(), e.correlation_id(), name))
        elif _is_launch(e, name):
            calls[e.correlation_id()] = (s, _launch_thread(e))
        elif name == tracing.WINDOW_RANGE:
            window = (s, t)
        elif name.startswith(PREFIX):
            host.append([s, t, name[len(PREFIX):], _thread(e)])
        elif name.startswith(tracing.QUERY_PREFIX) and tracing._is_annotation(e):
            queries.append([s, t, name[len(tracing.QUERY_PREFIX):], _thread(e)])
    if window is None:
        raise RuntimeError(f"the trace holds no {tracing.WINDOW_RANGE!r} range")
    w0, w1 = window

    def clip(rows):
        return sorted([max(r[0], w0), min(r[1], w1), *r[2:]] for r in rows
                      if r[1] > w0 and r[0] < w1)

    inside = [(max(s, w0), min(t, w1), k, c, n) for s, t, k, c, n in dev_ops
              if t > w0 and s < w1]
    busy = tracing.by_card(inside, cards)
    launches = [[*calls.get(c, (None, None)), s, t, n, k] for s, t, k, c, n in inside]
    return Spans(window, busy, clip(host), clip(dev), clip(queries), launches)


def _intersect(a, b) -> list:
    """The intersection of two sorted disjoint unions, as one."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _len(u) -> int:
    return sum(b - a for a, b in u)


def _gaps(window, busy):
    """The window's intervals that `busy` (a sorted disjoint union) leaves."""
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _kind(name: str) -> str:
    """A span's name without its node or level number: Compound#7 -> Compound#."""
    return re.sub(r"#\d+$", "#", name)


def _of(rows, keep):
    """The union of the ranges among `rows` whose name passes `keep`."""
    return tracing._union([(r[0], r[1]) for r in rows if keep(r[2])])


def _launched_in(sp: Spans, keep) -> list:
    """The device operations (rows of `sp.launches`) launched inside a
    host range whose name passes `keep`, on the range's thread (on any
    thread where the launch's is not known)."""
    ranges = {}
    for s, t, name, th in sp.spans:
        if keep(name):
            ranges.setdefault(th, []).append((s, t))
    ranges[None] = [iv for v in ranges.values() for iv in v]
    ranges = {th: tracing._union(v) for th, v in ranges.items()}
    starts = {th: [a for a, _ in u] for th, u in ranges.items()}
    out = []
    for row in sp.launches:
        ts, th = row[0], row[1]
        u = ranges.get(th)
        if u and ts is not None:
            i = bisect.bisect_right(starts[th], ts) - 1
            if i >= 0 and ts <= u[i][1]:
                out.append(row)
    return out


def _by_name(rows, ms, top) -> list:
    """The `top` longest names among operations (rows of `sp.launches`),
    each with its device time per query."""
    names = {}
    for r in rows:
        names[r[4][:80]] = names.get(r[4][:80], 0) + r[3] - r[2]
    return sorted(([name, v / ms] for name, v in names.items()), key=lambda row: -row[1])[:top]


def _device(rows) -> int:
    """The device time of operations: each card's, overlaps counted once,
    summed over the cards."""
    return sum(_len(u) for u in tracing.by_card([(r[2], r[3], r[5]) for r in rows], 1))


def account(sp: Spans) -> dict:
    """The per-query readings of a Spans.  Every reading is left out where
    the trace holds no `hdb:` range; the idle and device ones also where
    the device ran nothing (the CPU).  Worked out once a Spans."""
    if sp.reading is None:
        sp.reading = _account(sp)
    return sp.reading


def _account(sp: Spans) -> dict:
    n = len(sp.queries)
    if not n or not sp.spans:
        return {"queries": n}
    ms = 1e6 * n  # ns a query -> ms
    count = {}
    for r in sp.spans:
        count[r[2]] = count.get(r[2], 0) + 1
    out = {
        "queries": n,
        "parse_ms": sum(r[1] - r[0] for r in sp.spans if r[2] == "parse") / ms,
        "retries_per_query": count.get("retry", 0) / n,
        "kernel_builds_per_query": count.get("kernel_build", 0) / n,
    }
    kinds = sorted({_kind(r[2]) for r in sp.spans})
    out["device_ranges"] = {}
    for r in sp.device_spans:
        k = _kind(r[2])
        out["device_ranges"][k] = out["device_ranges"].get(k, 0) + 1
    by = {k: {"host_ms": sum(r[1] - r[0] for r in sp.spans if _kind(r[2]) == k) / ms,
              "count": sum(1 for r in sp.spans if _kind(r[2]) == k) / n} for k in kinds}
    if any(sp.busy):
        # each card's idle time, averaged over the cards
        idle = [_gaps(sp.window, u) for u in sp.busy]
        card_ms = ms * len(idle)

        def idle_in(keep) -> int:
            """The cards' idle ns inside the host ranges that pass `keep`."""
            rng = _of(sp.spans, keep)
            return sum(_len(_intersect(i, rng)) for i in idle)

        in_execu = _of(sp.spans, EXECUTOR.__contains__)
        in_front = _of(sp.spans, FRONT_END.__contains__)
        execu = [_intersect(i, in_execu) for i in idle]
        front = [_intersect(i, in_front) for i in idle]
        total = sum(_len(i) for i in idle)
        out.update({
            "busy_ms": sum(_len(u) for u in sp.busy) / card_ms,
            "launches_found": sum(1 for r in sp.launches if r[0] is not None)
            / len(sp.launches),
            "idle_ms": total / card_ms,
            "front_end_idle_ms": sum(_len(f) - _len(_intersect(f, e))
                                     for f, e in zip(front, execu)) / card_ms,
            "executor_idle_ms": sum(_len(e) for e in execu) / card_ms,
            "outside_idle_ms": (total - idle_in(bool)) / card_ms,
        })
        if "join#" in kinds:
            out["join_device_ms"] = _device(_launched_in(sp, lambda s: s.startswith("join#"))) / ms
        # the operations no `hdb:` range launched, and the ten longest by name
        spanned = {id(r) for r in _launched_in(sp, bool)}
        rest = [r for r in sp.launches if id(r) not in spanned]
        out["outside_device_ms"] = _device(rest) / ms
        out["outside_ops"] = _by_name(rest, ms, 10)
        # every operation, the thirty longest by name: a hand kernel that
        # falls outside the result line's ten
        out["device_ops"] = _by_name(sp.launches, ms, 30)
        for k in kinds:
            by[k]["idle_ms"] = idle_in(lambda s: _kind(s) == k) / card_ms
            by[k]["device_ms"] = _device(_launched_in(sp, lambda s: _kind(s) == k)) / ms
    out["by_span"] = by
    out["by_template"] = _by_template(sp)
    return out


def _by_template(sp: Spans) -> dict:
    """Each template's queries, and the `retry` and `kernel_build` ranges
    inside its queries' `pb:` ranges on the same thread, per query."""
    out = {}
    for q0, q1, tpl, th in sp.queries:
        d = out.setdefault(tpl, {"queries": 0, "retries": 0, "kernel_builds": 0})
        d["queries"] += 1
        for s, t, name, th2 in sp.spans:
            if th2 == th and q0 <= s and t <= q1:
                if name == "retry":
                    d["retries"] += 1
                elif name == "kernel_build":
                    d["kernel_builds"] += 1
    for d in out.values():
        d["retries"] /= d["queries"]
        d["kernel_builds"] /= d["queries"]
    return out


def run(workload: str, seed: int, seconds: float, device: str = "cuda",
        scale: float = 1.0) -> tuple:
    """A traced run of `workload` (harness.run with trace on); returns its
    result line and the account of its spans."""
    from portbench import harness

    got = {}
    reduce = tracing.reduce

    def keep(prof, cards=1):
        got["trace"] = reduce(prof, cards)
        return got["trace"]

    tracing.reduce = keep
    try:
        out = harness.run(workload, seed, seconds, True, device, scale=scale)
    finally:
        tracing.reduce = reduce
    return out, account(got["trace"].spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    out, spans = run(args.workload, args.seed, args.seconds)
    print(json.dumps(out))
    print(json.dumps({"spans": spans}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
