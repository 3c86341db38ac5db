"""The reduction of a torch.profiler trace of the measured window to the
device's busy time, its operations and the host's idle gaps.

Device operations are the kernels, copies and sets the profiler records on
the card (kineto activity types `kernel`, `gpu_memcpy`, `gpu_memset`); the
device-side copies of named ranges and the runtime's own buffer events are
not work (the arithmetic of `heavydb_tpu_torch/tools/profile_queries.py`,
copied).  Each card's busy time is the union of its operations' intervals
inside the window, so operations that overlap on two streams count once;
the cards are those of the cell, cuda:0 .. cuda:{cards-1} by the events'
`device_index()`, and one that ran nothing is busy for 0 s.  The window is
the harness's own range WINDOW_RANGE; each query runs inside a range named
`pb:<template>`, which names the idle gaps it leaves.  The port's own
`hdb:` ranges are kept apart, as `Trace.spans` (`portbench/spans.py`): no
field above counts or names them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_RANGE = "pb:window"
QUERY_PREFIX = "pb:"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
NOT_OPS = {"Activity Buffer Request", "Command Buffer Full"}
TOP = 10


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0                                # the mean over the cards
    busy_s_by_card: list = field(default_factory=list)
    device_ops: int = 0                                # over every card
    top_ops: list = field(default_factory=list)    # [[name, seconds]], every card
    # [[what the host did, seconds]]: card 0's, the Database's card, where
    # every gathered node and merge runs
    idle_gaps: list = field(default_factory=list)
    # the port's `hdb:` ranges beside the device's work: a spans.Spans
    spans: object = field(default=None, compare=False, repr=False)


def all_threads():
    """The profiler's setting that records the client threads' host
    operations too (without it only the thread that started it)."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


def by_card(rows, cards: int) -> list:
    """Each card's union of the intervals of `rows` ([start, end, card,
    ...]): one a card of the cell's `cards`, empty for a card that ran
    nothing, and one for each card beyond them that ran something."""
    out = [[] for _ in range(max([cards] + [r[2] + 1 for r in rows]))]
    for r in rows:
        out[r[2]].append((r[0], r[1]))
    return [_union(iv) for iv in out]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _most_overlap(events, a, b):
    best, best_ov = None, 0
    for s, e, name in events:
        if s >= b:
            break
        ov = min(e, b) - max(s, a)
        if ov > best_ov:
            best, best_ov = name, ov
    return best


def _kind(e):
    """The kineto activity type of an event, where this torch reports it."""
    f = getattr(e, "activity_type", None)
    return f() if f is not None else None


def _is_annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    if f is not None:
        return f()
    return e.name().startswith(QUERY_PREFIX)


def reduce(prof, cards: int = 1) -> Trace:
    """The Trace of the profiler `prof`, over its WINDOW_RANGE, on a cell of
    `cards` cards."""
    from torch.autograd import DeviceType

    from portbench import spans as S

    events = prof.profiler.kineto_results.events()
    window = None
    dev, spans, ops, ranges = [], [], [], set()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            continue
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if _is_annotation(e):
            ranges.add(name)
            if name == WINDOW_RANGE:
                window = (s, t)
            elif name.startswith(QUERY_PREFIX):
                spans.append((s, t, name[len(QUERY_PREFIX):]))
        else:
            ops.append((s, t, name))
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        name, kind = e.name(), _kind(e)
        # kernels, copies and sets; not the device side of a named range
        if (kind in DEVICE_KINDS if kind is not None else name not in ranges) \
                and name not in NOT_OPS:
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.device_index(), name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    w0, w1 = window
    inside = [(max(s, w0), min(t, w1), c, n) for s, t, c, n in dev if t > w0 and s < w1]
    busy = by_card(inside, cards)
    per = [sum(b - a for a, b in u) / 1e9 for u in busy]
    out = Trace(window_s=(w1 - w0) / 1e9, busy_s=sum(per) / len(per), busy_s_by_card=per,
                device_ops=len(inside), spans=S.reduce_spans(prof, cards))
    by_name = {}
    for s, t, _, n in inside:
        by_name[n] = by_name.get(n, 0) + (t - s)
    out.top_ops = [[n[:120], ns / 1e9] for n, ns in
                   sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    edges = [w0] + [x for iv in busy[0] for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    spans.sort()
    ops.sort()
    for ns, a, b in gaps[:TOP]:
        span = _most_overlap(spans, a, b) or "between queries"
        op = _most_overlap(ops, a, b) or "python"
        out.idle_gaps.append([f"{span}: {op}"[:120], ns / 1e9])
    return out
