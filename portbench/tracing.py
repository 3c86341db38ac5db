"""The reduction of a torch.profiler trace of the measured window to the
device's busy time, its operations and the host's idle gaps.

Device operations are the kernels, copies and sets the profiler records on
the card (kineto activity types `kernel`, `gpu_memcpy`, `gpu_memset`); the
device-side copies of named ranges and the runtime's own buffer events are
not work (the arithmetic of `heavydb_tpu_torch/tools/profile_queries.py`,
copied).  Busy time is the union of the operations' intervals inside the
window, so operations that overlap on two streams count once.  The window is
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
    busy_s: float = 0.0
    device_ops: int = 0
    top_ops: list = field(default_factory=list)    # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[what the host did, seconds]]
    # the port's `hdb:` ranges beside the device's work: a spans.Spans
    spans: object = field(default=None, compare=False, repr=False)


def all_threads():
    """The profiler's setting that records the client threads' host
    operations too (without it only the thread that started it)."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


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


def reduce(prof) -> Trace:
    """The Trace of the profiler `prof`, over its WINDOW_RANGE."""
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
            dev.append((s, s + e.duration_ns(), name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    w0, w1 = window
    inside = [(max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _ in inside])
    out = Trace(window_s=(w1 - w0) / 1e9, device_ops=len(inside),
                busy_s=sum(b - a for a, b in busy) / 1e9, spans=S.reduce_spans(prof))
    by_name = {}
    for s, t, n in inside:
        by_name[n] = by_name.get(n, 0) + (t - s)
    out.top_ops = [[n[:120], ns / 1e9] for n, ns in
                   sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    spans.sort()
    ops.sort()
    for ns, a, b in gaps[:TOP]:
        span = _most_overlap(spans, a, b) or "between queries"
        op = _most_overlap(ops, a, b) or "python"
        out.idle_gaps.append([f"{span}: {op}"[:120], ns / 1e9])
    return out
