"""The reduction of the port's `hdb:` ranges (portbench/spans.py) on
hand-built profiler events, and on a traced run of a cell on the CPU."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spans as S
from portbench import tracing
from portbench.harness import LayerContext
from portbench.tests.test_portbench_cells import CELLS, scale_of
from portbench.spec import Cell


class Ev:
    """A kineto event as `prof.profiler.kineto_results.events()` gives it."""

    def __init__(self, name, start, end, kind, corr=0, thread=1, linked=1, card=0):
        self._name, self._s, self._t, self._kind = name, start, end, kind
        self._corr, self._th, self._linked, self._card = corr, thread, linked, card
        self.activity_type = lambda: kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t - self._s

    def device_type(self):
        return DeviceType.CPU if self._kind in ("user_annotation", "cpu_op", "cuda_runtime") \
            else DeviceType.CUDA

    def correlation_id(self):
        return self._corr

    def device_index(self):
        return self._card

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return self._kind == "user_annotation"

    def start_thread_id(self):
        return self._th


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


# one query of 0-100 ns in a window of 0-120: parse 0-10, the query root
# 10-82 (plan 10-20, execute 20-80 with a join 30-60 and a retry 60-70),
# egress 85-95; a kernel launched at 31 (in the join) runs 35-50, a copy
# launched at 61 (in the retry) 62-75
BASE = [
    ("pb:window", 0, 120, "user_annotation"),
    ("pb:Q1", 0, 100, "user_annotation"),
    ("aten::add", 31, 33, "cpu_op", 7),
    ("cudaLaunchKernel", 31, 32, "cuda_runtime", 7),
    ("cudaMemcpyAsync", 61, 62, "cuda_runtime", 8),
    ("k1", 35, 50, "kernel", 7),
    ("memcpy", 62, 75, "gpu_memcpy", 8),
]
HDB = [
    ("hdb:parse", 0, 10, "user_annotation"),
    ("hdb:query", 10, 82, "user_annotation"),
    ("hdb:plan", 10, 20, "user_annotation"),
    ("hdb:execute", 20, 80, "user_annotation"),
    ("hdb:join#0", 30, 60, "user_annotation"),
    ("hdb:retry", 60, 70, "user_annotation"),
    ("hdb:kernel_build", 61, 62, "user_annotation"),
    ("hdb:egress", 85, 95, "user_annotation"),
    ("hdb:join#0", 40, 55, "gpu_user_annotation"),
    ("hdb:execute", 25, 75, "gpu_user_annotation"),
]


def _events(rows, typed=True):
    """Fresh events; untyped, as a torch that reports no activity types
    (2.11) gives them."""
    out = [Ev(*r) for r in rows]
    if not typed:
        for e in out:
            del e.activity_type
    return out


@pytest.mark.parametrize("typed", [True, False])
def test_hdb_ranges_leave_the_trace_as_it_was(typed):
    """The benchmark's reduction counts no `hdb:` range as a device
    operation and names no idle gap by one; it keeps them as `spans`."""
    was = tracing.reduce(_prof(_events(BASE, typed)))
    now = tracing.reduce(_prof(_events(BASE + HDB, typed)))
    assert now == was
    assert now.device_ops == 2 and now.busy_s == 28e-9
    assert was.spans.spans == [] and len(now.spans.spans) == 8


FIELDS = ("window_s", "busy_s", "busy_s_by_card", "device_ops", "top_ops", "idle_gaps")


def test_spans_leave_the_fields_of_a_recorded_trace(monkeypatch):
    """On a trace the profiler recorded on the CPU, the fields the metrics
    and `breakdown` read are the same with `spans` kept and without."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW_RANGE):
            for _ in range(3):
                with record_function(tracing.QUERY_PREFIX + "Q1"):
                    with record_function("hdb:parse"):
                        x = torch.arange(1000).sum()
                    with record_function("hdb:execute"):
                        x = (torch.rand(1000) + x).sort().values
    kept = tracing.reduce(prof)
    monkeypatch.setattr(S, "reduce_spans", lambda p, cards: None)
    bare = tracing.reduce(prof)
    assert bare.spans is None and len(kept.spans.queries) == 3
    assert kept.idle_gaps and kept.window_s > 0
    for f in FIELDS:
        assert getattr(kept, f) == getattr(bare, f), f
    assert S.account(kept.spans)["parse_ms"] > 0


READERS = ("parse_ms", "front_end_idle_ms", "executor_idle_ms", "retries_per_query",
           "kernel_builds_per_query", "join_device_ms")


@pytest.mark.parametrize("metric", READERS)
def test_span_readers(metric):
    """Each reader gives account's number on a trace with `hdb:` ranges and
    None on one without."""
    cell = Cell("tpch.sf10.power")
    read = cell.metric_reader(metric).read
    for rows, want in ((BASE, None), (BASE + HDB, S.account(
            S.reduce_spans(_prof(_events(BASE + HDB)))).get(metric))):
        trace = tracing.reduce(_prof(_events(rows)))
        got = read(LayerContext(cell, [], trace, "cpu", {}, {}))
        assert got == want
    assert isinstance(want, float)


@pytest.mark.parametrize("typed", [True, False])
def test_reduce_spans_fills_each_field(typed):
    sp = S.reduce_spans(_prof(_events(BASE + HDB, typed)))
    assert sp.window == (0, 120)
    assert sp.busy == [[[35, 50], [62, 75]]]
    assert [r[2] for r in sp.spans] == ["parse", "plan", "query", "execute", "join#0",
                                        "retry", "kernel_build", "egress"]
    assert sp.spans[0] == [0, 10, "parse", 1]
    assert sp.device_spans == [[25, 75, "execute"], [40, 55, "join#0"]]
    assert sp.queries == [[0, 100, "Q1", 1]]
    assert sp.launches == [[31, 1, 35, 50, "k1", 0], [61, 1, 62, 75, "memcpy", 0]]


@pytest.mark.parametrize("typed", [True, False])
def test_account_reads_each_metric(typed):
    a = S.account(S.reduce_spans(_prof(_events(BASE + HDB, typed))))
    ms = 1e-6  # ns in ms, one query
    assert a["queries"] == 1
    assert a["parse_ms"] == pytest.approx(10 * ms)
    assert a["retries_per_query"] == 1 and a["kernel_builds_per_query"] == 1
    # idle: 0-35, 50-62, 75-120 = 92 ns
    assert a["busy_ms"] == pytest.approx(28 * ms) and a["launches_found"] == 1
    assert a["idle_ms"] == pytest.approx(92 * ms)
    # parse 0-10, plan 10-20, the root's own 80-82
    assert a["front_end_idle_ms"] == pytest.approx(22 * ms)
    # 20-35, 50-62, 75-80 in execute; 85-95 in egress
    assert a["executor_idle_ms"] == pytest.approx(42 * ms)
    assert a["outside_idle_ms"] == pytest.approx(28 * ms)         # 82-85, 95-120
    assert a["front_end_idle_ms"] + a["executor_idle_ms"] + a["outside_idle_ms"] == \
        pytest.approx(a["idle_ms"])
    # the kernel launched in the join, not the device-side range's 40-55
    assert a["join_device_ms"] == pytest.approx(15 * ms)
    assert a["by_span"]["retry"]["device_ms"] == pytest.approx(13 * ms)
    assert a["by_span"]["execute"]["device_ms"] == pytest.approx(28 * ms)
    assert a["outside_device_ms"] == 0 and a["outside_ops"] == []
    assert a["device_ops"] == [["k1", pytest.approx(15 * ms)], ["memcpy", pytest.approx(13 * ms)]]
    assert a["device_ranges"] == {"execute": 1, "join#": 1}
    assert a["by_span"]["join#"]["idle_ms"] == pytest.approx(15 * ms)  # 30-35, 50-60
    assert a["by_template"] == {"Q1": {"queries": 1, "retries": 1.0, "kernel_builds": 1.0}}


def test_unlinked_launch_is_placed_by_its_time():
    """A hand kernel's ctypes launch has no enclosing aten op, and the
    profiler files it under its default thread (9 here): it still belongs
    to the join it was launched in."""
    rows = BASE + HDB + [("cudaLaunchKernelExC", 40, 41, "cuda_runtime", 9, 9, 0),
                         ("stream_agg", 52, 54, "kernel", 9)]
    a = S.account(S.reduce_spans(_prof(_events(rows))))
    assert a["join_device_ms"] == pytest.approx(17e-6)   # 35-50 and 52-54
    assert a["outside_device_ms"] == 0


def test_operations_launched_outside_every_range():
    rows = BASE + HDB + [("cudaLaunchKernel", 97, 98, "cuda_runtime", 9),
                         ("k2", 98, 99, "kernel", 9)]
    a = S.account(S.reduce_spans(_prof(_events(rows))))
    assert a["outside_device_ms"] == pytest.approx(1e-6)
    assert a["outside_ops"] == [["k2", pytest.approx(1e-6)]]
    assert a["by_span"]["execute"]["device_ms"] == pytest.approx(28e-6)


def test_account_is_empty_without_hdb_ranges():
    a = S.account(S.reduce_spans(_prof(_events(BASE))))
    assert a == {"queries": 1}
    # and the idle readings need device work
    host = [r for r in BASE + HDB if r[3] in ("user_annotation", "cpu_op", "cuda_runtime")]
    a = S.account(S.reduce_spans(_prof(_events(host))))
    assert "parse_ms" in a and "front_end_idle_ms" not in a and "join_device_ms" not in a


def test_traced_run_on_cpu_reads_the_host_spans():
    cell = CELLS[0]
    out, a = S.run(cell, 77, 0.5, "cpu", scale=scale_of(cell))
    assert out["correct"]
    assert a["parse_ms"] > 0
    assert a["retries_per_query"] >= 0 and a["kernel_builds_per_query"] >= 0
    # the CPU has no device trace: the idle readings are left out, as
    # device_idle_share is
    assert "front_end_idle_ms" not in a and "executor_idle_ms" not in a
    assert "device_idle_share" not in out["metrics"]
    assert set(a["by_template"]) <= set(Cell(cell).templates)


# a second card: two kernels launched inside the join (at 38 and 39) run
# 40-70 and 60-65 on card 1, so card 1 is busy 40-70
CARD1 = [
    ("cudaLaunchKernel", 38, 39, "cuda_runtime", 9),
    ("cudaLaunchKernel", 39, 40, "cuda_runtime", 10),
    ("k2", 40, 70, "kernel", 9, 1, 1, 1),
    ("k3", 60, 65, "kernel", 10, 1, 1, 1),
]


@pytest.mark.parametrize("cards", [2, 3])
def test_busy_time_is_each_cards(cards):
    """Each card's union on its own, the mean over the cell's cards, a card
    that ran nothing idle; operations counted on every card."""
    tr = tracing.reduce(_prof(_events(BASE + HDB + CARD1)), cards)
    assert tr.busy_s_by_card == [28e-9, 30e-9] + [0.0] * (cards - 2)
    assert tr.busy_s == pytest.approx(58e-9 / cards)
    assert tr.device_ops == 4
    # card 0's gaps: 0-35, 75-120, 50-62
    assert [g[1] for g in tr.idle_gaps] == [45e-9, 35e-9, 12e-9]
    cell = Cell("tpch.sf10.power")
    ctx = LayerContext(cell, [], tr, "cpu", {}, {})
    assert cell.metric_reader("device_idle_share").read(ctx) == \
        pytest.approx(1 - 58 / cards / 120)


def test_roofline_divides_by_the_cards_busy_seconds(monkeypatch):
    """The necessary bytes over the bandwidth times the sum of the cards'
    busy seconds: two cards busy 28 and 30 ns."""
    from portbench.harness import Done

    cell = Cell("tpch.sf10.power")
    tr = tracing.reduce(_prof(_events(BASE + HDB + CARD1)), 2)
    reader = cell.metric_reader("kernels_roofline")
    monkeypatch.setattr(reader, "hbm_bytes_per_s", lambda kind: 1e9)
    monkeypatch.setattr(reader, "column_bytes", lambda ctx, t: 50)
    ctx = LayerContext(cell, [Done("Q6", 0, 1, 8, None)], tr, "card", {}, {})
    assert reader.read(ctx) == pytest.approx(100.0 * 58 / 1e9 / 58e-9)


def test_span_readings_on_two_cards():
    """Idle time by span is each card's, averaged over the cards; device
    time by span each card's union, summed."""
    sp = S.reduce_spans(_prof(_events(BASE + HDB + CARD1)), 2)
    assert sp.busy == [[[35, 50], [62, 75]], [[40, 70]]]
    a = S.account(sp)
    ms = 1e-6
    # card 0 as on one card; card 1 idle 0-40 and 70-120
    assert a["busy_ms"] == pytest.approx(29 * ms)
    assert a["idle_ms"] == pytest.approx((92 + 90) / 2 * ms)
    # card 1: 20-40 and 70-80 in execute, 85-95 in egress
    assert a["executor_idle_ms"] == pytest.approx((42 + 40) / 2 * ms)
    # card 1: parse 0-10, plan 10-20, the root's own 80-82
    assert a["front_end_idle_ms"] == pytest.approx(22 * ms)
    assert a["outside_idle_ms"] == pytest.approx((28 + 28) / 2 * ms)
    assert a["front_end_idle_ms"] + a["executor_idle_ms"] + a["outside_idle_ms"] == \
        pytest.approx(a["idle_ms"])
    # card 0's 35-50 and card 1's 40-70, k3 inside it counted once
    assert a["join_device_ms"] == pytest.approx(45 * ms)
    assert a["by_span"]["join#"]["idle_ms"] == pytest.approx((15 + 10) / 2 * ms)
    assert a["by_span"]["execute"]["device_ms"] == pytest.approx(58 * ms)
    # a third card that ran nothing is idle all the window
    a3 = S.account(S.reduce_spans(_prof(_events(BASE + HDB + CARD1)), 3))
    assert a3["idle_ms"] == pytest.approx((92 + 90 + 120) / 3 * ms)
    assert a3["join_device_ms"] == a["join_device_ms"]


def _one_card(rows):
    """The readings as the reduction took them over the union of every
    device operation, whatever its card: on one card it must give them
    bit for bit."""
    sp = S.reduce_spans(_prof(_events(rows)))
    ops = [(r[2], r[3]) for r in sp.launches]
    busy = tracing._union(ops)
    idle = S._gaps(sp.window, busy)
    execu = S._intersect(idle, S._of(sp.spans, S.EXECUTOR.__contains__))
    front = S._intersect(idle, S._of(sp.spans, S.FRONT_END.__contains__))
    join = [(r[2], r[3]) for r in S._launched_in(sp, lambda s: s.startswith("join#"))]
    ms = 1e6 * len(sp.queries)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "busy_ms": S._len(busy) / ms,
        "idle_ms": S._len(idle) / ms,
        "front_end_idle_ms": (S._len(front) - S._len(S._intersect(front, execu))) / ms,
        "executor_idle_ms": S._len(execu) / ms,
        "outside_idle_ms": (S._len(idle) - S._len(S._intersect(idle, S._of(sp.spans, bool))))
        / ms,
        "join_device_ms": S._len(tracing._union(join)) / ms,
        "device_ops": len(ops),
    }


@pytest.mark.parametrize("extra", [[], [("cudaLaunchKernel", 38, 39, "cuda_runtime", 9),
                                        ("k2", 40, 70, "kernel", 9)]])
def test_one_card_reads_as_before(extra):
    """On events of one card every reading equals the single-union
    formulas exactly, the roofline's sum of busy seconds included."""
    rows = BASE + HDB + extra
    want = _one_card(rows)
    tr = tracing.reduce(_prof(_events(rows)))
    a = S.account(tr.spans)
    assert tr.busy_s == want["busy_s"] and tr.busy_s_by_card == [want["busy_s"]]
    assert sum(tr.busy_s_by_card) == tr.busy_s
    assert tr.device_ops == want["device_ops"]
    for k in ("busy_ms", "idle_ms", "front_end_idle_ms", "executor_idle_ms", "outside_idle_ms",
              "join_device_ms"):
        assert a[k] == want[k], k
