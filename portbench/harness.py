"""One run of one cell: make the tables from the seed, warm the cell's
templates, drive the traffic for the window, make the tables again from the
seed once the port is gone, check a sample of the answers against the plain
reference over them, and report.  A configuration's `shards` is the port's
`Config(num_shards=...)`, one card a shard: the run's cell has as many
chips, and each reading of the device covers all of them.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`run()` does the work and returns the result line as a dict; `main()` (in
run.py) adds the checks that a card is there and that nothing of JAX was
loaded.  Tests call `run()` with device="cpu" and a small scale.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from portbench import params as P
from portbench.compare import Dec, Reading, compare
from portbench.spec import Cell

# draws per template run once, one after another, before the window
WARM_DRAWS = 2
# queries each client runs concurrently after those, still before the window
WARM_CONCURRENT = 4
# the longest traced window: a profiler's record of a longer one takes
# minutes to reduce
TRACE_WINDOW_S = 10
# streams of the seed's generator
STREAM_WARM, STREAM_SAMPLE, STREAM_CLIENT = 1, 2, 1000
# modules whose presence in the process is a fault: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "heavydb_tpu")


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class Traffic:
    """The query stream of one client: templates drawn uniformly by weight,
    or a fresh permutation of them for each pass; parameters drawn for each
    query."""

    def __init__(self, cell: Cell, seed: int, stream: int):
        self.mix = cell.mix
        self.templates = cell.templates
        self.rng = rng(seed, stream)
        self.names = list(self.mix["templates"])
        w = np.array([float(self.mix["templates"][n]) for n in self.names])
        self.weights = w / w.sum()
        self.queue = []

    def next(self):
        if self.mix["order"] == "permutation":
            if not self.queue:
                self.queue = [self.names[i] for i in self.rng.permutation(len(self.names))]
            name = self.queue.pop(0)
        else:
            name = self.names[int(self.rng.choice(len(self.names), p=self.weights))]
        tpl = self.templates[name]
        p = P.draw(tpl.PARAMS, self.rng)
        return name, p, tpl.SQL.format(**p)


def fetch(rs) -> tuple:
    """Every column of a ResultSet on the host: raw numbers, DECIMAL as Dec,
    TEXT decoded.  Returns (columns, bytes of the raw columns)."""
    cols, nbytes = [], 0
    for i, t in enumerate(rs.types):
        raw = rs.column_raw(i)
        nbytes += raw.nbytes
        if t.is_string:
            cols.append(rs.column(i))
        elif t.is_decimal:
            cols.append(Dec(raw, t.scale))
        else:
            cols.append(raw)
    return cols, nbytes


@dataclass
class Done:
    template: str
    t_issue: float
    t_done: float
    result_bytes: int
    plan_ms: float | None


@dataclass
class Recorder:
    """What the clients did: every query's times, failures, and a sample of
    the answers per template (a reservoir drawn from the seed)."""
    per_template: int
    sample_rng: np.random.Generator
    done: list = field(default_factory=list)
    failed: list = field(default_factory=list)
    seen: dict = field(default_factory=dict)
    sample: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, d: Done, params: dict, cols: list) -> None:
        with self.lock:
            self.done.append(d)
            n = self.seen[d.template] = self.seen.get(d.template, 0) + 1
            box = self.sample.setdefault(d.template, [])
            if len(box) < self.per_template:
                box.append((params, cols))
            else:
                j = int(self.sample_rng.integers(0, n))
                if j < self.per_template:
                    box[j] = (params, cols)

    def fail(self, template: str, t_issue: float, err: BaseException) -> None:
        with self.lock:
            self.failed.append((template, t_issue, f"{type(err).__name__}: {err}"))


def _plan_ms(db):
    t = db.last_query_timings
    if not t:
        return None
    return next((c["ms"] for c in t.get("children", []) if c["name"] == "plan"), None)


def run_query(db, sql: str, timed: bool):
    rs = db.sql(sql)
    cols, nbytes = fetch(rs)
    return cols, nbytes, (_plan_ms(db) if timed else None)


def _client(db, traffic, rec, start, deadline, label, timed):
    while time.perf_counter() < start:
        time.sleep(0.0005)
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            return
        name, p, sql = traffic.next()
        with label(name):
            try:
                cols, nbytes, plan = run_query(db, sql, timed)
            except Exception as e:  # a query that fails is counted, not fatal
                rec.fail(name, t0, e)
                continue
        rec.record(Done(name, t0, time.perf_counter(), nbytes, plan), p, cols)


def drive(db, cell, seed, seconds, rec, label, timed) -> tuple:
    """Run the cell's clients in a closed loop for `seconds`; returns the
    window's (start, end) on the host clock."""
    if cell.mix["loop"] != "closed":
        raise ValueError(f"{cell.name}: only a closed loop is driven, not {cell.mix['loop']!r}")
    clients = int(cell.mix["clients"])
    start = time.perf_counter() + 0.01
    deadline = start + seconds
    threads = [threading.Thread(
        target=_client, args=(db, Traffic(cell, seed, STREAM_CLIENT + k), rec, start,
                              deadline, label, timed), daemon=True)
        for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return start, deadline


def warm(db, cell, seed) -> None:
    """Every template WARM_DRAWS times, one after another, then
    WARM_CONCURRENT queries a client with every client running."""
    traffic = Traffic(cell, seed, STREAM_WARM)
    for name, tpl in cell.templates.items():
        for _ in range(WARM_DRAWS):
            run_query(db, tpl.SQL.format(**P.draw(tpl.PARAMS, traffic.rng)), False)
    clients = int(cell.mix["clients"])
    if clients > 1:
        def go(k):
            t = Traffic(cell, seed, STREAM_WARM + 10 + k)
            for _ in range(WARM_CONCURRENT):
                run_query(db, t.next()[2], False)

        threads = [threading.Thread(target=go, args=(k,)) for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()


def load_tables(db, tables: dict) -> None:
    for name, tab in tables.items():
        db.sql(tab["ddl"])
        db.load_table_device(name, tab["columns"], dicts=tab.get("dicts"))


def check(cell, tables, rec, ctx) -> dict:
    """The sampled answers against the reference: the checks, each with its
    value and limit."""
    total = Reading()
    for name, box in rec.sample.items():
        tpl = cell.templates[name]
        for params, cols in box:
            want = tpl.reference(tables, params, ctx)
            total.add(compare(cols, want, getattr(tpl, "FLOAT", ()),
                              getattr(tpl, "ORDERED", False)))
    unchecked = [n for n in cell.templates if not rec.sample.get(n)]
    return {
        "failed": {"value": len(rec.failed), "limit": 0},
        "unchecked_templates": {"value": len(unchecked), "limit": 0},
        **reading_checks(cell, total),
        "values_checked": {"value": total.values, "limit": None},
    }


def reading_checks(cell, total: Reading) -> dict:
    """The compared numbers of a Reading with their limits; the relative
    error only where a template of the mix has FLOAT columns."""
    out = {"mismatched_values": {"value": total.mismatched, "limit": 0}}
    if any(getattr(t, "FLOAT", ()) for t in cell.templates.values()):
        out["float_rel_err"] = {"value": total.rel_err,
                                "limit": cell.mix["limits"]["float_rel_err"]}
    return out


def e2e_metrics(cell, rec, start, end, setup_s) -> dict:
    inside = [d for d in rec.done if start <= d.t_done <= end]
    lat = [(d.t_done - d.t_issue) * 1e3 for d in inside]
    means = [m for _, m in template_stats(rec, start, end).values()]
    values = {
        "qps": len(inside) / (end - start),
        "p95_ms": float(np.percentile(lat, 95)) if lat else None,
        "geomean_ms": math.exp(sum(math.log(m) for m in means) / len(means)) if means else None,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


def template_stats(rec, start, end) -> dict:
    """Each template's count and mean latency (ms) in the window."""
    by = {}
    for d in rec.done:
        if start <= d.t_done <= end:
            by.setdefault(d.template, []).append((d.t_done - d.t_issue) * 1e3)
    return {k: [len(v), sum(v) / len(v)] for k, v in sorted(by.items())}


@dataclass
class LayerContext:
    """What a per-layer metric's reader sees: the traced window's queries
    (host clock) and the reduction of the profiler's trace."""
    cell: Cell
    queries: list
    trace: object
    kind: str
    table_rows: dict   # table -> rows
    widths: dict       # table -> column -> bytes a value


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        scale: float = 1.0, t0: float | None = None) -> dict:
    """One run of `workload`; returns the result line as a dict.  `scale`
    multiplies the configuration's sizes (1 on the card; tests use less)."""
    t_run = time.perf_counter()
    t0 = t_run if t0 is None else t0
    import torch

    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config
    from portbench.refkit import Ctx

    cell = Cell(workload)
    # the cards the run reads: cuda:0 .. cuda:{chips-1}, the Database's card
    # and the port's mesh (`Executor._make_mesh`); none on the CPU
    cards = ([torch.device("cuda", i) for i in range(cell.chips)]
             if torch.device(device).type == "cuda" else [])
    timed = trace and any(m["name"] == "plan_ms" for m in cell.per_layer)
    # start_s: from the interpreter's start to here, torch's import and
    # run.py's look for a card among it; import_s: the port's import
    parts = {"start_s": t_run - t0, "import_s": time.perf_counter() - t_run}

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    def part(name, t):
        sync()
        parts[name] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    db = hdt.connect(device=device, config=Config(enable_debug_timer=timed,
                                                  num_shards=cell.shards))
    t = part("connect_s", t)
    home = db.device
    tables = cell.generator.make(cell.config, seed, scale, home)
    t = part("make_s", t)
    load_tables(db, tables)
    # the window holds no copy of the tables but the port's: the check
    # makes them again from the seed once the Database is gone
    table_rows = {n: int(next(iter(tab["columns"].values())).shape[0])
                  for n, tab in tables.items()}
    widths = {n: {c: a.element_size() for c, a in tab["columns"].items()}
              for n, tab in tables.items()}
    del tables
    t = part("load_s", t)
    warm(db, cell, seed)
    part("warm_s", t)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    setup_s = time.perf_counter() - t0
    print("setup " + " ".join(f"{k}={v:.3f}" for k, v in parts.items()), file=sys.stderr,
          flush=True)

    rec = Recorder(int(cell.mix["sample_per_template"]), rng(seed, STREAM_SAMPLE))
    window = min(seconds, TRACE_WINDOW_S) if trace else seconds
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import tracing

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
        with profile(activities=acts, experimental_config=tracing.all_threads()) as prof:
            with record_function(tracing.WINDOW_RANGE):
                start, end = drive(db, cell, seed, window, rec,
                                   lambda n: record_function(tracing.QUERY_PREFIX + n), timed)
                sync()
        tr = tracing.reduce(prof, cell.chips)
        del prof
    else:
        start, end = drive(db, cell, seed, window, rec,
                           lambda n: contextlib.nullcontext(), timed)
    sync()
    peaks = [int(torch.cuda.max_memory_allocated(c)) for c in cards]
    kind = torch.cuda.get_device_name(cards[0]) if cards else "cpu"
    attempted = sum(1 for d in rec.done if start <= d.t_done <= end) + len(rec.failed)

    # the program's state goes before the reference runs
    del db
    gc.collect()
    if cards:
        torch.cuda.empty_cache()

    if trace:
        inside = [d for d in rec.done if start <= d.t_done <= end]
        ctx = LayerContext(cell, inside, tr, kind, table_rows, widths)
        metrics = {}
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = e2e_metrics(cell, rec, start, end, setup_s)

    # the same seed makes the same tables (the generators draw from one
    # torch.Generator seeded with it), on the card the port held them on
    tables = cell.generator.make(cell.config, seed, scale, home)
    checks = check(cell, tables, rec, Ctx(home))
    correct = all(c["limit"] is None or c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": len(rec.failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if cards else "cpu", "kind": kind,
                      "count": cell.chips, "memory_peak_bytes": max(peaks, default=0),
                      "memory_peak_bytes_by_card": peaks}}
    if trace:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["busy_s_by_card"] = tr.busy_s_by_card
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops, "idle_gaps": tr.idle_gaps}
    out["setup_parts"] = parts
    out["templates"] = template_stats(rec, start, end)
    if rec.failed:
        out["failures"] = [list(f) for f in rec.failed[:5]]
    out["checks"] = checks
    return out
