"""The port's server under concurrent sessions against the JAX package's.

Each test of tests/test_concurrency_stress.py runs its workload (threads of
mixed SELECT / INSERT / UPDATE / DELETE / CTAS / DDL over real sockets)
against a server of each package in this process (the port's on
device="cpu"): no deadlock, no error, the reference test's own checks on
both sides, and the final tables equal the reference's where the workload
determines them (tests/torch_server_pair.py)."""

import random
import threading
import time

from torch_server_pair import SIDES, connected, same, serving


def _run_threads(side, srv, fns, timeout=240):
    host, port = srv.server_address
    errors = []
    barrier = threading.Barrier(len(fns))

    def worker(fn):
        try:
            with side.client.Connection(host, port) as c:
                barrier.wait(timeout=30)
                fn(c)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(fn,), daemon=True) for fn in fns]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.1, deadline - time.monotonic()))
    alive = [t for t in threads if t.is_alive()]
    assert not alive, f"deadlock/timeout: {len(alive)} threads still running"
    assert not errors, errors[:3]


def _both(workload):
    """workload(side, srv) -> the final tables, against each package."""
    got = {}
    for side in SIDES:
        with serving(side) as srv:
            got[side.name] = workload(side, srv)
    assert same(got["port"], got["ref"]), (got["port"], got["ref"])


def _rows(c, q):
    return [tuple(r) for r in c.sql(q).rows()]


def _concurrent_inserts(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE ci (w INT, x INT)")
    n_threads, per = 8, 25

    def writer(tid):
        def go(c):
            for i in range(per):
                c.sql(f"INSERT INTO ci VALUES ({tid}, {i})")
        return go

    _run_threads(side, srv, [writer(t) for t in range(n_threads)])
    with connected(side, srv) as c:
        assert c.sql("SELECT count(*) FROM ci").rows()[0][0] == n_threads * per
        rows = _rows(c, "SELECT w, count(*) FROM ci GROUP BY w ORDER BY w")
        assert rows == [(t, per) for t in range(n_threads)]
        return [rows, _rows(c, "SELECT w, x FROM ci ORDER BY w, x")]


def test_concurrent_inserts_single_table():
    _both(_concurrent_inserts)


def _select_vs_updel(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE r_tab (k INT, v DOUBLE)")
        c.sql("CREATE TABLE w_tab (k INT, v DOUBLE)")
        for t in ("r_tab", "w_tab"):
            c.sql(f"INSERT INTO {t} VALUES " + ", ".join(f"({i % 10}, {i})" for i in range(100)))
    stop = threading.Event()

    def reader(c):
        while not stop.is_set():
            rows = c.sql("SELECT k, count(*) FROM r_tab GROUP BY k").rows()
            assert sum(r[1] for r in rows) == 100

    def mutator(c):
        try:
            for i in range(15):
                c.sql(f"UPDATE w_tab SET v = v + 1 WHERE k = {i % 10}")
                c.sql(f"DELETE FROM w_tab WHERE k = {i % 10} AND v < 0")
                c.sql(f"INSERT INTO w_tab VALUES ({i % 10}, {i})")
        finally:
            stop.set()

    _run_threads(side, srv, [reader, reader, mutator])
    with connected(side, srv) as c:
        return [_rows(c, f"SELECT k, v FROM {t} ORDER BY k, v") for t in ("r_tab", "w_tab")]


def test_select_vs_updel_different_tables():
    _both(_select_vs_updel)


def _mixed(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE mx_a (k INT, v DOUBLE, s TEXT)")
        c.sql("CREATE TABLE mx_b (k INT, v DOUBLE)")
        c.sql("INSERT INTO mx_a VALUES "
              + ", ".join(f"({i % 7}, {i}.5, 'tag{i % 3}')" for i in range(50)))
        c.sql("INSERT INTO mx_b VALUES " + ", ".join(f"({i % 7}, {i})" for i in range(50)))
    counters = [0] * 6

    def chaos(tid):
        rng = random.Random(tid)

        def go(c):
            for step in range(20):
                op = rng.randrange(6)
                counters[op] += 1
                if op == 0:
                    c.sql("SELECT k, count(*), sum(v) FROM mx_a GROUP BY k ORDER BY k").rows()
                elif op == 1:
                    c.sql("SELECT a.k, count(*) FROM mx_a a JOIN mx_b b "
                          "ON a.k = b.k GROUP BY a.k").rows()
                elif op == 2:
                    c.sql(f"INSERT INTO mx_b VALUES ({rng.randrange(7)}, {rng.random():.3f})")
                elif op == 3:
                    c.sql(f"UPDATE mx_a SET v = v + 1 WHERE k = {rng.randrange(7)}")
                elif op == 4:
                    c.sql(f"DELETE FROM mx_b WHERE v < {rng.random() * 0.05:.3f}")
                else:
                    name = f"priv_{tid}_{step}"
                    c.sql(f"CREATE TABLE {name} AS SELECT k, v FROM mx_a WHERE k < 3")
                    c.sql(f"DROP TABLE {name}")
        return go

    _run_threads(side, srv, [chaos(t) for t in range(6)])
    with connected(side, srv) as c:
        assert c.sql("SELECT count(*) FROM mx_a").rows()[0][0] == 50
        assert not [n for n in c.get_tables() if n.startswith("priv_")]
        # UPDATEs commute; a DELETE removes only rows under 0.05, which
        # only the order of the threads decides
        return [counters, sorted(c.get_tables()),
                _rows(c, "SELECT k, v, s FROM mx_a ORDER BY k, v, s"),
                _rows(c, "SELECT k, v FROM mx_b WHERE v >= 0.05 ORDER BY k, v")]


def test_mixed_select_insert_update_ddl():
    _both(_mixed)


def _ctas_itas(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE src (k INT, v DOUBLE)")
        c.sql("INSERT INTO src VALUES " + ", ".join(f"({i % 5}, {i})" for i in range(40)))
        c.sql("CREATE TABLE sink (k INT, v DOUBLE)")

    def ctas(tid):
        def go(c):
            for step in range(8):
                name = f"ct_{tid}_{step}"
                c.sql(f"CREATE TABLE {name} AS SELECT * FROM src")
                got = c.sql(f"SELECT count(*) FROM {name}").rows()[0][0]
                assert got == 40, f"CTAS snapshot lost rows: {got}"
                c.sql(f"DROP TABLE {name}")
        return go

    def itas(c):
        for _ in range(8):
            c.sql("INSERT INTO sink SELECT * FROM src WHERE k < 2")

    def selector(c):
        for _ in range(20):
            rows = c.sql("SELECT k, count(*) FROM src GROUP BY k ORDER BY k").rows()
            assert sum(r[1] for r in rows) == 40

    _run_threads(side, srv, [ctas(0), ctas(1), itas, selector])
    with connected(side, srv) as c:
        assert c.sql("SELECT count(*) FROM sink").rows()[0][0] == 8 * 16
        return [sorted(c.get_tables()),
                _rows(c, "SELECT k, count(*), sum(v) FROM sink GROUP BY k ORDER BY k")]


def test_ctas_itas_concurrency():
    _both(_ctas_itas)


def _admission(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE adm (k INT, v DOUBLE)")
        c.sql("INSERT INTO adm VALUES " + ", ".join(f"({i}, {i})" for i in range(200)))
        c.sql("ALTER SYSTEM SET max_exec_bytes = 4096")
        lone = _rows(c, "SELECT k, count(*) FROM adm GROUP BY k ORDER BY k")
        assert len(lone) == 200
        c.sql("ALTER SYSTEM SET max_exec_bytes = 0")
    with connected(side, srv) as c:
        c.sql("ALTER SYSTEM SET max_exec_bytes = 65536")
    results = []

    def q(c):
        for _ in range(5):
            results.append(sorted(_rows(c, "SELECT k, count(*), sum(v) FROM adm GROUP BY k")))

    _run_threads(side, srv, [q, q, q, q])
    with connected(side, srv) as c:
        c.sql("ALTER SYSTEM SET max_exec_bytes = 0")
        info = c.get_status().get("resource_pool") or {}
        assert info.get("total_timed_out", 0) == 0
        assert all(r == results[0] for r in results)
        return [lone, results[0], len(results),
                {k: info[k] for k in ("running", "queued", "max_bytes", "total_timed_out")}]


def test_admission_output_buffer_estimate():
    _both(_admission)
