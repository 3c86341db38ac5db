"""The port's server, HTTP server and CLI against the JAX package's.

Every test of tests/test_server.py and tests/test_privileges.py's
test_server_auth runs its RPC sequence against a server of each package in
this process (heavydb_tpu.server.server.serve on the conftest's JAX CPU,
heavydb_tpu_torch.server.server.serve with device="cpu") and holds the
port's replies to the reference's: the same results, rows and errors, with
execution times, session ids, uptimes and device lists compared by their
keys and types only (tests/torch_server_pair.py).  The reference test's
own assertions hold on both sides.  Then the port's own: either package's
client talks to either package's server; the statement classes the lock
router names each take the reference's lock keys; the CLI prints what the
reference's prints and runs in a process that loads no jax; and no entry
point falls back to the CPU without a CUDA device.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_server_pair import (PORT, REF, SIDES, connected, norm, recorded, same, serving,
                               start, stop)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sql(c, *queries):
    return [recorded(c, "sql_execute", session=c.session, query=q) for q in queries]


def _both(scenario, **kw):
    """scenario(side, srv) against a server of each package: the port's
    replies are the reference's."""
    got = {}
    for side in SIDES:
        with serving(side, **kw) as srv:
            got[side.name] = scenario(side, srv)
    assert same(got["port"], got["ref"]), (got["port"], got["ref"])
    return got["port"]


# ---------------------------------------------------------------------------
# tests/test_server.py: RPC sequences over one connection
# ---------------------------------------------------------------------------


def _roundtrip(side, srv):
    with connected(side, srv) as c:
        out = _sql(c, "CREATE TABLE t (x INT, s TEXT)",
                   "INSERT INTO t VALUES (1, 'a'), (2, 'b'), (NULL, NULL)")
        rs = c.sql("SELECT s, count(*) FROM t GROUP BY s ORDER BY s NULLS LAST")
        assert [tuple(r) for r in rs.rows()] == [("a", 1), ("b", 1), (None, 1)]
        assert rs.execution_time_ms is not None
        return out + [rs.fields, rs.types, rs.columns, rs.row_count]


def _metadata(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE m (x INT, v DOUBLE)")
        assert "m" in c.get_tables()
        det = c.get_table_details("m")
        assert det["columns"][0]["name"] == "x"
        mem = c.get_memory()
        assert "m" in mem["tables"]
        assert c.get_status()["sessions"] >= 1
        return [c.get_tables(), det, norm(mem["tables"]), sorted(mem),
                norm(c.get_status())]


def _binary_load(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE big (k INT, v DOUBLE)")
        n = 10_000
        rng = np.random.default_rng(0)
        loaded = c.load_table("big", {"k": rng.integers(0, 5, n), "v": rng.normal(size=n)})
        assert loaded == n
        assert c.sql("SELECT count(*) FROM big").scalar() == n
        assert c.sql("SELECT count(DISTINCT k) FROM big").scalar() == 5
        return [loaded] + _sql(c, "SELECT k, count(*), sum(v) FROM big GROUP BY k ORDER BY k")


def _errors_propagate(side, srv):
    with connected(side, srv) as c:
        out = []
        for q, kind in (("SELECT * FROM nope", "CatalogError"), ("FROB", "ParserError")):
            with pytest.raises(side.client.ServerError) as ei:
                c.sql(q)
            assert ei.value.type == kind
            out.append((ei.value.type, str(ei.value)))
        return out


def _two_sessions(side, srv):
    with connected(side, srv) as a, connected(side, srv) as b:
        a.sql("CREATE TABLE shared (x INT)")
        a.sql("INSERT INTO shared VALUES (1)")
        assert b.sql("SELECT count(*) FROM shared").scalar() == 1
        assert a.session != b.session
        return [b.sql("SELECT count(*) FROM shared").scalar(), len(a.session),
                len(b.session)]


def _dates_over_wire(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE d (dt DATE, ts TIMESTAMP, t TIME, f FLOAT, g DOUBLE)")
        c.sql("INSERT INTO d VALUES ('2024-03-01', '2024-03-01 12:30:00', '08:15:30', "
              "'NaN', 2.5), (NULL, NULL, NULL, NULL, 'NaN')")
        rows = c.sql("SELECT dt, ts FROM d WHERE dt IS NOT NULL").rows()
        assert list(rows[0]) == ["2024-03-01", "2024-03-01 12:30:00"]
        return _sql(c, "SELECT dt, ts, t, f, g FROM d ORDER BY dt NULLS LAST")


def _arrow_over_wire(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE arr (x INT, s TEXT)")
        c.sql("INSERT INTO arr VALUES (1, 'a'), (2, NULL)")
        tbl = c.sql_df("SELECT * FROM arr ORDER BY x")
        assert tbl.num_rows == 2
        assert tbl.column("s").to_pylist() == ["a", None]
        return [tbl.schema.names, [str(t) for t in tbl.schema.types], tbl.to_pylist()]


def _queries_info_empty_when_idle(side, srv):
    with connected(side, srv) as c:
        assert c.get_queries_info() == []
        return [c.get_queries_info()]


def _session_and_cluster_info(side, srv):
    with connected(side, srv) as conn:
        s = conn.session
        info = conn.call("get_session_info", session=s)
        assert info["user"] == "admin" and info["database"] == "heavyai"
        sid2 = conn.call("clone_session", session=s)
        assert sid2 != s
        assert conn.call("get_session_info", session=sid2)["user"] == "admin"
        assert conn.call("switch_database", session=s, dbname="heavyai") is True
        nope = recorded(conn, "switch_database", session=s, dbname="nope")
        assert nope[0] == "error"
        hw = conn.call("get_hardware_info", session=s)
        assert hw["num_cpu_hw_threads"] >= 1 and len(hw["devices"]) >= 1
        assert "admin" in conn.call("get_users", session=s)
        conn.sql("CREATE USER bob (password='pw')")
        conn.sql("CREATE ROLE analyst")
        conn.sql("GRANT analyst TO bob")
        assert "analyst" in conn.call("get_roles", session=s)
        assert conn.call("get_all_roles_for_user", session=s, user="bob") == ["analyst"]
        return [norm(info), len(sid2), nope, norm(hw), conn.call("get_users", session=s),
                conn.call("get_roles", session=s),
                conn.call("get_all_roles_for_user", session=s, user="bob")]


def _completion_hints(side, srv):
    with connected(side, srv) as conn:
        conn.sql("CREATE TABLE flights (carrier TEXT, delay INT)")
        out = []
        for sql, cursor, want in (("SELECT car", 10, {"hint": "carrier", "type": "COLUMN"}),
                                  ("SELECT * FROM fli", 18, {"hint": "flights", "type": "TABLE"}),
                                  ("SELECT * FROM t WHE", 19, {"hint": "WHERE", "type": "KEYWORD"})):
            hints = conn.call("get_completion_hints", session=conn.session, sql=sql,
                              cursor=cursor)
            assert want in hints
            out.append(hints)
        return out


def _dashboard_crud(side, srv):
    with connected(side, srv) as conn:
        s = conn.session
        did = conn.call("create_dashboard", session=s, name="sales", state="eyJ2IjoxfQ==",
                        metadata="{}")
        assert did == 1
        boards = conn.call("get_dashboards", session=s)
        assert len(boards) == 1 and boards[0]["name"] == "sales"
        assert "state" not in boards[0]
        d = conn.call("get_dashboard", session=s, dashboard_id=did)
        assert d["state"] == "eyJ2IjoxfQ=="
        out = [did, norm(boards), norm(d)]
        conn.call("replace_dashboard", session=s, dashboard_id=did, name="sales2",
                  state="e30=", metadata="{}")
        d = conn.call("get_dashboard", session=s, dashboard_id=did)
        assert d["name"] == "sales2" and d["state"] == "e30="
        conn.call("delete_dashboard", session=s, dashboard_id=did)
        assert conn.call("get_dashboards", session=s) == []
        gone = recorded(conn, "get_dashboard", session=s, dashboard_id=did)
        assert gone[0] == "error"
        return out + [norm(d), gone]


def _query_timings_rpc(side, srv):
    with connected(side, srv) as conn:
        conn.call("sql_execute", session=conn.session,
                  query="ALTER SESSION SET enable_debug_timer='true'")
        conn.call("sql_execute", session=conn.session, query="SELECT 1+1")
        tree = conn.call("get_query_timings", session=conn.session)
        assert tree.get("name") == "query"
        names = [c["name"] for c in tree.get("children", [])]
        assert "plan" in names and "execute" in names
        if side.name == "port":
            # the port's tree adds the text's parse before and the result's
            # egress after the reference's scopes
            assert names[0] == "parse" and names[-1] == "egress"
            names = names[1:-1]
        return [tree["name"], names]


RPC_SEQUENCES = {
    "roundtrip": _roundtrip, "metadata": _metadata, "binary_load": _binary_load,
    "errors_propagate": _errors_propagate, "two_sessions": _two_sessions,
    "dates_over_wire": _dates_over_wire, "arrow_over_wire": _arrow_over_wire,
    "queries_info_empty_when_idle": _queries_info_empty_when_idle,
    "session_and_cluster_info_rpcs": _session_and_cluster_info,
    "completion_hints": _completion_hints, "dashboard_crud": _dashboard_crud,
    "query_timings_rpc": _query_timings_rpc,
}


@pytest.mark.parametrize("name", list(RPC_SEQUENCES))
def test_rpc_sequence(name):
    _both(RPC_SEQUENCES[name])


def test_server_device_lists():
    """get_memory and get_hardware_info list the port's devices under the
    reference's keys: the CPU for a database on the CPU."""
    with serving(PORT) as srv, connected(PORT, srv) as c:
        assert c.get_memory()["devices"] == ["cpu"]
        hw = c.call("get_hardware_info", session=c.session)
        assert hw["num_gpus"] == 0
        assert hw["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu"}]


# ---------------------------------------------------------------------------
# tests/test_server.py: HTTP, the engine's own methods, warm-up, locks
# ---------------------------------------------------------------------------


def _post(base, path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http(side):
    srv = start(side.serve_http(port=0))
    host, port = srv.server_address
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(f"{base}/status") as r:
            st = json.loads(r.read())
        assert "version" in st
        code, out = _post(base, "/", {"method": "connect", "params": {}, "id": 1})
        assert code == 200
        sid = out["result"]
        replies = [norm(st), code, sorted(out)]
        for q in ("CREATE TABLE h (x INT)", "INSERT INTO h VALUES (1), (2), (41)",
                  "SELECT SUM(x) FROM h"):
            code, res = _post(base, "/sql", {"session": sid, "query": q})
            assert code == 200
            replies.append((code, norm(res)))
        assert res["columns"] == [[44]]
        code, res = _post(base, "/sql", {"session": "nope", "query": "SELECT 1"})
        assert code == 400
        with pytest.raises(urllib.error.HTTPError) as missing:
            urllib.request.urlopen(f"{base}/nope")
        return replies + [(code, res), missing.value.code]
    finally:
        stop(srv)


def test_http_server():
    got = {side.name: _http(side) for side in SIDES}
    assert got["port"] == got["ref"]


def _idle_eviction(side):
    srv = side.HeavyTpuServer(config=side.Config(idle_session_duration_s=1))
    sid = srv.rpc_connect()
    first = norm(srv.rpc_sql_execute(sid, "SHOW TABLES"))
    srv.sessions[sid].last_used -= 5  # simulate idleness
    sid2 = srv.rpc_connect()  # triggers the sweep
    with pytest.raises(side.errors.HeavyTpuError) as ei:
        srv.rpc_sql_execute(sid, "SHOW TABLES")
    return [first, str(ei.value), norm(srv.rpc_sql_execute(sid2, "SHOW TABLES")),
            len(srv.sessions)]


def test_session_idle_eviction():
    got = {side.name: _idle_eviction(side) for side in SIDES}
    assert got["port"] == got["ref"]


def _disjoint_locks(side):
    srv = side.HeavyTpuServer()
    sid = srv.rpc_connect()
    srv.rpc_sql_execute(sid, "CREATE TABLE wa (x INT)")
    srv.rpc_sql_execute(sid, "CREATE TABLE wb (x INT)")
    ka = srv._write_lock_keys("INSERT INTO wa VALUES (1)")
    kb = srv._write_lock_keys("INSERT INTO wb VALUES (1)")
    srv._locks_for_keys(ka), srv._locks_for_keys(kb)
    assert ka == [("wa", "w")] and kb == [("wb", "w")]
    assert srv.table_locks["wa"] is not srv.table_locks["wb"]
    assert srv._write_lock_keys("INSERT INTO wa VALUES (2)") == ka
    keys = [srv._write_lock_keys(q) for q in (
        "SELECT * FROM wa", "COMMENT ON TABLE wa IS 'x'",
        "ALTER TABLE wa ALTER COLUMN x TYPE BIGINT", "OPTIMIZE TABLE wa",
        "CREATE USER zz (password='p')", "INSERT INTO wa SELECT x FROM wb")]
    assert keys == [[("wa", "r")], [("wa", "w")], [("wa", "w")], [("wa", "w")],
                    [("#sys", "w")], [("wa", "w"), ("wb", "r")]]
    errs = []

    def w(tname):
        try:
            for i in range(5):
                srv.rpc_sql_execute(sid, f"INSERT INTO {tname} VALUES ({i})")
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=w, args=(t,)) for t in ("wa", "wb")]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert not errs
    counts = [srv.rpc_sql_execute(sid, f"SELECT count(*), sum(x) FROM {t}")["columns"]
              for t in ("wa", "wb")]
    assert counts[0][0][0] == 5
    return [ka, kb, keys, counts]


def test_table_level_write_locks_allow_disjoint_tables():
    got = {side.name: _disjoint_locks(side) for side in SIDES}
    assert got["port"] == got["ref"]


# one statement of every class the lock router names: its class and its keys
LOCK_CASES = [
    ('SELECT * FROM a JOIN b ON a.x = b.x',
     'Select', [('a', 'r'), ('b', 'r')]),
    ('EXPLAIN SELECT * FROM a',
     'Explain', [('a', 'r')]),
    ('SHOW TABLES',
     'ShowTables', []),
    ('SHOW CREATE TABLE a',
     'ShowCreateTable', []),
    ('SHOW TABLE DETAILS a',
     'ShowTableDetails', []),
    ('SHOW USER SESSIONS',
     'ShowUserSessions', []),
    ('SHOW QUERIES',
     'ShowQueries', []),
    ('SHOW SERVERS',
     'ShowServers', []),
    ('SHOW FUNCTIONS',
     'ShowFunctions', []),
    ('SHOW USERS',
     'ShowUsers', []),
    ('SHOW ROLES',
     'ShowRoles', []),
    ('SHOW POLICIES a',
     'ShowPolicies', []),
    ('DESCRIBE a',
     'DescribeTable', []),
    ('VALIDATE',
     'ValidateStmt', []),
    ("KILL QUERY 'abc'",
     'KillQuery', []),
    ("COPY (SELECT x FROM a) TO '/tmp/x.csv'",
     'CopyTo', [('a', 'r')]),
    ("CREATE USER u1 (password='p')",
     'CreateUser', [('#sys', 'w')]),
    ('DROP USER u1',
     'DropUser', [('#sys', 'w')]),
    ("ALTER USER u1 (password='q')",
     'AlterUser', [('#sys', 'w')]),
    ('CREATE ROLE r1',
     'CreateRole', [('#sys', 'w')]),
    ('DROP ROLE r1',
     'DropRole', [('#sys', 'w')]),
    ('GRANT SELECT ON TABLE a TO u1',
     'GrantStmt', [('#sys', 'w')]),
    ('CREATE POLICY ON COLUMN a.x TO u1 VALUES (1)',
     'CreatePolicy', [('#sys', 'w')]),
    ('DROP POLICY ON COLUMN a.x FROM u1',
     'DropPolicy', [('#sys', 'w')]),
    ('ALTER SYSTEM SET max_exec_bytes = 0',
     'AlterSetting', [('#sys', 'w')]),
    ("CREATE SERVER s1 FOREIGN DATA WRAPPER delimited_file WITH (storage_type='LOCAL_FILE')",
     'CreateServer', [('#sys', 'w')]),
    ('DROP SERVER s1',
     'DropServer', [('#sys', 'w')]),
    ('INSERT INTO a VALUES (1)',
     'InsertValues', [('a', 'w')]),
    ('INSERT INTO a SELECT x FROM b',
     'InsertSelect', [('a', 'w'), ('b', 'r')]),
    ('UPDATE a SET x = 1 WHERE x IN (SELECT x FROM b)',
     'Update', [('a', 'w'), ('b', 'r')]),
    ('DELETE FROM a WHERE x = 1',
     'Delete', [('a', 'w')]),
    ("COPY a FROM '/tmp/x.csv'",
     'CopyFrom', [('a', 'w')]),
    ('ALTER TABLE a ADD COLUMN y INT',
     'AddColumn', [('a', 'w')]),
    ('ALTER TABLE a DROP COLUMN y',
     'DropColumn', [('a', 'w')]),
    ('ALTER TABLE a RENAME COLUMN x TO y',
     'RenameColumn', [('a', 'w')]),
    ('ALTER TABLE a ALTER COLUMN x TYPE BIGINT',
     'AlterColumnType', [('a', 'w')]),
    ("COMMENT ON TABLE a IS 'x'",
     'CommentOn', [('a', 'w')]),
    ('CREATE TABLE c (x INT)',
     'CreateTable', [('c', 'w')]),
    ('CREATE TABLE c AS SELECT x FROM a',
     'CreateTable', [('a', 'r'), ('c', 'w')]),
    ('DROP TABLE a',
     'DropTable', [('a', 'w')]),
    ("DUMP TABLE a TO '/tmp/a.tgz'",
     'DumpTable', [('a', 'w')]),
    ("RESTORE TABLE a FROM '/tmp/a.tgz'",
     'RestoreTable', [('a', 'w')]),
    ('TRUNCATE TABLE a',
     'TruncateTable', [('a', 'w')]),
    ('OPTIMIZE TABLE a',
     'OptimizeTable', [('a', 'w')]),
    ('CREATE VIEW v AS SELECT x FROM a',
     'CreateView', [('a', 'r'), ('v', 'w')]),
    ('DROP VIEW v',
     'DropView', [('v', 'w')]),
    ("CREATE FOREIGN TABLE f (x INT) SERVER default_local_delimited WITH (file_path='/tmp/x.csv')",
     'CreateForeignTable', [('f', 'w')]),
    ('ALTER TABLE a RENAME TO b2',
     'RenameTable', [('a', 'w'), ('b2', 'w')]),
    ('REFRESH FOREIGN TABLES f, g',
     'RefreshForeignTables', [('f', 'w'), ('g', 'w')]),
    ('SELEKT nonsense',
     'ParserError', [('#catalog', 'w')]),
]

@pytest.mark.parametrize("query,cls,keys", LOCK_CASES, ids=[c for _, c, _ in LOCK_CASES])
def test_lock_keys_of_each_statement_class(query, cls, keys):
    """Each statement class the router names parses in the port to that
    class, and takes the reference's lock keys, those listed (a class
    missing from the port, or renamed, would take '#catalog')."""
    from heavydb_tpu.sql.parser import parse_many as jparse
    from heavydb_tpu_torch.sql.parser import parse_many as tparse

    for parse in (jparse, tparse):
        try:
            got_cls = type(parse(query)[0]).__name__
        except Exception as e:  # noqa: BLE001 - the unparsable statement
            got_cls = type(e).__name__
        assert got_cls == cls
    got = [side.server.HeavyTpuServer._write_lock_keys(
        object.__new__(side.server.HeavyTpuServer), query) for side in SIDES]
    assert got[1] == got[0] == keys


def _epoch_validate_meta(side, path):
    srv = side.HeavyTpuServer(path)
    sid = srv.rpc_connect()
    srv.rpc_sql_execute(sid, "CREATE TABLE et (x INT, s TEXT)")
    srv.rpc_sql_execute(sid, "INSERT INTO et VALUES (1, 'a')")
    e1 = srv.rpc_get_table_epoch(sid, "et")
    srv.rpc_sql_execute(sid, "INSERT INTO et VALUES (2, 'b')")
    e2 = srv.rpc_get_table_epoch(sid, "et")
    assert e2 > e1
    srv.rpc_set_table_epoch(sid, "et", e1)
    n = srv.rpc_sql_execute(sid, "SELECT count(*) FROM et")["columns"][0][0]
    assert n == 1
    v = srv.rpc_sql_validate(sid, "SELECT x + 1 AS y, s FROM et")
    assert v["fields"] == ["y", "s"]
    assert v["types"][0] in ("INT", "INTEGER", "BIGINT")
    meta = srv.rpc_get_tables_meta(sid)
    assert any(m["name"] == "et" and m["num_cols"] == 2 for m in meta)
    with pytest.raises(Exception) as ei:
        srv.rpc_sql_validate(sid, "SELECT nope FROM et")
    with pytest.raises(side.errors.HeavyTpuError) as ei2:
        srv.rpc_sql_validate(sid, "INSERT INTO et VALUES (3, 'c')")
    return [e1, e2, n, v, meta, type(ei.value).__name__, str(ei.value), str(ei2.value)]


def test_epoch_validate_meta_rpcs(tmp_path):
    got = {side.name: _epoch_validate_meta(side, str(tmp_path / side.name))
           for side in SIDES}
    assert got["port"] == got["ref"]


def _warmup(side, wf):
    srv = side.serve(port=0, warmup_file=str(wf))
    try:
        sid = srv.engine.rpc_connect()
        out = srv.engine.rpc_sql_execute(sid, "SELECT sum(x) FROM wtab")
        assert out["columns"][0][0] == 3
        return norm(out)
    finally:
        srv.server_close()
        srv.engine.db.refresh_scheduler.stop()


def test_warmup_file(tmp_path, capsys):
    wf = tmp_path / "warm.sql"
    wf.write_text(
        "CREATE TABLE wtab (x INT);\n"
        "INSERT INTO wtab VALUES (1), (2);\n"
        "-- comment line\n"
        "SELECT count(*) FROM wtab;\n"
        "SELECT broken syntax here;\n"  # best-effort: must not abort startup
    )
    got = {}
    for side in SIDES:
        got[side.name] = _warmup(side, wf)
        got[side.name + " printed"] = capsys.readouterr().out
    assert got["port"] == got["ref"]
    assert got["port printed"] == got["ref printed"] != ""


def _reader_writer(side, srv):
    host, port = srv.server_address
    with connected(side, srv) as c:
        c.sql("CREATE TABLE rw (x INT)")
        c.sql("INSERT INTO rw VALUES (1), (2), (3), (4)")
    errors, seen = [], []
    stop_ = threading.Event()

    def writer():
        try:
            with side.client.Connection(host, port) as cw:
                for _ in range(12):
                    cw.sql("DELETE FROM rw WHERE x > 0; INSERT INTO rw VALUES (1), (2), (3), (4)")
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop_.set()

    def reader():
        try:
            with side.client.Connection(host, port) as cr:
                while not stop_.is_set():
                    n = cr.sql("SELECT count(*) FROM rw").rows()[0][0]
                    seen.append(n)
                    if n != 4:
                        errors.append(AssertionError(f"saw count {n}"))
                        return
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader)
                                                   for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert seen
    with connected(side, srv) as c:
        return [sorted(set(seen))] + _sql(c, "SELECT x FROM rw ORDER BY x")


def test_reader_writer_isolation():
    _both(_reader_writer)


def _readers_share(side, srv):
    with connected(side, srv) as c:
        c.sql("CREATE TABLE rr (x INT)")
        c.sql("INSERT INTO rr VALUES (1), (2)")
    inside = []
    gate = threading.Barrier(3, timeout=60)
    lock = srv.engine.table_locks.setdefault("rr", side.server.RWLock())

    def reader():
        with lock.read():
            inside.append(1)
            gate.wait()  # all three must be inside simultaneously

    ts = [threading.Thread(target=reader) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert len(inside) == 3
    return [len(inside)]


def test_readers_do_not_serialize_each_other():
    _both(_readers_share)


# ---------------------------------------------------------------------------
# tests/test_privileges.py::test_server_auth
# ---------------------------------------------------------------------------


def _server_auth(side, srv):
    pdb = srv.engine.db
    for q in ("CREATE TABLE t (x INT)", "INSERT INTO t VALUES (1)",
              "CREATE USER alice (password='secret')", "CREATE ROLE readers"):
        pdb.sql(q)
    host, port = srv.server_address
    with pytest.raises(side.client.ServerError) as bad:
        side.client.Connection(host, port, user="alice", password="wrong")
    with side.client.Connection(host, port, user="alice", password="secret") as c:
        denied = recorded(c, "sql_execute", session=c.session, query="SELECT count(*) FROM t")
        assert denied[0] == "error"
        pdb.sql("GRANT SELECT ON TABLE t TO alice")
        assert c.sql("SELECT count(*) FROM t").scalar() == 1
        with pytest.raises(side.client.ServerError) as drop:
            c.sql("DROP TABLE t")
        return [(bad.value.type, str(bad.value)), denied, (drop.value.type, str(drop.value))]


def test_server_auth():
    _both(_server_auth)


# ---------------------------------------------------------------------------
# either client against either server
# ---------------------------------------------------------------------------


def _wire_session(client, srv):
    host, port = srv.server_address
    rng = np.random.default_rng(18)
    out = []
    with client.Connection(host, port) as c:
        c.sql("CREATE TABLE w (d DATE, ts TIMESTAMP, x INT, s TEXT, v DOUBLE)")
        c.sql("INSERT INTO w VALUES ('2024-03-01', '2024-03-01 12:30:00', 1, 'a', 1.5), "
              "(NULL, NULL, NULL, NULL, NULL), ('1999-12-31', '2000-01-01 00:00:01', 3, 'c', "
              "'NaN')")
        rs = c.sql("SELECT d, ts, x, s, v FROM w ORDER BY x NULLS FIRST")
        out.append((rs.fields, rs.types, rs.columns, rs.row_count))
        c.sql("CREATE TABLE wl (k INT, v DOUBLE)")
        n = 2000
        out.append(c.load_table("wl", {"k": rng.integers(0, 7, n).astype(np.int32),
                                       "v": rng.normal(size=n)}))
        out.append(c.sql("SELECT k, COUNT(*), SUM(v) FROM wl GROUP BY k ORDER BY k").rows())
        with pytest.raises(client.ServerError) as ei:
            c.sql("SELECT nope FROM w")
        out.append((ei.value.type, str(ei.value)))
        tbl = c.sql_df("SELECT x, s, d FROM w ORDER BY x NULLS FIRST")
        out.append((tbl.schema.names, tbl.to_pylist()))
    return out


@pytest.mark.parametrize("client_side,server_side", [(REF, PORT), (PORT, REF)],
                         ids=["ref client to port server", "port client to ref server"])
def test_wire_compatibility(client_side, server_side):
    """A client of one package against a server of the other gives what a
    client of the server's own package gets."""
    with serving(server_side) as srv:
        crossed = _wire_session(client_side.client, srv)
    with serving(server_side) as srv:
        own = _wire_session(server_side.client, srv)
    assert same(crossed, own), (crossed, own)


def test_protocol_bytes_are_the_references():
    """The port's protocol module writes the reference's bytes."""
    import datetime as dt

    from heavydb_tpu.server import protocol as jp
    from heavydb_tpu_torch.server import protocol as tp

    msg = {"id": 3, "method": "sql_execute", "params": {"session": "s", "query": "SELECT 1"}}
    assert tp.dumps(msg) == jp.dumps(msg)
    for v in (dt.date(2024, 3, 1), dt.datetime(2024, 3, 1, 12, 30), dt.time(8, 15, 30),
              float("nan"), 1.5, "x", None, 7):
        assert tp.encode_value(v) == jp.encode_value(v)
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert tp.encode_array(a) == jp.encode_array(a)
    np.testing.assert_array_equal(tp.decode_array(jp.encode_array(a)), a)


# ---------------------------------------------------------------------------
# the CLI, and no entry point falls back to the CPU
# ---------------------------------------------------------------------------

CLI_STATEMENTS = [
    "CREATE TABLE c (x INT, s TEXT, v DOUBLE, d DATE)",
    "INSERT INTO c VALUES (1, 'a', 1.25, '2024-03-01'), (2, NULL, 1e10, NULL), (3, 'c', NULL, "
    "'1999-12-31')",
    "SELECT * FROM c ORDER BY x",
    "SELECT s, COUNT(*), SUM(v) FROM c GROUP BY s ORDER BY s NULLS LAST",
    "SHOW TABLES",
]


def _shell_output(side, capsys, **kw):
    import argparse

    args = argparse.Namespace(connect=None, data=None, command=None, **kw)
    sh = side.cli.Shell(args)
    sh.timing = False
    for q in CLI_STATEMENTS:
        sh.run_sql(q)
    sh.backslash("\\t")
    sh.backslash("\\d c")
    return capsys.readouterr().out


def test_cli_prints_the_references_output(capsys):
    want = _shell_output(REF, capsys)
    got = _shell_output(PORT, capsys, device="cpu")
    assert got == want
    assert "x | s    | v     | d" in got


def test_cli_runs_alone_on_the_cpu():
    """`python -m heavydb_tpu_torch.cli --device cpu -c ...` exits 0 with
    the row, and no module of jax or heavydb_tpu is imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-X", "importtime", "-m", "heavydb_tpu_torch.cli",
                          "--device", "cpu", "-c", "SELECT 1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[2].strip() == "1"
    imported = [ln.split("|")[-1].strip() for ln in out.stderr.splitlines()
                if ln.startswith("import time:")]
    assert "heavydb_tpu_torch.api" in imported
    bad = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "heavydb_tpu")]
    assert not bad, bad


def test_no_entry_point_falls_back_to_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from heavydb_tpu_torch.server import http_server, server

    for make in (server.HeavyTpuServer, lambda: server.serve(port=0),
                 lambda: http_server.serve_http(port=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for main, argv in ((server.main, ["server"]), (http_server.main, ["http_server"]),
                       (PORT.cli.main, ["cli", "-c", "SELECT 1"])):
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(SystemExit) as ei:
            main()
        assert "device='cpu'" in str(ei.value.code)
    assert capsys.readouterr().out == ""


def test_server_main_on_the_cpu():
    """`python -m heavydb_tpu_torch.server.server --device cpu` serves; a
    reference client talks to it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "heavydb_tpu_torch.server.server",
                             "--port", str(port), "--device", "cpu"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, line
        deadline = time.monotonic() + 60
        while True:
            try:
                c = REF.client.Connection("127.0.0.1", port)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        with c:
            assert c.sql("SELECT 41 + 1").scalar() == 42
            assert c.call("get_hardware_info", session=c.session)["devices"][0]["platform"] \
                == "cpu"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
