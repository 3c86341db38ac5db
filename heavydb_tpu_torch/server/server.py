"""The server daemon — role of the reference's DBHandler + HeavyDB.cpp main:
sessions, statement routing, table-level write serialization, interrupt,
memory/status introspection — over the JSON-lines protocol.

The port of heavydb_tpu/server/server.py: the same RPCs, replies and wire
format, over the port's Database.  The server runs on CUDA unless it is
given device="cpu" (`--device cpu`); without a CUDA device and without a
device it raises, as `connect` does.  Each handler thread runs its
session's query with the executor's per-thread state (the interrupt hook,
the timer, the hints), so an interrupt stops only that session's query.

Usage:
    python -m heavydb_tpu_torch.server.server --port 6274 [--data /path] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import secrets
import socketserver
import threading
import time
from typing import Dict, Optional

try:  # import pyarrow BEFORE torch does heavy work: loading libarrow into
    # a process whose native thread pool is already hot intermittently
    # corrupted the heap of the JAX package's server (a flaky SIGSEGV
    # inside the first pa.array() of sql_execute_df; early import
    # eliminated it), and torch is such a runtime too
    import pyarrow  # noqa: F401
except Exception:  # pragma: no cover
    pass

import torch

from heavydb_tpu_torch import connect
from heavydb_tpu_torch.api import resolve_device
from heavydb_tpu_torch.errors import HeavyTpuError
from heavydb_tpu_torch.server import protocol as P
from heavydb_tpu_torch.version import __version__


class RWLock:
    """Writer-preferring shared/exclusive lock (reference
    LockMgr/LockMgrImpl.h read-write hierarchy: readers share a table,
    writers exclude readers AND each other; waiting writers block new
    readers so a write burst can't be starved)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class Session:
    def __init__(self, session_id: str, user: str):
        self.id = session_id
        self.user = user
        self.created = time.time()
        self.last_used = time.time()
        self.interrupted = False
        # the scope tree of the session's last SELECT (enable_debug_timer)
        self.timings: Optional[dict] = None


class HeavyTpuServer:
    def __init__(self, data_path: Optional[str] = None, config=None,
                 device=None):
        self.db = connect(data_path, config, device)
        self.sessions: Dict[str, Session] = {}
        # SHOW USER SESSIONS reads the live session table (reference
        # heavysql \\status / show_user_sessions)
        self.db.session_provider = lambda: [
            (sid, s.user, "-", int(time.time() - s.last_used))
            for sid, s in list(self.sessions.items())
        ]
        self.db.queries_provider = lambda: [
            (sid, "RUNNING", info["query"],
             int((time.time() - info["start"]) * 1000))
            for sid, info in list(self.running.items())
        ]

        def _kill(sid: str) -> bool:
            s_ = self.sessions.get(sid)
            if s_ is None:
                return False
            s_.interrupted = True
            return True

        self.db.kill_provider = _kill
        # table-level reader-writer locks (reference LockMgr/ read-write
        # hierarchy) acquired in sorted name order to avoid deadlock
        # (DBHandler.cpp:7173-7186); readers share, writers exclude, so a
        # concurrent reader can no longer observe a half-applied
        # multi-statement write sequence
        self.table_locks: Dict[str, RWLock] = {}
        self._table_locks_guard = threading.Lock()
        self.start_time = time.time()
        # in-flight queries per session (reference get_queries_info)
        self.running: Dict[str, dict] = {}

    def _sweep_sessions(self):
        """Idle/max-duration session eviction (reference
        Catalog/SessionsStore.cpp)."""
        cfg = self.db.config
        idle = getattr(cfg, "idle_session_duration_s", 0)
        dur = getattr(cfg, "max_session_duration_s", 0)
        if not idle and not dur:
            return
        now = time.time()
        dead = [
            sid for sid, s in self.sessions.items()
            if (idle and now - s.last_used > idle)
            or (dur and now - s.created > dur)
        ]
        for sid in dead:
            self.sessions.pop(sid, None)

    def _write_lock_keys(self, query: str):
        """AST-derived lock keys for a statement batch — the writer
        dispatch queue (reference QueryDispatchQueue.h:29 + LockMgr table
        locks).  Returns a sorted list of (KEY, MODE) pairs: table names
        for table-scoped writes ('w'), '#sys' for syscatalog mutations,
        '#catalog' only for statements whose targets genuinely can't be
        determined, and every referenced-but-unwritten table in shared
        mode ('r') so readers exclude concurrent writers without
        serializing each other.  Every statement CLASS is routed — the
        old regex fallback took the global lock whenever the text didn't
        match, serializing unrelated writers."""
        from heavydb_tpu_torch.sql import ast as A
        from heavydb_tpu_torch.sql.parser import parse_many

        READ_ONLY = (
            A.Select, A.Explain, A.ShowTables, A.ShowCreateTable,
            A.ShowTableDetails, A.ShowUserSessions, A.ShowQueries,
            A.ShowServers, A.ShowFunctions, A.ShowUsers, A.ShowRoles,
            A.ShowPolicies, A.DescribeTable, A.ValidateStmt, A.KillQuery,
            A.CopyTo,
        )
        SYS = (A.CreateUser, A.DropUser, A.AlterUser, A.CreateRole,
               A.DropRole, A.GrantStmt, A.CreatePolicy, A.DropPolicy,
               A.AlterSetting, A.CreateServer, A.DropServer)
        try:
            stmts = parse_many(query)
        except Exception:
            return [("#catalog", "w")]
        keys = set()
        reads = set()
        for st in stmts:
            reads.update(self._stmt_table_refs(st))
            if isinstance(st, READ_ONLY):
                continue
            if isinstance(st, SYS):
                keys.add("#sys")
            elif isinstance(st, (A.InsertValues, A.InsertSelect, A.Update,
                                 A.Delete, A.CopyFrom, A.AddColumn,
                                 A.DropColumn, A.RenameColumn,
                                 A.AlterColumnType, A.CommentOn)):
                keys.add(st.table.lower())
            elif isinstance(st, (A.CreateTable, A.DropTable, A.DumpTable,
                                 A.RestoreTable, A.TruncateTable,
                                 A.OptimizeTable, A.CreateView, A.DropView,
                                 A.CreateForeignTable)):
                keys.add(st.name.lower())
            elif isinstance(st, A.RenameTable):
                keys.add(st.old.lower())
                keys.add(st.new.lower())
            elif isinstance(st, A.RefreshForeignTables):
                keys.update(t.lower() for t in st.tables)
            else:
                keys.add("#catalog")  # unknown class: serialize
        # shared-mode keys: every referenced table not already being
        # written (reference LockMgr read locks — readers of a table
        # block concurrent writers of it, never each other)
        return sorted(
            [(k, "w") for k in keys]
            + [(k, "r") for k in reads - keys]
        )

    def _stmt_table_refs(self, st) -> set:
        """Every table NAME referenced anywhere in a statement — a
        generic dataclass walk collecting A.NamedTable nodes (FROM,
        joins, CTE bodies, subqueries in any clause).  CTE aliases may
        over-collect; a shared lock on a nonexistent name is harmless."""
        import dataclasses

        from heavydb_tpu_torch.sql import ast as A

        out = set()
        seen = set()

        def walk(x):
            if isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
                return
            if not dataclasses.is_dataclass(x) or isinstance(x, type):
                return
            if id(x) in seen:
                return
            seen.add(id(x))
            if isinstance(x, A.NamedTable):
                out.add(x.name.lower())
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name, None))

        walk(st)
        return out

    def _locks_for_keys(self, keys):
        """keys: sorted [(name, 'r'|'w')] → entered lock contexts."""
        with self._table_locks_guard:
            locks = [
                (self.table_locks.setdefault(k, RWLock()), mode)
                for k, mode in keys
            ]
        return [
            lk.write() if mode == "w" else lk.read() for lk, mode in locks
        ]

    # ---- dispatch ----
    def handle(self, msg: dict) -> dict:
        method = msg.get("method")
        params = msg.get("params", {})
        mid = msg.get("id")
        try:
            fn = getattr(self, "rpc_" + str(method), None)
            if fn is None:
                raise HeavyTpuError(f"unknown method {method!r}")
            result = fn(**params)
            return {"id": mid, "result": result}
        except Exception as e:  # noqa
            return {
                "id": mid,
                "error": {"type": type(e).__name__, "message": str(e)},
            }

    def _session(self, session: str) -> Session:
        self._sweep_sessions()
        s = self.sessions.get(session)
        if s is None:
            raise HeavyTpuError("invalid session")
        s.last_used = time.time()
        return s

    # ---- RPCs (reference heavy.thrift surface) ----
    def rpc_connect(self, user: str = "admin", password: str = "",
                    dbname: str = "heavyai") -> str:
        # authentication (reference SysCatalog::checkPasswordForUser); the
        # default admin password matches the reference's bootstrap value
        if not self.db.syscatalog.check_login(user, password):
            # allow passwordless admin for embedded/dev convenience
            if not (user == "admin" and password == ""):
                raise HeavyTpuError("invalid credentials")
        sid = secrets.token_hex(16)
        self.sessions[sid] = Session(sid, user)
        return sid

    def rpc_disconnect(self, session: str) -> bool:
        self.sessions.pop(session, None)
        return True

    def rpc_sql_execute(self, session: str, query: str) -> dict:
        s = self._session(session)
        s.interrupted = False
        self.db.executor.interrupt_check = lambda: s.interrupted
        t0 = time.time()
        self.running[s.id] = {"query": query, "start": t0}
        try:
            keys = self._write_lock_keys(query)
            if keys:
                with contextlib.ExitStack() as stack:
                    for lk in self._locks_for_keys(keys):
                        stack.enter_context(lk)
                    rs = self.db.sql(query, user=s.user)
            else:
                rs = self.db.sql(query, user=s.user)
        finally:
            self.running.pop(s.id, None)
        ms = (time.time() - t0) * 1e3
        if rs is None:
            return {"fields": [], "types": [], "columns": [],
                    "row_count": 0, "execution_time_ms": ms}
        out = P.encode_result(rs)
        out["execution_time_ms"] = ms
        # read once the columns are encoded: the tree holds their egress
        s.timings = rs.timings()
        return out

    def rpc_sql_execute_df(self, session: str, query: str) -> dict:
        """Arrow results over the wire (reference sql_execute_df,
        heavy.thrift): pyarrow IPC stream, base64."""
        import base64
        import io

        import pyarrow as pa

        s = self._session(session)
        s.interrupted = False
        t0 = time.time()
        rs = self.db.sql(query)
        tbl = rs.to_arrow()
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, tbl.schema) as w:
            w.write_table(tbl)
        return {
            "arrow_ipc": base64.b64encode(sink.getvalue()).decode(),
            "row_count": tbl.num_rows,
            "execution_time_ms": (time.time() - t0) * 1e3,
        }

    def rpc_get_queries_info(self, session: str) -> list:
        """Live queries (reference get_queries_info, heavy.thrift:717)."""
        self._session(session)
        out = []
        for sid, info in list(self.running.items()):
            out.append({
                "session": sid[:8],
                "query": info["query"][:200],
                "elapsed_ms": (time.time() - info["start"]) * 1e3,
            })
        return out

    def rpc_get_query_timings(self, session: str) -> dict:
        """Hierarchical timer tree of the session's LAST query (reference
        QueryState / DEBUG_TIMER stopAndGetJson, Logger.h:393-423), as
        `sql_execute` stored it, whatever thread serves this call.
        Requires enable_debug_timer (ALTER SESSION SET
        enable_debug_timer='true')."""
        return self._session(session).timings or {}

    def rpc_interrupt(self, session: str) -> bool:
        """reference Thrift `interrupt` (heavy.thrift:725)."""
        s = self.sessions.get(session)
        if s is not None:
            s.interrupted = True
        return True

    def rpc_get_tables(self, session: str) -> list:
        self._session(session)
        return self.db.catalog.list_tables()

    def rpc_get_table_details(self, session: str, table: str) -> dict:
        self._session(session)
        t = self.db.catalog.get_table(table)
        return {
            "name": t.name,
            "num_rows": t.num_rows,
            "fragment_rows": t.fragment_rows,
            "comment": getattr(t, "comment", None),
            "columns": [
                {"name": cd.name, "type": cd.type.sql_name(),
                 "nullable": cd.type.nullable,
                 "comment": getattr(cd, "comment", None)}
                for cd in t.columns
            ],
        }

    def rpc_load_table_binary_columnar(
        self, session: str, table: str, columns: dict
    ) -> int:
        """Bulk columnar load (reference load_table_binary_columnar)."""
        self._session(session)
        arrays = {k: P.decode_array(v) for k, v in columns.items()}
        with self._locks_for_keys([(table.lower(), "w")])[0]:
            self.db.load_table(table, arrays)
        return int(next(iter(arrays.values())).shape[0]) if arrays else 0

    def rpc_get_memory(self, session: str) -> dict:
        """reference get_memory (heavy.thrift:705)."""
        self._session(session)
        tables = {}
        for name in self.db.catalog.list_tables():
            t = self.db.catalog.get_table(name)
            nbytes = sum(
                c.nbytes for f in t.fragments for c in f.chunks.values()
            )
            tables[name] = {"rows": t.num_rows, "host_bytes": int(nbytes)}
        return {
            "tables": tables,
            "devices": [str(d) for d in self._devices()],
            "kernel_cache_entries": len(self.db.executor.kernel_cache),
            "scan_cache_entries": len(self.db.executor.scan_cache),
        }

    def rpc_get_status(self, session: str = "") -> dict:
        out = {
            "version": __version__,
            "uptime_s": time.time() - self.start_time,
            "sessions": len(self.sessions),
        }
        rm = self.db.executor.resource_mgr
        if rm is not None:
            # reference get_executor_resource_pool_info
            out["resource_pool"] = rm.info()
        return out

    def rpc_get_version(self) -> str:
        return __version__

    # ---- epoch / validation / metadata parity (heavy.thrift:698-716) ----

    def rpc_get_table_epoch(self, session: str, table: str) -> int:
        self._session(session)
        return self.db.get_table_epoch(table)

    def rpc_set_table_epoch(self, session: str, table: str,
                            epoch: int) -> bool:
        s = self._session(session)
        if s.user != "admin":
            raise HeavyTpuError("set_table_epoch requires admin")
        self.db.set_table_epoch(table, int(epoch))
        return True

    def rpc_sql_validate(self, session: str, query: str) -> dict:
        """Parse+bind without executing (reference sql_validate:
        returns the projected row descriptor)."""
        from heavydb_tpu_torch.plan.optimizer import optimize
        from heavydb_tpu_torch.sql import ast as A
        from heavydb_tpu_torch.sql.parser import parse_many

        self._session(session)
        stmts = parse_many(query)
        if len(stmts) != 1 or not isinstance(stmts[0], A.Select):
            raise HeavyTpuError("sql_validate expects a single SELECT")
        plan = optimize(self.db._plan_select(stmts[0]))
        return {
            "fields": list(plan.fields),
            "types": [t.sql_name() for t in plan.types],
        }

    def rpc_get_tables_meta(self, session: str) -> list:
        self._session(session)
        out = []
        for name in self.db.catalog.list_tables():
            t = self.db.catalog.get_table(name)
            out.append({
                "name": t.name,
                "num_rows": t.num_rows,
                "num_cols": len(t.columns),
                "fragments": len(t.fragments),
                "is_foreign": getattr(t, "foreign", None) is not None,
                "shard_key": getattr(t, "shard_key", None),
            })
        return out

    def rpc_detect_column_types(self, session: str, path: str,
                                options: Optional[dict] = None) -> list:
        self._session(session)
        from heavydb_tpu_torch.io.csv_import import detect_column_types

        return [
            {"name": n, "type": t.sql_name()}
            for n, t in detect_column_types(path, options or {})
        ]

    # ---- session / cluster info (heavy.thrift:686-716) ----

    def rpc_get_session_info(self, session: str) -> dict:
        s = self._session(session)
        return {
            "user": s.user,
            "database": "heavyai",
            "start_time": s.created,
            "is_super": s.user == "admin",
        }

    def rpc_clone_session(self, session: str) -> str:
        s = self._session(session)
        sid = secrets.token_hex(16)
        self.sessions[sid] = Session(sid, s.user)
        return sid

    def rpc_switch_database(self, session: str, dbname: str) -> bool:
        self._session(session)
        if dbname != "heavyai":
            raise HeavyTpuError(f"no database {dbname!r}")
        return True

    def rpc_get_hardware_info(self, session: str) -> dict:
        self._session(session)
        devs = self._devices()
        return {
            "num_gpus": len([d for d in devs if d.type != "cpu"]),
            "num_cpu_hw_threads": os.cpu_count(),
            "devices": [
                {"id": d.index or 0,
                 "platform": "cpu" if d.type == "cpu" else "gpu",
                 "kind": "cpu" if d.type == "cpu"
                 else torch.cuda.get_device_name(d)}
                for d in devs
            ],
        }

    def _devices(self) -> list:
        """The devices of the database's backend: every CUDA device for a
        database on CUDA, the CPU for one on the CPU."""
        if self.db.device.type == "cpu":
            return [torch.device("cpu")]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    def rpc_get_users(self, session: str) -> list:
        self._session(session)
        return self.db.syscatalog.list_users()

    def rpc_get_roles(self, session: str) -> list:
        self._session(session)
        return self.db.syscatalog.list_roles()

    def rpc_get_all_roles_for_user(self, session: str, user: str) -> list:
        self._session(session)
        return sorted(self.db.syscatalog.roles_of(user))

    def rpc_get_completion_hints(self, session: str, sql: str,
                                 cursor: int = -1) -> list:
        """Table/column/keyword completions for the token at `cursor`
        (reference get_completion_hints / CalciteServerHandler)."""
        self._session(session)
        frag = sql[:cursor] if 0 <= cursor <= len(sql) else sql
        word = ""
        for ch in reversed(frag):
            if ch.isalnum() or ch == "_":
                word = ch + word
            else:
                break
        wl = word.lower()
        hints = []
        for name in self.db.catalog.list_tables():
            if name.lower().startswith(wl):
                hints.append({"hint": name, "type": "TABLE"})
            t = self.db.catalog.get_table(name)
            for cd in t.columns:
                if wl and cd.name.lower().startswith(wl):
                    hints.append({"hint": cd.name, "type": "COLUMN"})
        for kw in ("SELECT", "FROM", "WHERE", "GROUP", "ORDER", "BY",
                   "LIMIT", "JOIN", "LEFT", "INNER", "ON", "HAVING",
                   "UNION", "INSERT", "UPDATE", "DELETE"):
            if wl and kw.lower().startswith(wl):
                hints.append({"hint": kw, "type": "KEYWORD"})
        return hints[:50]

    # ---- dashboards (heavy.thrift:739-752 TDashboard CRUD) ----

    def rpc_get_dashboards(self, session: str) -> list:
        self._session(session)
        return [
            {k: v for k, v in d.items() if k != "state"}
            for d in self.db.dashboards.values()
        ]

    def rpc_get_dashboard(self, session: str, dashboard_id: int) -> dict:
        self._session(session)
        d = self.db.dashboards.get(int(dashboard_id))
        if d is None:
            raise HeavyTpuError(f"no dashboard {dashboard_id}")
        return dict(d)

    def rpc_create_dashboard(self, session: str, name: str,
                             state: str = "", metadata: str = "") -> int:
        s = self._session(session)
        return self.db.create_dashboard(name, state, metadata, s.user)

    def rpc_replace_dashboard(self, session: str, dashboard_id: int,
                              name: str, state: str = "",
                              metadata: str = "") -> bool:
        s = self._session(session)
        self.db.replace_dashboard(
            int(dashboard_id), name, state, metadata, s.user
        )
        return True

    def rpc_delete_dashboard(self, session: str, dashboard_id: int) -> bool:
        self._session(session)
        self.db.delete_dashboard(int(dashboard_id))
        return True


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            try:
                msg = P.read_message(self.rfile)
            except Exception:
                break
            if msg is None:
                break
            resp = self.server.engine.handle(msg)
            try:
                self.wfile.write(P.dumps(resp))
                self.wfile.flush()
            except BrokenPipeError:
                break


class _ThreadedServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve(host: str = "127.0.0.1", port: int = 6274,
          data_path: Optional[str] = None, config=None,
          warmup_file: Optional[str] = None, device=None):
    engine = HeavyTpuServer(data_path, config, device)
    if warmup_file:
        # reference run_warmup_queries (HeavyDB.cpp:627): pre-compile the
        # common kernel shapes at startup so first client queries are warm
        # (with the persistent compile cache this is a one-time cost ever)
        try:
            with open(warmup_file) as f:
                for line in f:
                    q = line.strip().rstrip(";")
                    if not q or q.startswith("--"):
                        continue
                    try:
                        engine.db.sql(q)
                    except Exception as e:  # warmup is best-effort
                        print(f"warmup {q[:60]!r}: {e!r}", flush=True)
        except OSError as e:
            print(f"warmup file unreadable: {e!r}", flush=True)
    # scheduled foreign-table refresh (reference ForeignStorage scheduled
    # refresh thread; tables opt in with REFRESH_TIMING_TYPE='SCHEDULED')
    engine.db.refresh_scheduler.start()
    srv = _ThreadedServer((host, port), _Handler)
    srv.engine = engine
    return srv


def device_or_exit(device):
    """The device a command line asked for (CUDA by default), or exit
    non-zero with `resolve_device`'s message: never the CPU unasked."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def main():
    ap = argparse.ArgumentParser(description="heavydb_tpu_torch server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6274)
    ap.add_argument("--data", default=None, help="persistent data directory")
    ap.add_argument("--warmup-file", default=None,
                    help="SQL file executed at startup to pre-compile "
                         "kernels (reference run_warmup_queries)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    args = ap.parse_args()
    srv = serve(args.host, args.port, args.data,
                warmup_file=args.warmup_file,
                device=device_or_exit(args.device))
    print(f"heavydb_tpu_torch server {__version__} listening on "
          f"{args.host}:{args.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
