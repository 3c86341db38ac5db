"""Public in-process engine API of the PyTorch port.

Port of heavydb_tpu/api.py for this slice: `connect`, `Database.sql`
(SELECT, CREATE TABLE and CREATE TABLE AS SELECT, INSERT VALUES and INSERT
... SELECT, UPDATE, DELETE, TRUNCATE, DROP TABLE), `sql_device`,
`load_table` and `load_table_device`, `register_llm_transform`,
`register_udf` (scalar UDFs over torch tensors), `register_table_function`
and the built-in table functions of `_register_system_tfs` (generate_series,
the regressions, kmeans, PCA, dwell times and the tree fits of
ops/ml.py, numpy on the host as in the reference), plus `load_state`,
which rebuilds a set of tables from their definitions and physical host
columns.

Every Database carries one explicit torch device.  `connect()` takes CUDA
unless the caller passes `device="cpu"`; without CUDA and without a device
it raises.  On CUDA it builds and checks the group-by kernels first
(kernels/gate.py).

UPDATE and DELETE run as the reference runs them: `SELECT rowid, values
... WHERE cond` through the executor (so chunk-stat fragment skipping
stays live and only the matched rows reach the host), then a patch of the
fragments that hold those rows (`Table.update_rows_at` /
`delete_rows_at`), then a move of the resident device columns to the new
generation (`Executor.patch_cache_update` / `patch_cache_delete`).

Array and geo columns take literals in INSERT VALUES ({...}, ARRAY[...],
WKT), per-row lists in `load_table`, and the rows of a query in CTAS and
INSERT ... SELECT; a result's array or geo column comes back as its
rows' host payloads (`_fix_array_cols`).  UPDATE of an array or geo
column raises NotSupported, as in the reference.

The in-memory SQL surface of the reference: EXPLAIN, EXPLAIN CALCITE and
EXPLAIN OPTIMIZED (the plan, then the root Compound's program as the port
runs it: tier, each aggregate's kernel route, join builds, kernel-cache
key); ALTER SESSION / SYSTEM SET of the settable flags; RENAME TABLE, ADD /
DROP / RENAME COLUMN, ALTER COLUMN TYPE, OPTIMIZE TABLE, COMMENT ON,
CREATE / DROP VIEW, VALIDATE; SHOW TABLES / CREATE TABLE / TABLE DETAILS /
FUNCTIONS, DESCRIBE; users, roles, GRANT / REVOKE and row-level policies
(storage/syscatalog.py; `sql(text, user=...)` checks privileges and puts
the user's policy filters into the plan before it is optimized); SHOW
QUERIES, KILL QUERY and SHOW USER SESSIONS over the providers the port's
server installs (server/server.py `HeavyTpuServer`: its sessions, their
running queries, and an interrupt of a session's query).  Query hints reach the executor (the watchdogs, a time limit,
`keep_result`: the result recycler, keyed by the scanned tables'
generations); `enable_debug_timer` fills the calling thread's
`last_query_timings`.  `load_table`
uploads a table of `eager_staging_min_rows` rows or more at once when
`eager_device_staging` says so (None: on CUDA).

Storage and import, as the reference's: `connect(path)` opens a database
on disk (storage/persist.py: epochs, manifests, chunk encoders; the
catalog, users and servers in catalog.json), `checkpoint`, after every
statement that is not a SELECT or EXPLAIN, and `get_table_epoch` /
`set_table_epoch` (a rollback reloads the table and drops its device state
of the old generation); DUMP / RESTORE TABLE (a tar.gz of one table's
store); COPY FROM (CSV through the native parser or pandas, parquet,
GeoJSON, rasters) and COPY TO (CSV, parquet); `stream_importer`
(io/stream.py); foreign servers and tables (delimited, parquet, regex and
DB-API sources, S3 through an installed transport), read lazily at their
first scan and again at REFRESH FOREIGN TABLES or by `refresh_scheduler`.
Every one of them is host code: the device sees a new generation of the
table, uploaded at its next scan.
"""

from __future__ import annotations

import json
import logging
import os
import tarfile
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.errors import (BinderError, CatalogError, NotSupported, SqlError,
                                      StorageError)
from heavydb_tpu_torch.exec import batch as B
from heavydb_tpu_torch.exec.executor import Executor, _iter_node_exprs
from heavydb_tpu_torch.exec.result_set import ResultSet, from_batch
from heavydb_tpu_torch.kernels import launch_counts
from heavydb_tpu_torch.ops.groupby import torch_dtype
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.plan.builder import ExprBinder, Scope, _const_cast, resolve_type_name
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.plan.select_planner import SelectPlanner, _node_dict_ref
from heavydb_tpu_torch.sql import ast as A
from heavydb_tpu_torch.sql.parser import parse_many
from heavydb_tpu_torch.storage.catalog import Catalog
from heavydb_tpu_torch.storage.persist import (PersistentCatalogStore, TableStore, _type_from_json,
                                               _type_to_json)
from heavydb_tpu_torch.storage.syscatalog import SysCatalog
from heavydb_tpu_torch.storage.table import (ChunkStats, ColumnDescriptor, LazyDeviceChunk, Table,
                                             from_physical, to_physical)
from heavydb_tpu_torch.utils.timer import NULL_TIMER, QueryTimer


def resolve_device(device=None) -> torch.device:
    """The device a Database runs on: `device` if given, else CUDA.  Never
    falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "heavydb_tpu_torch.connect(): no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def connect(path: Optional[str] = None, config: Optional[Config] = None,
            device=None) -> "Database":
    """connect() -> in-memory engine on CUDA; connect('/data/dir') -> a
    database on disk with epoch checkpoints; connect(device="cpu") runs the
    same engine on the CPU with the kernels' plain versions."""
    return Database(config or Config(), resolve_device(device), path)


class Database:
    def __init__(self, config: Config, device: torch.device,
                 path: Optional[str] = None):
        self.config = config
        self.device = device
        if device.type == "cuda":
            from heavydb_tpu_torch.kernels.gate import kernel_gate

            kernel_gate(device)
        self.catalog = Catalog(config)
        self.executor = Executor(self)
        # users, roles, privileges and row-level policies; the user of the
        # statement each thread runs (None: the embedded superuser)
        self.syscatalog = SysCatalog()
        self._user_tls = threading.local()
        # the result recycler: (plan key, scanned tables' generations) ->
        # ResultSet, for queries with the keep_result hint
        self._result_cache: Dict[tuple, ResultSet] = {}
        # each thread's last SELECT's timer (`last`) and the `parse` node
        # its text's first SELECT takes (enable_debug_timer)
        self._timings = threading.local()
        self._views: Dict[str, A.Select] = {}
        self._transient_dicts: Dict[int, object] = {}
        self._transient_by_key: Dict[tuple, tuple] = {}
        self._next_transient = 0
        # scalar UDFs: name -> (fn, arg_types, ret_type), fn over torch tensors
        self._udfs: Dict[str, tuple] = {}
        # table functions: name -> fn(*args, cursor=...) -> dict of numpy
        # columns; the fitted ML models by name
        self._table_functions: Dict[str, object] = {}
        self._ml_models: Dict[str, object] = {}
        _register_system_tfs(self._table_functions, self)
        # the last UPDATE / DELETE: its matched rows and touched fragments
        self.last_mutation: Optional[dict] = None
        # foreign servers, with the reference's defaults
        self._servers: Dict[str, dict] = {
            "default_local_delimited": {"wrapper": "delimited_file", "options": {}},
            "default_local_parquet": {"wrapper": "parquet_file", "options": {}},
            "default_local_regex_parsed": {"wrapper": "regex_parser", "options": {}},
        }
        self.path = path
        self._catalog_store = None
        self._table_stores: Dict[int, object] = {}
        self._persisted_gen: Dict[int, int] = {}
        if path is not None:
            self._catalog_store = PersistentCatalogStore(path)
            sc_data = self._catalog_store.load_syscatalog()
            if sc_data:
                self.syscatalog = SysCatalog.from_json(sc_data)
            for n, srv in (self._catalog_store.load_servers() or {}).items():
                self._servers.setdefault(n, {"wrapper": srv["wrapper"],
                                             "options": dict(srv.get("options", {}))})
            for t in self._catalog_store.load(self.catalog):
                store = TableStore(path, getattr(t, "disk_table_id", t.table_id))
                self._table_stores[t.table_id] = store
                store.load_into(t)
                self._persisted_gen[t.table_id] = t.generation

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _persist_after_statement(self) -> None:
        """Write the catalog, and checkpoint every table whose generation
        changed since its last checkpoint (only its dirty chunks); remove
        the stores of dropped tables.  Nothing for an in-memory database."""
        if self._catalog_store is None:
            return
        self._catalog_store.save(self.catalog, self.syscatalog, servers=self._servers)
        live_ids = set()
        for name in self.catalog.list_tables():
            t = self.catalog.get_table(name)
            live_ids.add(t.table_id)
            if getattr(t, "foreign", None) is not None:
                continue  # a foreign table's data lives in its source
            store = self._table_stores.get(t.table_id)
            if store is None:
                store = TableStore(self.path, getattr(t, "disk_table_id", t.table_id))
                self._table_stores[t.table_id] = store
            if self._persisted_gen.get(t.table_id) != t.generation:
                store.checkpoint(t)
                self._persisted_gen[t.table_id] = t.generation
        for tid in list(self._table_stores):
            if tid not in live_ids:
                self._table_stores.pop(tid).destroy()
                self._persisted_gen.pop(tid, None)

    def checkpoint(self) -> None:
        """Checkpoint every table now (reference DataMgr::checkpoint)."""
        self._persist_after_statement()

    def get_table_epoch(self, name: str) -> int:
        t = self.catalog.get_table(name)
        store = self._table_stores.get(t.table_id)
        return store.committed_epoch() if store else 0

    def set_table_epoch(self, name: str, epoch: int) -> None:
        """Roll a table back (or forward) to a committed epoch (reference
        set_table_epoch).  The table reloads from disk at a new generation;
        its device columns, aux tables, kernels and recycled results of the
        old one are dropped."""
        t = self.catalog.get_table(name)
        store = self._table_stores.get(t.table_id)
        if store is None:
            raise CatalogError(f"table {name!r} is not persistent")
        store.set_epoch(epoch)
        store.load_into(t)
        self._persisted_gen[t.table_id] = t.generation
        self.executor.forget_table(t.table_id)
        self._drop_stale()

    @property
    def refresh_scheduler(self):
        """Scheduled foreign-table refresh (storage/refresh.py): poll() in
        embedded use, start() for the background thread."""
        if getattr(self, "_refresh_scheduler", None) is None:
            from heavydb_tpu_torch.storage.refresh import RefreshScheduler

            self._refresh_scheduler = RefreshScheduler(self)
        return self._refresh_scheduler

    def stream_importer(self, table_name: str, **kw):
        """Batched streaming ingest into a table (io/stream.py): feed it
        rows or lines, or run() it over a source (FileTailSource, the
        KafkaSource adapter).  Each batch goes through `load_table`."""
        from heavydb_tpu_torch.io.stream import StreamImporter

        return StreamImporter(self, table_name, **kw)

    # ------------------------------------------------------------------
    # public
    # ------------------------------------------------------------------
    def sql(self, text: str, user: Optional[str] = None) -> Optional[ResultSet]:
        """Execute SQL text (the last statement's result is returned).
        `user` turns on privilege checks and that user's row-level
        policies; None is the embedded superuser."""
        out = None
        self._user_tls.user = user
        try:
            for st in self._parse(text):
                if user is not None:
                    self.syscatalog.check_statement(user, st, _stmt_tables(st))
                # a statement runs with no hints and no timer but its own
                self.executor.exec_hints = {}
                self.executor.timer = NULL_TIMER
                out = self._execute_statement(st)
                if not isinstance(st, (A.Select, A.Explain)):
                    self._persist_after_statement()
                    self._drop_stale()
        finally:
            self._user_tls.user = None
            self._timings.parse = None
        return out

    def _parse(self, text: str) -> list:
        """parse_many(text) inside the `parse` scope.  With the debug timer
        on, its node becomes the first child of the text's first SELECT's
        `query` root (`_run_select`)."""
        timer = QueryTimer() if self.config.enable_debug_timer else NULL_TIMER
        with timer.scope("parse"):
            stmts = parse_many(text)
        self._timings.parse = timer.root
        return stmts

    @property
    def last_query_timings(self) -> Optional[dict]:
        """The scope tree of the calling thread's last SELECT
        (enable_debug_timer), read now: after its columns reached the host
        it holds their `egress`.  None with the timer off, or after a
        recycled result."""
        timer = getattr(self._timings, "last", None)
        return timer.to_dict() if timer is not None else None

    def sql_device(self, text: str):
        """Execute a SELECT and return the device-resident result Batch plus
        a decode callback — separates device compute from result egress.
        The SELECT's hints reach the executor as in `sql`."""
        with NULL_TIMER.scope("parse"):
            stmts = parse_many(text)
        if len(stmts) != 1 or not isinstance(stmts[0], A.Select):
            raise SqlError("sql_device takes exactly one SELECT")
        plan = optimize(self._plan_select(stmts[0]))
        self.executor.exec_hints = stmts[0].hints or {}
        self.executor.timer = NULL_TIMER
        batch = self.executor.execute(plan)

        def decode() -> ResultSet:
            return self._fix_array_cols(from_batch(batch, plan.fields, plan.types,
                                                   self._result_dicts(plan)), plan)

        return batch, decode

    def load_table(self, name: str, data, create: bool = False):
        """Bulk-load a dict of numpy arrays (or a pandas DataFrame)."""
        cols = _normalize_tabular(data)
        if create and self.catalog.get_table_opt(name) is None:
            self.catalog.create_table(
                name, [(c, _infer_type(a)) for c, a in cols.items()])
        self._insert_columns(self.catalog.get_table(name), cols)

    def _insert_columns(self, t: Table, cols: Dict[str, np.ndarray]) -> None:
        """Append host columns by name (load_table, the GeoJSON and raster
        imports), then drop stale device state and prestage the table."""
        _reject_foreign_write(t)
        arrays = {}
        for cd in t.columns:
            key = next((k for k in cols if k.lower() == cd.name.lower()), None)
            if key is None:
                raise StorageError(f"missing column {cd.name}")
            arrays[cd.col_id] = to_physical(cols[key], cd.type,
                                            t.dicts.get(cd.col_id))
        t.insert_columns(arrays)
        self._drop_stale()
        self._maybe_prestage(t)

    def _maybe_prestage(self, t) -> None:
        """Upload a freshly loaded table's columns now (`prestage_table`)
        when `eager_device_staging` is on (None: on a CUDA device) and the
        table holds `eager_staging_min_rows` rows or more."""
        cfg = self.config
        on = cfg.eager_device_staging
        if on is None:
            on = self.device.type == "cuda"
        if on and t.num_rows >= cfg.eager_staging_min_rows:
            with self.executor.timer.scope("eager_stage"):
                self.executor.prestage_table(t)

    def _drop_stale(self) -> None:
        """After a statement that may change a table: the executor's stale
        device state (`Executor.drop_stale`), and the recycled results of
        tables that are gone or have a new generation."""
        self.executor.drop_stale()

        def live(tid, gen):
            t = self.catalog._by_id.get(tid)
            return t is not None and t.generation == gen

        for key in [k for k in self._result_cache
                    if not all(live(tid, gen) for tid, gen in k[1])]:
            del self._result_cache[key]

    def warmup(self, queries) -> None:
        """Run each query once to fill the kernel and aux caches before
        serving, its result discarded (the reference's --warmup-queries-file).
        A failing query is skipped: a warmup must not block readiness."""
        for q in queries:
            try:
                rs = self.sql(q)
                if rs is not None:
                    rs.row_count
            except Exception:  # noqa: BLE001 - readiness goes on without it
                logging.getLogger(__name__).warning("warmup query failed: %s", q,
                                                    exc_info=True)

    def table_rows(self, name: str) -> int:
        return self.catalog.get_table(name).num_rows

    # -- dashboards (the reference's Catalog dashboards, TDashboard CRUD) --
    @property
    def dashboards(self) -> Dict[int, dict]:
        if getattr(self, "_dashboards", None) is None:
            self._dashboards = {}
            self._next_dashboard_id = 1
        return self._dashboards

    def create_dashboard(self, name: str, state: str = "", metadata: str = "",
                         owner: str = "admin") -> int:
        ds = self.dashboards
        did = self._next_dashboard_id
        self._next_dashboard_id += 1
        ds[did] = {"id": did, "name": name, "state": state, "metadata": metadata,
                   "owner": owner, "update_time": time.time()}
        return did

    def replace_dashboard(self, did: int, name: str, state: str, metadata: str,
                          owner: str) -> None:
        if did not in self.dashboards:
            raise SqlError(f"no dashboard {did}")
        self.dashboards[did].update(name=name, state=state, metadata=metadata,
                                    owner=owner, update_time=time.time())

    def delete_dashboard(self, did: int) -> None:
        if self.dashboards.pop(did, None) is None:
            raise SqlError(f"no dashboard {did}")

    def load_table_device(self, name: str, data, create: bool = False,
                          dicts=None):
        """Ingest DEVICE-RESIDENT tensors as a table with no host copy: the
        scan cache is seeded with the (padded) tensors, fragments are views
        over them, and chunk stats are computed on the device.  TEXT columns
        pass dictionary ids plus a host vocabulary: dicts={"col": [...]}.
        The target table must be empty."""
        cols = dict(data)
        dicts = {k.lower(): v for k, v in (dicts or {}).items()}
        if not cols:
            raise SqlError("load_table_device: no columns")
        for a in cols.values():
            if not torch.is_tensor(a) or a.device != self.device:
                raise SqlError("load_table_device takes tensors on the "
                               f"database's device ({self.device})")

        def ti_of(cname, a):
            if cname.lower() in dicts:
                return T.text_dict()
            make = _DEVICE_COLUMN_TYPES.get(a.dtype)
            if make is None:
                raise SqlError(f"load_table_device: unsupported dtype {a.dtype}")
            return make()

        if create and self.catalog.get_table_opt(name) is None:
            self.catalog.create_table(
                name, [(k, ti_of(k, a)) for k, a in cols.items()])
        t = self.catalog.get_table(name)
        _reject_foreign_write(t)
        if t.num_rows:
            raise NotSupported("load_table_device appends only into an "
                               "empty table")
        arrays = {}
        for cd in t.columns:
            key = next((k for k in cols if k.lower() == cd.name.lower()), None)
            if key is None:
                raise StorageError(f"missing column {cd.name}")
            if cd.type.is_dict_string:
                vocab = dicts.get(cd.name.lower())
                if vocab is None:
                    raise NotSupported(f"TEXT column {cd.name} needs a "
                                       "dicts={col: vocab} entry")
                t.dicts[cd.col_id].get_or_add_bulk([str(s) for s in vocab])
            elif cd.type.is_array or cd.type.is_none_string or cd.type.is_geo:
                raise NotSupported(f"load_table_device: column {cd.name}")
            arrays[cd.col_id] = cols[key].to(torch_dtype(cd.type.np_dtype()))
        ns = {int(a.shape[0]) for a in arrays.values()}
        if len(ns) != 1:
            raise StorageError(f"ragged insert: lengths {ns}")
        (n,) = ns
        size = B.bucket(n)
        fr = max(int(t.fragment_rows), 1)
        bounds = [(s, min(s + fr, n)) for s in range(0, max(n, 1), fr)]
        frags = [({}, {}) for _ in bounds]
        seeds = {}
        for cd in t.columns:
            a = arrays[cd.col_id]
            sent = cd.type.null_sentinel()
            for (chunks, st_map), (s, e), st in zip(
                    frags, bounds, _device_chunk_stats(a, sent, bounds)):
                chunks[cd.col_id] = LazyDeviceChunk(a, s, e)
                st_map[cd.col_id] = st
            seeds[cd.col_id] = a if size == n else torch.cat([
                a, torch.full((size - n,), sent, dtype=a.dtype, device=a.device)])
        t.insert_device_fragments(frags)
        for cid, seed in seeds.items():
            self.executor.scan_cache[(t.table_id, t.generation, cid, size, None)] = seed

    def dict_by_ref(self, ref):
        table_id, col_id = ref[:2]
        if table_id == "$transient":
            return self._transient_dicts[col_id]
        return self.catalog.get_table_by_id(table_id).dict_for(col_id)

    def register_llm_transform(self, fn) -> None:
        """Backend of the LLM_TRANSFORM(text, prompt) string op:
        `fn(text, prompt) -> str`, applied once per distinct dictionary
        entry."""
        from heavydb_tpu_torch.storage import string_ops as SO

        SO.set_llm_transform(fn)

    def register_udf(self, name: str, fn, arg_types, ret_type) -> None:
        """Register a scalar UDF.  `fn` takes torch tensors (one per
        argument, already cast to `arg_types`, on the Database's device)
        and returns a tensor, or a (value, valid) pair; a NULL argument
        makes the result NULL.  It runs eagerly inside the query's
        Compound, wherever the SQL calls it."""
        self._udfs[name.upper()] = (fn, list(arg_types), ret_type)

    def register_table_function(self, name: str, fn) -> None:
        """Register a table function: fn(*scalar_args, cursor=<dict of numpy
        columns>) -> dict[str, numpy array], invoked as
        SELECT * FROM TABLE(name(CURSOR(SELECT ...), arg, ...)).  It runs on
        the host at plan time; its rows reach the device as a table."""
        self._table_functions[name.lower()] = fn

    def register_transient_dict(self, key=None):
        """A transient dictionary (reference StringDictionaryProxy transient
        ids): a new one for each call without a `key`, as for a query's
        literal strings; one per key otherwise, so that a transform or pair
        concatenation bound again reuses its dictionary, and with it the
        executor's tables and kernels."""
        from heavydb_tpu_torch.storage.string_dict import StringDictionary

        if key is not None and key in self._transient_by_key:
            ref = self._transient_by_key[key]
            return ref, self._transient_dicts[ref[1]]
        i = self._next_transient
        self._next_transient += 1
        d = StringDictionary(dict_id=-i - 1)
        self._transient_dicts[i] = d
        if key is not None:
            self._transient_by_key[key] = ("$transient", i)
        return ("$transient", i), d

    # ------------------------------------------------------------------
    # planning helpers (the binder and planner call these)
    # ------------------------------------------------------------------
    def _plan_select(self, sel: A.Select) -> R.RelNode:
        return SelectPlanner(self).plan(sel)

    def _get_view(self, name: str) -> Optional[A.Select]:
        return self._views.get(name.lower())

    def _result_dicts(self, plan) -> list:
        dicts = []
        for i in range(plan.arity):
            ref = _node_dict_ref(plan, i)
            dicts.append(self.dict_by_ref(ref) if ref and not plan.types[i].is_array
                         else None)
        return dicts

    # ------------------------------------------------------------------
    # array and geo columns: device rowid handles <-> host payload rows
    # ------------------------------------------------------------------
    def _rowids_to_object(self, ref, rowids: np.ndarray):
        """An array column's rowid handles -> an object ndarray of its
        rows' element arrays (None: NULL or out of range), and the
        column's dictionary."""
        tid, cid = ref[:2]
        t = self.catalog.get_table_by_id(tid)
        payload = self.executor._geo_xform_rows(t, cid, ref)
        out = np.empty(len(rowids), object)
        np_len = len(payload)
        for j, rid in enumerate(rowids.tolist()):
            out[j] = payload[rid] if 0 <= rid < np_len else None
        return out, t.dicts.get(cid)

    def _fix_array_cols(self, rs: ResultSet, plan) -> ResultSet:
        """A result's array columns: rowid handles replaced by their host
        payloads before the ResultSet reaches the caller."""
        if not any(ti.is_array for ti in plan.types):
            return rs  # scalar results stay lazy
        cols = rs._materialize()
        for i, ti in enumerate(plan.types):
            if not ti.is_array:
                continue
            ref = _node_dict_ref(plan, i)
            if ref is None:
                raise NotSupported("SELECT of computed arrays")
            cols[i], rs._dicts[i] = self._rowids_to_object(ref, cols[i])
        return rs

    def _array_col_for_insert(self, plan, i, rowids, t, cd):
        """An array column flowing into a table: its rows' payloads; TEXT[]
        elements re-interned into the target column's dictionary."""
        ref = _node_dict_ref(plan, i)
        if ref is None:
            raise NotSupported("INSERT of computed arrays")
        objs, sd = self._rowids_to_object(ref, rowids)
        if cd.type.elem_type().is_dict_string and ref != (t.table_id, cd.col_id):
            return to_physical(from_physical(objs, cd.type, sd), cd.type,
                               t.dicts.get(cd.col_id))
        return objs

    # ------------------------------------------------------------------
    # statement dispatch
    # ------------------------------------------------------------------
    def _execute_statement(self, st: A.Statement) -> Optional[ResultSet]:
        if isinstance(st, A.Select):
            return self._run_select(st)
        if isinstance(st, A.Explain):
            return self._explain(st)
        if isinstance(st, A.CreateTable):
            return self._create_table(st)
        if isinstance(st, A.AlterSetting):
            return self._alter_setting(st)
        if isinstance(st, A.InsertValues):
            return self._insert_values(st)
        if isinstance(st, A.InsertSelect):
            return self._insert_select(st)
        if isinstance(st, A.Update):
            return self._update(st)
        if isinstance(st, A.Delete):
            return self._delete(st)
        if isinstance(st, A.TruncateTable):
            self.catalog.get_table(st.name).delete_all()
            return None
        if isinstance(st, A.CopyFrom):
            return self._copy_from(st)
        if isinstance(st, A.CopyTo):
            return self._copy_to(st)
        if isinstance(st, A.DumpTable):
            self._dump_table(st.name, st.path)
            return _string_result("result", ["OK"])
        if isinstance(st, A.RestoreTable):
            self._restore_table(st.name, st.path)
            return _string_result("result", ["OK"])
        if isinstance(st, (A.CreateServer, A.DropServer, A.ShowServers,
                           A.CreateForeignTable, A.RefreshForeignTables)):
            return self._foreign_statement(st)
        if isinstance(st, A.DropTable):
            t = self.catalog.get_table_opt(st.name)
            self.catalog.drop_table(st.name, st.if_exists)
            if t is not None:
                self.executor.forget_table(t.table_id)
            return None
        if isinstance(st, A.RenameTable):
            self.catalog.rename_table(st.old, st.new)
            return None
        if isinstance(st, (A.AddColumn, A.DropColumn, A.RenameColumn, A.AlterColumnType,
                           A.OptimizeTable)):
            return self._alter_columns(st)
        if isinstance(st, A.CommentOn):
            t = self.catalog.get_table(st.table)
            if st.kind == "COLUMN":
                cd = t.column_by_name(st.column)
                if cd is None:
                    raise SqlError(f"no column {st.column!r}")
                cd.comment = st.text
            else:
                t.comment = st.text
            return None
        if isinstance(st, A.CreateView):
            key = st.name.lower()
            if key in self._views and not st.if_not_exists:
                raise CatalogError(f"view {st.name!r} already exists")
            self._views[key] = st.select
            return None
        if isinstance(st, A.DropView):
            if st.name.lower() not in self._views and not st.if_exists:
                raise CatalogError(f"view {st.name!r} does not exist")
            self._views.pop(st.name.lower(), None)
            return None
        if isinstance(st, A.ValidateStmt):
            return _string_result("status", ["OK"])
        if isinstance(st, (A.ShowTables, A.DescribeTable, A.ShowCreateTable,
                           A.ShowTableDetails, A.ShowFunctions, A.ShowQueries,
                           A.KillQuery, A.ShowUserSessions)):
            return self._show(st)
        if isinstance(st, (A.CreateUser, A.DropUser, A.AlterUser, A.CreateRole,
                           A.DropRole, A.GrantStmt, A.CreatePolicy, A.DropPolicy,
                           A.ShowPolicies, A.ShowUsers, A.ShowRoles)):
            return self._security(st)
        raise NotSupported(f"statement {type(st).__name__}")

    # ------------------------------------------------------------------
    # SELECT: hints, timers, row-level policies, the result recycler
    # ------------------------------------------------------------------
    def _run_select(self, sel: A.Select) -> ResultSet:
        """A SELECT under its hints, with the `query` / `parse` / `plan` /
        `execute` / `fetch` scopes timed when `enable_debug_timer` is on.
        On CUDA the `execute` scope ends at the Compound's control read,
        which waits for the device; `fetch` only wraps the device result.
        Its columns reach the host when first read, in the `egress` scope
        that then joins the root.  The root carries the query's counters
        (`_query_counters`)."""
        timer = QueryTimer() if self.config.enable_debug_timer else NULL_TIMER
        ex = self.executor
        ex.timer = timer
        ex.exec_hints = sel.hints or {}
        cache_key = None
        if timer.enabled:
            before = _query_counters(ex)
        with timer.scope("query"):
            timer.add(getattr(self._timings, "parse", None))
            self._timings.parse = None
            with timer.scope("plan"):
                plan = self._plan_select(sel)
                user = getattr(self._user_tls, "user", None)
                if user is not None and self.syscatalog.policies:
                    plan = self._inject_rls(plan, user)
                plan = optimize(plan)
            if "keep_result" in ex.exec_hints:
                cache_key = self._result_cache_key(plan)
                hit = self._result_cache.get(cache_key) if cache_key is not None else None
                if hit is not None:
                    self._timings.last = None
                    return hit
            with timer.scope("execute"):
                batch = ex.execute(plan)
            with timer.scope("fetch"):
                rs = self._fix_array_cols(from_batch(batch, plan.fields, plan.types,
                                                     self._result_dicts(plan), timer), plan)
        if timer.enabled:
            # on the root, outside its time
            after = _query_counters(ex)
            launches = {k: n - before["launches"].get(k, 0)
                        for k, n in after.pop("launches").items()
                        if n != before["launches"].get(k, 0)}
            timer.note(**{k: v - before[k] for k, v in after.items()},
                       **({"launches": launches} if launches else {}))
        if cache_key is not None:
            self._result_cache[cache_key] = rs
        self._timings.last = timer
        return rs

    def _inject_rls(self, plan, user: str):
        """Row-level security: every Scan of a table with policies for
        `user` (or a role of theirs) becomes a Filter `col IN (values)`
        before optimization, so it fuses and pushes down like a WHERE;
        subquery plans get theirs too.  A dictionary-string column filters
        through a DictStrPredicate IN (a match table over its entries)."""
        sysc = self.syscatalog

        def cond_for(scan):
            conjs = []
            for col, vals in sysc.policies_for(user, scan.table.name):
                cd = scan.table.column_by_name(col)
                if cd is None:
                    continue
                idx = next(i for i, c in enumerate(scan.table.columns)
                           if c.col_id == cd.col_id)
                ti = scan.types[idx]
                ref = E.InputRef(0, idx, ti, _node_dict_ref(scan, idx))
                if ti.is_dict_string:
                    conjs.append(E.DictStrPredicate(
                        arg=ref, kind="IN", pattern="\x00".join(str(v) for v in vals),
                        dict_ref=ref.dict_ref, type=T.boolean(ti.nullable)))
                else:
                    phys = tuple(int(v) if ti.is_integer else float(v) for v in vals)
                    conjs.append(E.InValues(arg=ref, values=phys,
                                            type=T.boolean(ti.nullable)))
            if not conjs:
                return None
            cond = conjs[0]
            for c in conjs[1:]:
                cond = E.BinOp(E.BinOpKind.AND, cond, c, T.boolean(False))
            return cond

        def node_exprs(n):
            if isinstance(n, R.Filter):
                return [n.condition]
            if isinstance(n, R.Project):
                return list(n.exprs)
            if isinstance(n, R.Join):
                return [n.condition] if n.condition is not None else []
            if isinstance(n, R.Aggregate):
                return list(n.group_exprs) + list(n.agg_exprs)
            if isinstance(n, R.Window):
                return list(n.wfuncs)
            if isinstance(n, R.Compound):
                return list(_iter_node_exprs(n))
            return []

        seen = {}

        def walk(node):
            if id(node) in seen:
                return seen[id(node)]
            node.inputs[:] = [walk(i) for i in node.inputs]
            for e in node_exprs(node):
                for sub in E.walk(e):
                    if isinstance(sub, E.SubqueryExpr) and sub.plan is not None:
                        object.__setattr__(sub, "plan", walk(sub.plan))
            out = node
            if isinstance(node, R.Scan):
                c = cond_for(node)
                if c is not None:
                    out = R.Filter(node, c)
            seen[id(node)] = out
            return out

        return walk(plan)

    def _result_cache_key(self, plan: R.RelNode):
        """(plan key, (table id, generation) of every Scan), or None for a
        plan with a subquery, whose result the key cannot track."""
        gens = []
        for n in R.topo_order(plan):
            for e in _iter_all_exprs(n):
                if any(isinstance(sub, E.SubqueryExpr) for sub in E.walk(e)):
                    return None
            if isinstance(n, R.Scan):
                gens.append((n.table.table_id, n.table.generation))
        return (plan.plan_key(), tuple(gens))

    def _explain(self, st: A.Explain) -> ResultSet:
        """EXPLAIN: the optimized plan; CALCITE: the plan before the
        optimizer; OPTIMIZED: the optimized plan, then the root Compound's
        program as the port runs it (`Executor.program_text`), where the
        reference prints its kernel's jaxpr."""
        if not isinstance(st.stmt, A.Select):
            raise NotSupported("EXPLAIN of non-SELECT")
        plan = self._plan_select(st.stmt)
        if st.kind == "CALCITE":
            return _string_result("explanation", plan.explain().split("\n"))
        plan = optimize(plan)
        if st.kind == "OPTIMIZED":
            program = self.executor.program_text(plan)
            text = plan.explain() if program is None else plan.explain() + "\n\n" + program
            return _string_result("explanation", text.split("\n"))
        return _string_result("explanation", plan.explain().split("\n"))

    # ------------------------------------------------------------------
    # ALTER SESSION / SYSTEM SET
    # ------------------------------------------------------------------
    _SETTABLE = {
        "enable_watchdog", "watchdog_max_projected_rows",
        "enable_dynamic_watchdog", "dynamic_watchdog_time_limit_ms",
        "enable_debug_timer",
        "enable_executor_resource_mgr", "max_concurrent_queries",
        "max_exec_bytes", "admission_queue_timeout_s",
        "baseline_groupby_threshold", "perfect_join_max_range",
    }

    def _alter_setting(self, st: A.AlterSetting) -> ResultSet:
        key = st.key
        if key not in self._SETTABLE or not hasattr(self.config, key):
            raise SqlError(f"unknown or non-settable parameter {key!r}")
        cur = getattr(self.config, key)
        val = st.value
        if isinstance(cur, bool):
            val = bool(val)
        elif isinstance(cur, int):
            val = int(val)
        elif isinstance(cur, float):
            val = float(val)
        setattr(self.config, key, val)
        rm = self.executor.resource_mgr
        if key == "max_concurrent_queries" and rm is not None:
            rm.max_concurrent = int(val)
        if key == "max_exec_bytes" and rm is not None:
            rm.max_bytes = int(val) or None
        if key == "admission_queue_timeout_s" and rm is not None:
            rm.queue_timeout_s = float(val)
        return _string_result("result", [f"{key} = {val}"])

    # ------------------------------------------------------------------
    # column DDL
    # ------------------------------------------------------------------
    def _alter_columns(self, st) -> None:
        """ADD (with a bound DEFAULT) / DROP / RENAME COLUMN, ALTER COLUMN
        TYPE and OPTIMIZE TABLE.  Each bumps the table's generation: the
        resident device columns whose rows did not change move to it, the
        altered or dropped one leaves, and the kernels and aux tables that
        name the table go (`Executor.forget_table`), since an aux table is
        keyed by its column's dictionary reference and size only."""
        t = self.catalog.get_table(st.name if isinstance(st, A.OptimizeTable) else st.table)
        old_gen = t.generation
        changed = ()
        if isinstance(st, A.AddColumn):
            ti = resolve_type_name(st.column.type_name)
            default = None
            if st.column.default is not None:
                e = ExprBinder(Scope(), self, allow_aggs=False).bind(st.column.default)
                if ti.is_dict_string:
                    default = str(e.value) if e.value is not None else None
                else:
                    default = _const_value(e, ti)
                    # add_column backfills through to_physical, which takes
                    # raw values: undo the decimal scaling
                    if ti.is_decimal and default is not None:
                        default = default / 10**ti.scale
            t.add_column(st.column.name, ti, default)
        elif isinstance(st, A.DropColumn):
            t.drop_column(st.column)
        elif isinstance(st, A.RenameColumn):
            t.rename_column(st.old, st.new)
        elif isinstance(st, A.AlterColumnType):
            cd = t.column_by_name(st.column)
            t.alter_column_type(st.column, resolve_type_name(st.type_name))
            changed = (cd.col_id,) if cd is not None else ()
        else:
            t.recompute_metadata()
        if t.generation != old_gen:
            self.executor.patch_cache_columns(t, old_gen, changed)
        if not isinstance(st, (A.AddColumn, A.OptimizeTable)):
            self.executor.forget_table(t.table_id)
        return None

    # ------------------------------------------------------------------
    # SHOW / DESCRIBE and the server's registries
    # ------------------------------------------------------------------
    def _show(self, st) -> ResultSet:
        txt = T.TypeInfo(T.SQLTypeKind.TEXT, False)
        if isinstance(st, A.ShowTables):
            return _string_result("table_name", self.catalog.list_tables())
        if isinstance(st, A.DescribeTable):
            t = self.catalog.get_table(st.name)
            return ResultSet(["name", "type"], [txt, txt],
                             [np.array([cd.name for cd in t.columns], object),
                              np.array([str(cd.type) for cd in t.columns], object)],
                             [None, None])
        if isinstance(st, A.ShowCreateTable):
            t = self.catalog.get_table(st.name)
            cols = ",\n  ".join(f"{cd.name} {cd.type}" for cd in t.columns)
            return _string_result("create_table", [f"CREATE TABLE {t.name} (\n  {cols});"])
        if isinstance(st, A.ShowTableDetails):
            # per table: rows, fragments, columns, fragment capacity and the
            # bytes of its chunks (a device-backed chunk counts its slice)
            rows = []
            for nm in list(st.names) or self.catalog.list_tables():
                t = self.catalog.get_table(nm)
                nbytes = sum(int(getattr(a, "nbytes", 0) or 0)
                             for f in t.fragments for a in f.chunks.values())
                rows.append((nm, t.num_rows, len(t.fragments), len(t.columns),
                             t.fragment_rows, nbytes))
            i64 = T.bigint(False)
            return ResultSet(
                ["table_name", "num_rows", "num_fragments", "num_columns",
                 "max_fragment_rows", "host_bytes"],
                [txt, i64, i64, i64, i64, i64],
                [np.array([r[0] for r in rows], object)]
                + [np.array([r[i] for r in rows], np.int64) for i in range(1, 6)],
                [None] * 6)
        if isinstance(st, A.ShowFunctions):
            if st.table_functions:
                return _string_result("table_function", sorted(self._table_functions))
            from heavydb_tpu_torch.plan.builder import _INT_STRING_FNS, _MATH_FNS, _STRING_FNS

            return _string_result("function", sorted(
                _MATH_FNS | _STRING_FNS | set(_INT_STRING_FNS) | set(self._udfs)))
        if isinstance(st, A.KillQuery):
            # interrupts the session's query through the server's registry
            killer = getattr(self, "kill_provider", None)
            if killer is None:
                raise SqlError("KILL QUERY requires a live server (no embedded "
                               "query registry)")
            return _string_result("result", ["interrupted" if killer(st.session_id)
                                             else "no such query"])
        # SHOW QUERIES (in-flight statements) and SHOW USER SESSIONS: rows
        # of a provider the server installs; none when embedded
        if isinstance(st, A.ShowQueries):
            provider = getattr(self, "queries_provider", None)
            fields = ["query_session_id", "current_status", "query_str", "elapsed_ms"]
        else:
            provider = getattr(self, "session_provider", None)
            fields = ["session_id", "login_name", "client_address", "idle_seconds"]
        rows = list(provider()) if provider is not None else []
        return ResultSet(fields, [txt, txt, txt, T.bigint(False)],
                         [np.array([r[i] for r in rows], object) for i in range(3)]
                         + [np.array([int(r[3]) for r in rows], np.int64)],
                         [None] * 4)

    # ------------------------------------------------------------------
    # users, roles, privileges, row-level policies
    # ------------------------------------------------------------------
    def _security(self, st) -> Optional[ResultSet]:
        sc = self.syscatalog
        if isinstance(st, A.CreateUser):
            sc.create_user(st.name, str(st.options.get("password", "")),
                           bool(st.options.get("is_super", False)))
        elif isinstance(st, A.DropUser):
            sc.drop_user(st.name)
        elif isinstance(st, A.AlterUser):
            sc.alter_user(st.name,
                          password=(str(st.options["password"])
                                    if "password" in st.options else None),
                          is_super=(bool(st.options["is_super"])
                                    if "is_super" in st.options else None))
        elif isinstance(st, A.CreateRole):
            sc.create_role(st.name)
        elif isinstance(st, A.DropRole):
            sc.drop_role(st.name)
        elif isinstance(st, A.GrantStmt):
            for g in st.grantees:
                if st.privileges is not None:
                    (sc.revoke if st.revoke else sc.grant)(st.privileges, st.object, g)
                else:
                    for r in st.roles:
                        (sc.revoke_role if st.revoke else sc.grant_role)(r, g)
        elif isinstance(st, A.CreatePolicy):
            t = self.catalog.get_table(st.table)
            cd = t.column_by_name(st.column)
            if cd is None:
                raise SqlError(f"no column {st.column!r} in {st.table!r}")
            if not (cd.type.is_string or cd.type.is_integer):
                raise NotSupported("policies supported on TEXT and integer columns")
            sc.create_policy(st.table, st.column, st.grantee, st.values)
        elif isinstance(st, A.DropPolicy):
            sc.drop_policy(st.table, st.column, st.grantee)
        elif isinstance(st, A.ShowPolicies):
            return _string_result("policy", [
                f"{tb}.{col} TO {g} VALUES ({', '.join(repr(v) for v in vals)})"
                for tb, col, g, vals in sc.list_policies(st.grantee, st.effective)])
        elif isinstance(st, A.ShowUsers):
            return _string_result("user_name", [u.name for u in sc.users.values()])
        else:
            return _string_result("role_name", sorted(sc.roles))
        return None

    # ------------------------------------------------------------------
    # DUMP / RESTORE (reference TableArchiver): one table's store, at one
    # epoch, with its schema, in a tar.gz
    # ------------------------------------------------------------------
    def _dump_table(self, name: str, path: str) -> None:
        t = self.catalog.get_table(name)
        with tempfile.TemporaryDirectory() as tmp:
            store = TableStore(tmp, 0)
            store.checkpoint(t)
            schema = {"name": t.name, "fragment_rows": t.fragment_rows,
                      "columns": [{"name": cd.name, "col_id": cd.col_id,
                                   "type": _type_to_json(cd.type)}
                                  for cd in t.columns]}
            with open(os.path.join(store.dir, "schema.json"), "w") as f:
                json.dump(schema, f)
            # gzip's fastest level: the chunks are already RLE / DIFF
            # encoded, and level 9 costs ~10x the time for ~2 % fewer bytes
            with tarfile.open(path, "w:gz", compresslevel=1) as tar:
                tar.add(store.dir, arcname="table")

    def _restore_table(self, name: str, path: str) -> None:
        """A table from a DUMP archive.  One of that name is dropped first,
        and every kernel, aux table and device column of it with it."""
        with tempfile.TemporaryDirectory() as tmp:
            with tarfile.open(path, "r:gz") as tar:
                tar.extractall(tmp, filter="data")
            tdir = os.path.join(tmp, "table")
            with open(os.path.join(tdir, "schema.json")) as f:
                schema = json.load(f)
            existing = self.catalog.get_table_opt(name)
            if existing is not None:
                self.catalog.drop_table(name)
                self.executor.forget_table(existing.table_id)
            cols = [ColumnDescriptor(c["name"], _type_from_json(c["type"]), c["col_id"])
                    for c in sorted(schema["columns"], key=lambda c: c["col_id"])]
            t = self.catalog.create_table(name, cols, schema["fragment_rows"])
            store = TableStore.__new__(TableStore)
            store.dir = tdir
            store.load_into(t)
            t.generation += 1
            self._persist_after_statement()

    # ------------------------------------------------------------------
    # COPY
    # ------------------------------------------------------------------
    def _copy_from(self, st: A.CopyFrom) -> ResultSet:
        from heavydb_tpu_torch.io.csv_import import detect_column_types, import_csv

        src_type = str(st.options.get("source_type", "")).lower()
        lower = st.path.lower()
        if src_type in ("geo_file", "geojson") or (
                not src_type and lower.endswith(".geojson")):
            from heavydb_tpu_torch.io.geo_import import import_geo

            n = import_geo(self, st.table, st.path, st.options)
            return _string_result("result", [f"Loaded: {n} recs"])
        if src_type == "raster_file" or (
                not src_type and lower.endswith((".tif", ".tiff", ".asc", ".xyz"))):
            from heavydb_tpu_torch.io.raster_import import import_raster

            n = import_raster(self, st.table, st.path, st.options)
            return _string_result("result", [f"Loaded: {n} recs"])
        t = self.catalog.get_table_opt(st.table)
        if t is None:
            # auto-create with the detected schema
            t = self.catalog.create_table(st.table, detect_column_types(st.path, st.options))
        n = import_csv(t, st.path, st.options)
        return _string_result("result", [f"Loaded: {n} recs"])

    def _copy_to(self, st: A.CopyTo) -> ResultSet:
        from heavydb_tpu_torch.io.csv_export import export_result

        n = export_result(self._run_select(st.select), st.path, st.options)
        return _string_result("result", [f"Exported: {n} recs"])

    # ------------------------------------------------------------------
    # foreign servers and tables (reference DataMgr/ForeignStorage/: the
    # delimited, parquet and regex wrappers, S3 and DB-API sources; a table
    # is read at its first scan and again at each REFRESH)
    # ------------------------------------------------------------------
    def _foreign_statement(self, st) -> Optional[ResultSet]:
        if isinstance(st, A.CreateServer):
            if st.name in self._servers and not st.if_not_exists:
                raise SqlError(f"server {st.name!r} already exists")
            self._servers.setdefault(st.name, {"wrapper": st.wrapper.lower(),
                                               "options": dict(st.options)})
            return None
        if isinstance(st, A.DropServer):
            if st.name not in self._servers:
                if st.if_exists:
                    return None
                raise SqlError(f"no server {st.name!r}")
            del self._servers[st.name]
            return None
        if isinstance(st, A.ShowServers):
            return _string_result("server_name", [f"{n} ({s['wrapper']})"
                                                  for n, s in self._servers.items()])
        if isinstance(st, A.CreateForeignTable):
            return self._create_foreign_table(st)
        from heavydb_tpu_torch.io import remote

        for name in st.tables:  # REFRESH FOREIGN TABLES
            t = self.catalog.get_table(name)
            if getattr(t, "foreign", None) is None:
                raise SqlError(f"{name!r} is not a foreign table")
            # an S3 source: drop the spool so that REFRESH fetches again
            fp = t.foreign["options"].get("file_path", "")
            if remote.is_s3_uri(fp):
                remote.evict_spool(fp, self._fsi_spool_dir())
            self._load_foreign(t)
            t.foreign["last_refresh"] = time.time()
            t.foreign.pop("next_refresh", None)  # the scheduler computes it again
        return None

    def _create_foreign_table(self, st: A.CreateForeignTable) -> None:
        if self.catalog.get_table_opt(st.name) is not None:
            if st.if_not_exists:
                return None
            raise SqlError(f"table {st.name!r} already exists")
        server = self._servers.get(st.server)
        if server is None:
            raise SqlError(f"no server {st.server!r}")
        declared = [(cd.name, resolve_type_name(cd.type_name)) for cd in st.columns]
        if server["wrapper"] == "sql_select":
            # a DB-API source: no file; the schema is declared, or taken from
            # the cursor and its rows
            defs = declared
            if not defs:
                from heavydb_tpu_torch.io.remote import dbapi_query

                names, rows = dbapi_query(server["options"], dict(st.options))
                defs = [(nm, _infer_type_values([r[i] for r in rows]))
                        for i, nm in enumerate(names)]
        else:
            path = self._foreign_path(server, st.options)
            if declared:
                defs = declared
            elif server["wrapper"] == "parquet_file":
                import pandas as pd

                df = pd.read_parquet(path)
                defs = [(c, _infer_type(df[c].to_numpy())) for c in df.columns]
            else:
                from heavydb_tpu_torch.io.csv_import import detect_column_types

                defs = detect_column_types(path, st.options)
        t = self.catalog.create_table(st.name, defs, 32_000_000)
        t.foreign = {"server": st.server, "options": dict(st.options), "loaded": False}
        return None

    def _foreign_path(self, server: dict, options: dict) -> str:
        from heavydb_tpu_torch.io import remote

        path = options.get("file_path")
        if path is None:
            raise SqlError("foreign table requires file_path option")
        base = server["options"].get("base_path")
        if base and not os.path.isabs(path) and not remote.is_s3_uri(path):
            path = os.path.join(base, path)
        if base and remote.is_s3_uri(base) and not remote.is_s3_uri(path):
            path = base.rstrip("/") + "/" + path
        if remote.is_s3_uri(path):
            # spool the object locally; the file wrappers parse the spool
            return remote.spool_s3(path, self._fsi_spool_dir(),
                                   {**server["options"], **options})
        return path

    def _fsi_spool_dir(self) -> str:
        if self.path:
            return os.path.join(self.path, "fsi_spool")
        d = getattr(self, "_tmp_spool", None)
        if d is None:
            d = self._tmp_spool = tempfile.mkdtemp(prefix="hdt_fsi_spool_")
        return d

    def ensure_foreign_loaded(self, t: Table) -> None:
        """The planner's hook: a foreign table not read yet is read now."""
        if getattr(t, "foreign", None) is not None and not t.foreign["loaded"]:
            self._load_foreign(t)

    def _foreign_cache_file(self, t: Table, path: str):
        """(cache file, source fingerprint) of a foreign table on disk, so
        that a reopened database does not parse an unchanged source again;
        (None, None) in memory."""
        if not self.path:
            return None, None
        try:
            stat = os.stat(path)
            fp = f"{stat.st_mtime_ns}:{stat.st_size}"
        except OSError:
            fp = None  # the source is gone: a cache, if any, still serves
        d = os.path.join(self.path, "fsi_cache")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"t{t.table_id}.npz"), fp

    def _load_foreign(self, t: Table) -> None:
        """Read a foreign table from its source again, as a new generation
        of the table; the device state of the old one is dropped."""
        self._read_foreign(t)
        self.executor.forget_table(t.table_id)
        self._drop_stale()

    def _read_foreign(self, t: Table) -> None:
        fo = t.foreign
        # the refresh schedule starts at the first load
        fo.setdefault("last_refresh", time.time())
        server = self._servers.get(fo["server"])
        if server is None:
            raise SqlError(f"no server {fo['server']!r}")
        if server["wrapper"] == "sql_select":
            from heavydb_tpu_torch.io.remote import dbapi_query

            names, rows = dbapi_query(server["options"], fo["options"])
            by_name = {nm.lower(): np.array([r[i] for r in rows], object)
                       for i, nm in enumerate(names)}
            self._replace_foreign_rows(t, by_name, len(rows))
            return
        path = self._foreign_path(server, fo["options"])
        cache_file, fp = self._foreign_cache_file(t, path)
        if cache_file and os.path.exists(cache_file):
            try:
                z = np.load(cache_file, allow_pickle=True)
                if fp is None or str(z["__fingerprint__"]) == fp:
                    t.delete_all()
                    arrays = {int(k[1:]): z[k] for k in z.files if k.startswith("c")}
                    for cid in list(arrays):
                        if f"d{cid}" in z.files and cid in t.dicts:
                            t.dicts[cid].get_or_add_bulk([str(x) for x in z[f"d{cid}"]])
                    if arrays and len(next(iter(arrays.values()))):
                        t.insert_columns(arrays)
                    fo["loaded"] = True
                    return
            except Exception:  # noqa: BLE001 - a stale or broken cache: parse the source
                pass
        import pandas as pd

        wrapper = server["wrapper"]
        if wrapper == "parquet_file":
            df = pd.read_parquet(path)
            cols = {c: df[c].to_numpy() for c in df.columns}
        elif wrapper == "regex_parser":
            import re

            regex = fo["options"].get("line_regex")
            if not regex:
                raise SqlError("regex_parser requires line_regex option")
            pat = re.compile(regex)
            rows = []
            with open(path) as f:
                if fo["options"].get("header", True):
                    next(f, None)
                for line in f:
                    m = pat.match(line.rstrip("\n"))
                    rows.append(m.groups() if m else (None,) * len(t.columns))
            cols = {cd.name: np.array([r[i] if i < len(r) else None for r in rows], object)
                    for i, cd in enumerate(t.columns)}
        else:  # delimited
            df = pd.read_csv(path, delimiter=fo["options"].get("delimiter", ","))
            cols = {c: df[c].to_numpy() for c in df.columns}
        by_name = {k.lower(): v for k, v in cols.items()}
        arrays = self._replace_foreign_rows(
            t, by_name, max((len(x) for x in by_name.values()), default=0))
        if cache_file and fp is not None:
            try:
                payload = {"__fingerprint__": np.array(fp)}
                for cid, arr in arrays.items():
                    payload[f"c{cid}"] = arr
                    if cid in t.dicts:
                        payload[f"d{cid}"] = np.array(t.dicts[cid].entries(), object)
                np.savez_compressed(cache_file, **payload)
            except Exception:  # noqa: BLE001 - the cache is best-effort
                pass

    @staticmethod
    def _replace_foreign_rows(t: Table, by_name: dict, n: int) -> dict:
        """The table's rows replaced by the source's columns (by lower-case
        name; a column the source lacks is NULL); returns the physical
        columns."""
        t.delete_all()
        arrays = {}
        for cd in t.columns:
            v = by_name.get(cd.name.lower())
            arrays[cd.col_id] = to_physical([None] * n if v is None else v, cd.type,
                                            t.dicts.get(cd.col_id))
        if arrays and len(next(iter(arrays.values()))):
            t.insert_columns(arrays)
        t.foreign["loaded"] = True
        return arrays

    def _create_table(self, st: A.CreateTable) -> None:
        frag_rows = st.options.get("fragment_size")
        if st.as_select is None:
            defs = [(cd.name, resolve_type_name(cd.type_name)) for cd in st.columns]
            t = self.catalog.create_table(st.name, defs, frag_rows, st.if_not_exists,
                                          st.temporary)
            if st.shard_key is not None:
                # the reference's SHARD KEY and shard_count (kept in the
                # catalog; no multi-device load reads them yet)
                if t.column_by_name(st.shard_key) is None:
                    raise BinderError(f"SHARD KEY column {st.shard_key!r} not in table")
                t.shard_key = st.shard_key.lower()
                t.shard_count = int(st.options.get("shard_count", 0))
            sc = st.options.get("sort_column")
            if sc:
                sc = str(sc).strip("'\"")
                if t.column_by_name(sc) is None:
                    raise BinderError(f"sort_column {sc!r} not in table")
                t.sort_column = sc.lower()
            return None
        # CREATE TABLE AS SELECT: the query's columns, types and rows
        plan = optimize(self._plan_select(st.as_select))
        batch = self.executor.execute(plan)
        defs = list(zip(plan.fields, plan.types))
        if st.columns:
            if len(st.columns) != len(defs):
                raise BinderError("CTAS column count mismatch")
            defs = [(cd.name, ti) for cd, (_, ti) in zip(st.columns, defs)]
        t = self.catalog.create_table(st.name, defs, frag_rows, st.if_not_exists,
                                      st.temporary)
        host = batch.to_numpy()
        cols = {}
        for cd, (i, ti) in zip(t.columns, enumerate(plan.types)):
            arr = host[i]
            if ti.is_array:
                arr = self._array_col_for_insert(plan, i, arr, t, cd)
            elif ti.is_dict_string:
                src_ref = _node_dict_ref(plan, i)
                src = self.dict_by_ref(src_ref) if src_ref else None
                strings = src.get_strings(arr) if src is not None else [None] * len(arr)
                arr = t.dict_for(cd.col_id).get_or_add_bulk(strings)
            cols[cd.col_id] = arr
        if batch.nrows:
            t.insert_columns(cols)
        return None

    def _insert_select(self, st: A.InsertSelect) -> None:
        t = self.catalog.get_table(st.table)
        _reject_foreign_write(t)
        plan = optimize(self._plan_select(st.select))
        batch = self.executor.execute(plan)
        host = batch.to_numpy()
        target_cols = ([_col_of(t, c) for c in st.columns] if st.columns
                       else list(t.columns))
        if len(target_cols) != plan.arity:
            raise SqlError("INSERT SELECT column count mismatch")
        cols = {}
        for i, cd in enumerate(target_cols):
            src_ti = plan.types[i]
            arr = host[i]
            if cd.type.is_array:
                if not src_ti.is_array:
                    raise SqlError(f"cannot insert {src_ti} into array column")
                arr = self._array_col_for_insert(plan, i, arr, t, cd)
            elif cd.type.is_dict_string:
                src_ref = _node_dict_ref(plan, i)
                if src_ref is None:
                    raise NotSupported("INSERT of computed strings")
                strings = self.dict_by_ref(src_ref).get_strings(arr)
                arr = t.dict_for(cd.col_id).get_or_add_bulk(strings)
            elif src_ti.kind != cd.type.kind or (
                    cd.type.is_decimal and src_ti.scale != cd.type.scale):
                arr = _host_cast_array(arr, src_ti, cd.type)
            cols[cd.col_id] = arr
        for cd in t.columns:
            if cd.col_id not in cols:
                if not cd.type.nullable:
                    raise SqlError(f"column {cd.name} is NOT NULL")
                cols[cd.col_id] = to_physical([None] * batch.nrows, cd.type,
                                              t.dicts.get(cd.col_id))
        if batch.nrows:
            t.insert_columns(cols)
        return None

    # ------------------------------------------------------------------
    # UPDATE / DELETE: a filtered projection, then fragment-level patches
    # (the reference's UpdelStorage: the update kernel yields row offsets
    # and values, the fragmenter applies them in place)
    # ------------------------------------------------------------------
    def _matched_rows_and_values(self, t: Table, where, value_exprs):
        """`SELECT rowid, values ... FROM t WHERE cond` on the executor:
        the predicate runs as a real filter, so chunk-stat fragment
        skipping stays live and only the matched rows reach the host.
        Returns (rowids int64, the values' host columns, the plan)."""
        proj = [(A.Identifier(("rowid",)), "$r")] + [
            (e, f"$v{i}") for i, e in enumerate(value_exprs)]
        sel = A.Select(projections=proj, from_=A.NamedTable(t.name), where=where)
        plan = optimize(self._plan_select(sel))
        host = self.executor.execute(plan).to_numpy()
        return np.asarray(host[0], np.int64), host[1:], plan

    def _update(self, st: A.Update) -> None:
        t = self.catalog.get_table(st.table)
        _reject_foreign_write(t)
        assigned = [(_col_of(t, name), expr) for name, expr in st.assignments]
        if any(cd.type.is_array or cd.type.is_geo for cd, _ in assigned):
            raise NotSupported("UPDATE of array or geo columns")
        rowids, vals, plan = self._matched_rows_and_values(
            t, st.where, [e for _, e in assigned])
        self.last_mutation = dict(rows=int(rowids.shape[0]), fragments=[])
        if rowids.shape[0] == 0:
            return None
        new_cols = {}
        for i, ((cd, _), arr) in enumerate(zip(assigned, vals), start=1):
            src_ti = plan.types[i]
            if cd.type.is_dict_string:
                src_ref = _node_dict_ref(plan, i)
                arr = arr.astype(np.int32)
                if src_ref != (t.table_id, cd.col_id):
                    # values of another dictionary (a literal's transient
                    # one, a transform's) re-intern into the column's
                    src = self.dict_by_ref(src_ref) if src_ref else None
                    if src is None:
                        raise NotSupported("UPDATE from computed strings")
                    arr = t.dict_for(cd.col_id).get_or_add_bulk(src.get_strings(arr))
            elif cd.type.is_none_string:
                # the plan ran the column as lazy-dictionary ids: store the
                # strings themselves in the object chunk
                src_ref = _node_dict_ref(plan, i)
                src = self.dict_by_ref(src_ref) if src_ref else None
                if src is None:
                    raise NotSupported("UPDATE from computed strings")
                strings = src.get_strings(np.asarray(arr).astype(np.int64))
                arr = np.empty(len(strings), object)
                arr[:] = strings
            elif src_ti.kind != cd.type.kind or (
                    cd.type.is_decimal and src_ti.scale != cd.type.scale):
                arr = _host_cast_array(arr, src_ti, cd.type)
            new_cols[cd.col_id] = arr
        old_gen = t.generation
        self.last_mutation["fragments"] = t.update_rows_at(rowids, new_cols)
        self.executor.patch_cache_update(t, old_gen, rowids, new_cols)
        return None

    def _delete(self, st: A.Delete) -> None:
        t = self.catalog.get_table(st.table)
        _reject_foreign_write(t)
        if st.where is None:
            self.last_mutation = dict(rows=t.num_rows,
                                      fragments=[f.fragment_id for f in t.fragments])
            t.delete_all()
            return None
        rowids, _, _ = self._matched_rows_and_values(t, st.where, [])
        self.last_mutation = dict(rows=int(rowids.shape[0]), fragments=[])
        if rowids.shape[0]:
            old_gen, old_n = t.generation, t.num_rows
            self.last_mutation["fragments"] = t.delete_rows_at(rowids)
            self.executor.patch_cache_delete(t, old_gen, old_n, rowids)
        return None

    def _insert_values(self, st: A.InsertValues) -> None:
        t = self.catalog.get_table(st.table)
        _reject_foreign_write(t)
        target_cols = ([_col_of(t, c) for c in st.columns] if st.columns
                       else list(t.columns))
        binder = ExprBinder(Scope(), self, allow_aggs=False)
        by_col: Dict[int, list] = {cd.col_id: [] for cd in t.columns}
        for row in st.rows:
            if len(row) != len(target_cols):
                raise SqlError("INSERT value count mismatch")
            provided = {}
            for cd, expr_ast in zip(target_cols, row):
                if cd.type.is_array:
                    provided[cd.col_id] = _array_literal_value(expr_ast, cd, binder)
                    continue
                provided[cd.col_id] = _const_value(binder.bind(expr_ast), cd.type)
            for cd in t.columns:
                if cd.col_id in provided:
                    by_col[cd.col_id].append(provided[cd.col_id])
                elif cd.default is not None:
                    by_col[cd.col_id].append(cd.default)
                elif cd.type.nullable:
                    by_col[cd.col_id].append(None)
                else:
                    raise SqlError(f"column {cd.name} has no default and is NOT NULL")
        arrays = {}
        for cd in t.columns:
            vals = by_col[cd.col_id]
            if cd.type.is_array:
                arrays[cd.col_id] = to_physical(vals, cd.type, t.dicts.get(cd.col_id))
            elif cd.type.is_dict_string:
                arrays[cd.col_id] = t.dict_for(cd.col_id).get_or_add_bulk(vals)
            elif cd.type.is_none_string:
                arrays[cd.col_id] = to_physical(vals, cd.type, None)
            else:
                # _const_value already produced PHYSICAL values
                sent = cd.type.null_sentinel()
                arrays[cd.col_id] = np.array(
                    [sent if v is None else v for v in vals], cd.type.np_dtype())
        t.insert_columns(arrays)


def load_state(db: Database, tables, dicts=None, fragment_size=None) -> None:
    """Build tables in `db` from definitions and PHYSICAL host columns.

    tables: [(name, [(col, type_name)], {col: np.ndarray})] — type_name is
    SQL ("INT", "DOUBLE NOT NULL", "TEXT", ...); arrays hold the stored
    representation (null sentinels, dictionary ids; the strings and None of
    a TEXT ENCODING NONE column).
    dicts: {table: {col: [string, ...]}} — each TEXT column's dictionary
    vocabulary in id order, so the stored ids keep their strings.
    fragment_size: rows per fragment for every table (None = default)."""
    dicts = {k.lower(): {c.lower(): v for c, v in d.items()}
             for k, d in (dicts or {}).items()}
    for name, coldefs, columns in tables:
        opts = f" WITH (fragment_size={int(fragment_size)})" if fragment_size else ""
        db.sql(f"CREATE TABLE {name} ("
               + ", ".join(f"{c} {ty}" for c, ty in coldefs) + ")" + opts)
        t = db.catalog.get_table(name)
        vocab = dicts.get(name.lower(), {})
        arrays = {}
        for cd in t.columns:
            if cd.type.is_dict_string:
                d = t.dict_for(cd.col_id)
                for s in vocab.get(cd.name.lower(), ()):
                    d.get_or_add(str(s))
            key = next(k for k in columns if k.lower() == cd.name.lower())
            if cd.type.is_none_string:
                arrays[cd.col_id] = to_physical(columns[key], cd.type)
                continue
            arrays[cd.col_id] = np.ascontiguousarray(
                np.asarray(columns[key]).astype(cd.type.np_dtype(), copy=False))
        if arrays and next(iter(arrays.values())).shape[0]:
            t.insert_columns(arrays)
    db.executor.drop_stale()


_DEVICE_COLUMN_TYPES = {
    torch.int16: T.smallint, torch.int32: T.integer, torch.int64: T.bigint,
    torch.float32: T.float_, torch.float64: T.double,
}


def _device_chunk_stats(a: torch.Tensor, sentinel, bounds) -> List[ChunkStats]:
    """min / max / has_nulls of each fragment [s, e) of a device column,
    computed on the device and read back in one copy."""
    fp = a.is_floating_point()
    acc = torch.float64 if fp else torch.int64
    lo = float("inf") if fp else torch.iinfo(a.dtype).max
    hi = float("-inf") if fp else torch.iinfo(a.dtype).min
    parts = []
    for s, e in bounds:
        af = a[s:e]
        ok = ~torch.isnan(af) if fp else af != sentinel
        parts.append(torch.stack([torch.where(ok, af, lo).amin().to(acc),
                                  torch.where(ok, af, hi).amax().to(acc),
                                  (~ok).sum().to(acc)]))
    out = []
    for (s, e), (mn, mx, nulls) in zip(bounds, torch.stack(parts).tolist()):
        st = ChunkStats(has_nulls=int(nulls) > 0)
        if int(nulls) < e - s:
            st.min, st.max = mn, mx
        out.append(st)
    return out


def _col_of(t: Table, name: str):
    cd = t.column_by_name(name)
    if cd is None:
        raise SqlError(f"no column {name!r} in {t.name}")
    return cd


def _reject_foreign_write(t) -> None:
    if getattr(t, "foreign", None) is not None:
        raise SqlError(f"foreign table {t.name!r} is read-only (REFRESH FOREIGN "
                       "TABLES to re-import)")


def _const_value(e: E.Expr, target: T.TypeInfo):
    if isinstance(e, E.Constant):
        if e.value is None:
            return None
        if target.is_dict_string or target.is_none_string:
            if not e.type.is_string:
                raise SqlError(f"cannot insert {e.type} into TEXT column")
            return str(e.value)
        return _const_cast(e.value, e.type, target)
    raise NotSupported("INSERT VALUES requires constant expressions")


def _array_literal_value(expr_ast, cd, binder):
    """An array column's value in INSERT VALUES: {...} / ARRAY[...] -> a
    list of element values, a WKT string (or ST_GeomFromText of one) for a
    geo column, NULL -> None (the reference's Importer addArray)."""
    if isinstance(expr_ast, A.Literal) and expr_ast.kind == "null":
        return None
    if cd.type.is_geo:
        if isinstance(expr_ast, A.FuncCall) and expr_ast.name in (
                "ST_GEOMFROMTEXT", "ST_GEOGFROMTEXT"):
            expr_ast = expr_ast.args[0]
        if isinstance(expr_ast, A.Literal) and expr_ast.kind == "string":
            return expr_ast.value  # WKT; to_physical parses it
        raise SqlError(f"column {cd.name} expects a WKT literal")
    if not isinstance(expr_ast, A.ArrayLiteral):
        raise SqlError(f"column {cd.name} expects an array literal")
    eti = cd.type.elem_type()
    out = []
    for item in expr_ast.items:
        e = binder.bind(item)
        if eti.is_dict_string:
            if not isinstance(e, E.Constant):
                raise SqlError("array literal elements must be constant")
            out.append(None if e.value is None else str(e.value))
        else:
            out.append(_const_value(e, eti))
    return out


def _host_cast_array(arr: np.ndarray, src: T.TypeInfo, dst: T.TypeInfo) -> np.ndarray:
    """A host column from src's physical representation to dst's, NULLs
    kept (DECIMAL scaled; an integer target truncates)."""
    nulls = np.isnan(arr) if arr.dtype.kind == "f" else arr == src.null_sentinel()
    real = arr.astype(np.float64)
    if src.is_decimal:
        real = real / 10**src.scale
    dt = dst.np_dtype()
    if dst.is_decimal:
        out = np.round(real * 10**dst.scale).astype(np.int64)
    elif dt.kind == "f":
        out = real.astype(dt)
    else:
        out = np.trunc(real).astype(dt)
    out[nulls] = np.nan if dt.kind == "f" else dst.null_sentinel()
    return out


def _iter_all_exprs(node):
    yield from _iter_node_exprs(node)
    if isinstance(node, R.Window):
        yield from node.wfuncs
    if isinstance(node, R.Project):
        yield from node.exprs
    if isinstance(node, R.Filter):
        yield node.condition
    if isinstance(node, R.Aggregate):
        yield from node.group_exprs
        yield from node.agg_exprs


def _string_result(name: str, values: List[str]) -> ResultSet:
    return ResultSet([name], [T.TypeInfo(T.SQLTypeKind.TEXT, False)],
                     [np.array(values, object)], [None])


def _query_counters(ex) -> dict:
    """The calling thread's executor counters and each hand kernel's
    launches: the root of a SELECT's tree carries their change."""
    return {"h2d_bytes": ex.h2d_bytes, "waves_run": ex.waves_run,
            "kernel_builds": ex.kernel_builds, "launches": launch_counts()}


def _stmt_tables(st) -> list:
    """Table names a statement touches, for privilege checks."""
    out = []

    def from_ref(r):
        if isinstance(r, A.NamedTable):
            out.append(r.name)
        elif isinstance(r, A.JoinRef):
            from_ref(r.left)
            from_ref(r.right)
        elif isinstance(r, A.SubqueryRef):
            from_select(r.select)

    def from_select(sel):
        from_ref(sel.from_)
        for _, cte in sel.ctes:
            from_select(cte)
        for _, rhs in sel.set_ops:
            from_select(rhs)

    if isinstance(st, A.Select):
        from_select(st)
    elif isinstance(st, (A.InsertValues, A.Update, A.Delete, A.CopyFrom, A.TruncateTable)):
        out.append(getattr(st, "table", getattr(st, "name", "")))
    elif isinstance(st, A.InsertSelect):
        out.append(st.table)
        from_select(st.select)
    elif isinstance(st, A.CreateTable):
        out.append(st.name)
        if st.as_select is not None:
            from_select(st.as_select)
    elif isinstance(st, A.DropTable):
        out.append(st.name)
    return [t for t in out if t]


def _normalize_tabular(data) -> Dict[str, np.ndarray]:
    try:
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            return {c: data[c].to_numpy() for c in data.columns}
    except ImportError:
        pass
    if isinstance(data, dict):
        out = {}
        for k, v in data.items():
            if isinstance(v, list) and any(isinstance(x, (list, tuple, np.ndarray))
                                           for x in v):
                # a ragged list of lists (an array column): object rows
                a = np.empty(len(v), object)
                for i, x in enumerate(v):
                    a[i] = x
                out[k] = a
            else:
                out[k] = np.asarray(v)
        return out
    raise StorageError(f"cannot load {type(data)}")


def _infer_type_values(vals) -> T.TypeInfo:
    """SQL type from a sample of python values (a DB-API cursor's rows,
    whose column types DB-API does not give)."""
    seen = {type(v) for v in vals if v is not None}
    if not seen:
        return T.text_dict()
    if seen <= {bool}:
        return T.boolean()
    if seen <= {int, bool}:
        return T.bigint()
    if seen <= {int, float, bool}:
        return T.double()
    return T.text_dict()


def _infer_type(arr: np.ndarray) -> T.TypeInfo:
    k = arr.dtype.kind
    if k == "b":
        return T.boolean()
    if k == "i":
        return T.bigint() if arr.dtype.itemsize > 4 else T.integer()
    if k == "f":
        return T.double()
    if k in ("U", "O"):
        return T.text_dict()
    if k == "M":
        return T.timestamp()
    raise StorageError(f"cannot infer SQL type for dtype {arr.dtype}")


def _register_system_tfs(registry, db=None):
    """Built-in table functions (reference SystemFunctions/os/ subset), a
    copy of heavydb_tpu/api.py's: numpy on the host."""

    def generate_series(*args, cursor=None):
        start = int(args[0])
        stop = int(args[1])
        step = int(args[2]) if len(args) > 2 else 1
        return {"generate_series": np.arange(start, stop + (1 if step > 0 else -1), step, dtype=np.int64)}

    def tf_mandelbrot(*args, cursor=None):  # parity playground TF
        x_pixels = int(args[0])
        y_pixels = int(args[1])
        xs = np.linspace(-2.0, 1.0, x_pixels)
        ys = np.linspace(-1.5, 1.5, y_pixels)
        c = xs[None, :] + 1j * ys[:, None]
        z = np.zeros_like(c)
        it = np.zeros(c.shape, np.int32)
        for i in range(64):
            m = np.abs(z) <= 2
            z = np.where(m, z * z + c, z)
            it += m
        yy, xx = np.meshgrid(range(y_pixels), range(x_pixels), indexing="ij")
        return {
            "x": xx.ravel().astype(np.int32),
            "y": yy.ravel().astype(np.int32),
            "num_iterations": it.ravel(),
        }

    # ---- ML table functions (reference TableFunctions/SystemFunctions/
    # os/ML: LINEAR_REG_FIT/PREDICT, KMEANS, PCA via oneDAL — here as
    # closed-form / Lloyd's numpy implementations over CURSOR inputs) ----
    def linear_reg_fit(*args, cursor=None):
        """CURSOR(SELECT y, x1 [, x2 ...]) → one coefficient per row
        (intercept first), least squares."""
        cols = list(cursor.values())
        y = np.asarray(cols[0], np.float64)
        X = np.column_stack(
            [np.ones_like(y)] + [np.asarray(c, np.float64) for c in cols[1:]]
        )
        ok = np.isfinite(y)
        for j in range(1, X.shape[1]):
            ok &= np.isfinite(X[:, j])
        coef, *_ = np.linalg.lstsq(X[ok], y[ok], rcond=None)
        return {
            "coef_idx": np.arange(len(coef), dtype=np.int32),
            "coef": coef,
        }

    def linear_reg_predict(*args, cursor=None):
        """CURSOR(SELECT id, x1 [, x2 ...]) + coef args → predictions."""
        cols = list(cursor.values())
        ids = np.asarray(cols[0])
        X = np.column_stack(
            [np.ones(len(ids))]
            + [np.asarray(c, np.float64) for c in cols[1:]]
        )
        coef = np.asarray([float(a) for a in args], np.float64)
        return {"id": ids, "prediction": X @ coef}

    def kmeans(*args, cursor=None):
        """CURSOR(SELECT id, f1 [, f2 ...]), k[, iters] → cluster per row
        (Lloyd's algorithm, k-means++ style farthest-point seeding)."""
        cols = list(cursor.values())
        ids = np.asarray(cols[0])
        X = np.column_stack([np.asarray(c, np.float64) for c in cols[1:]])
        k = int(args[0])
        iters = int(args[1]) if len(args) > 1 else 20
        rng = np.random.default_rng(0)
        cent = X[rng.choice(len(X), 1)]
        while len(cent) < k:
            d = ((X[:, None, :] - cent[None]) ** 2).sum(-1).min(1)
            cent = np.vstack([cent, X[d.argmax()][None]])
        for _ in range(iters):
            a = ((X[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
            for j in range(k):
                if (a == j).any():
                    cent[j] = X[a == j].mean(0)
        return {"id": ids, "cluster_id": a.astype(np.int32)}

    def pca_project(*args, cursor=None):
        """CURSOR(SELECT id, f1, f2, ...), n_components → projections onto
        the top principal components."""
        cols = list(cursor.values())
        ids = np.asarray(cols[0])
        X = np.column_stack([np.asarray(c, np.float64) for c in cols[1:]])
        nc = int(args[0]) if args else min(2, X.shape[1])
        Xc = X - X.mean(0)
        _, _, vt = np.linalg.svd(Xc, full_matrices=False)
        proj = Xc @ vt[:nc].T
        out = {"id": ids}
        for j in range(nc):
            out[f"pc{j + 1}"] = proj[:, j]
        return out

    def tf_compute_dwell_times(*args, cursor=None):
        """CURSOR(SELECT entity_id, site_id, ts) → per-visit dwell times
        (reference SystemFunctions tf_compute_dwell_times: sessionize by
        entity, dwell = next-ts - ts within entity)."""
        cols = list(cursor.values())
        ent = np.asarray(cols[0])
        site = np.asarray(cols[1])
        ts = np.asarray(cols[2], np.int64)
        order = np.lexsort((ts, ent))
        ent_s, site_s, ts_s = ent[order], site[order], ts[order]
        same_next = np.zeros(len(ent), bool)
        if len(ent):
            same_next[:-1] = ent_s[:-1] == ent_s[1:]
        dwell = np.where(
            same_next, np.roll(ts_s, -1) - ts_s, -1
        ).astype(np.int64)
        keep = dwell >= 0
        return {
            "entity_id": ent_s[keep],
            "site_id": site_s[keep],
            "ts": ts_s[keep],
            "dwell_time_sec": dwell[keep],
        }

    # ---- tree-model regression (reference DECISION_TREE_REG_FIT /
    # RANDOM_FOREST_REG_FIT / GBT_REG_FIT / ML_REG_PREDICT / R2_SCORE,
    # TableFunctions/SystemFunctions/os/ML + MLPredictCodegen.cpp).
    # Fitted models live in a per-connection named registry the way the
    # reference's MLModelMap does; prediction is the branch-free gather
    # ladder in ops/ml.py. ----
    def _cursor_xy(cursor):
        cols = list(cursor.values())
        if len(cols) < 2:
            raise NotSupported(
                "ML fit cursor needs a target column followed by at least "
                "one feature column"
            )
        y = np.asarray(cols[0], np.float64)
        X = np.column_stack([np.asarray(c, np.float64) for c in cols[1:]])
        ok = np.isfinite(y)
        for j in range(X.shape[1]):
            ok &= np.isfinite(X[:, j])
        return X[ok], y[ok]

    def _fit_summary(name, model):
        if db is not None:
            db._ml_models[str(name).lower()] = model
        return {
            "model_name": np.array([str(name)], object),
            "kind": np.array([model.kind], object),
            "n_trees": np.array([len(model.trees)], np.int32),
            "n_features": np.array([model.n_features], np.int32),
        }

    def decision_tree_reg_fit(*args, cursor=None):
        """(model_name [, max_depth [, min_leaf]], CURSOR(y, x1..xk))"""
        from heavydb_tpu_torch.ops import ml

        X, y = _cursor_xy(cursor)
        depth = int(args[1]) if len(args) > 1 else 8
        leaf = int(args[2]) if len(args) > 2 else 4
        return _fit_summary(args[0], ml.fit_single(X, y, depth, leaf))

    def random_forest_reg_fit(*args, cursor=None):
        """(model_name [, n_trees [, max_depth]], CURSOR(y, x1..xk))"""
        from heavydb_tpu_torch.ops import ml

        X, y = _cursor_xy(cursor)
        n_trees = int(args[1]) if len(args) > 1 else 16
        depth = int(args[2]) if len(args) > 2 else 8
        return _fit_summary(
            args[0], ml.fit_forest(X, y, n_trees=n_trees, max_depth=depth))

    def gbt_reg_fit(*args, cursor=None):
        """(model_name [, n_trees [, max_depth [, learning_rate]]],
        CURSOR(y, x1..xk))"""
        from heavydb_tpu_torch.ops import ml

        X, y = _cursor_xy(cursor)
        n_trees = int(args[1]) if len(args) > 1 else 32
        depth = int(args[2]) if len(args) > 2 else 3
        lr = float(args[3]) if len(args) > 3 else 0.2
        return _fit_summary(
            args[0], ml.fit_gbt(X, y, n_trees=n_trees, max_depth=depth,
                                learning_rate=lr))

    def _get_model(name):
        m = (db._ml_models if db is not None else {}).get(
            str(name).lower())
        if m is None:
            raise ValueError(f"unknown ML model {name!r}")
        return m

    def ml_reg_predict(*args, cursor=None):
        """(model_name, CURSOR(id, x1..xk)) → id, prediction"""
        m = _get_model(args[0])
        cols = list(cursor.values())
        ids = np.asarray(cols[0])
        X = np.column_stack([np.asarray(c, np.float64) for c in cols[1:]])
        pred = m.predict(X)
        # rows with non-finite features were dropped at fit time; at
        # predict time they must yield NULL, not an arbitrary tree path
        bad = ~np.isfinite(X).all(axis=1)
        if bad.any():
            pred = np.where(bad, np.nan, pred)
        return {"id": ids, "prediction": pred}

    def r2_score(*args, cursor=None):
        """(model_name, CURSOR(y, x1..xk)) → coefficient of determination"""
        m = _get_model(args[0])
        X, y = _cursor_xy(cursor)
        pred = m.predict(X)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        if ss_tot:
            r2 = 1.0 - ss_res / ss_tot
        else:
            # constant y: a perfect fit scores 1.0 (sklearn convention)
            r2 = 1.0 if ss_res == 0.0 else 0.0
        return {"r2": np.array([r2], np.float64)}

    def ml_models(*args, cursor=None):
        names = sorted(db._ml_models) if db is not None else []
        return {
            "model_name": np.array(names, object),
            "kind": np.array(
                [db._ml_models[n].kind for n in names], object),
        }

    registry["decision_tree_reg_fit"] = decision_tree_reg_fit
    registry["random_forest_reg_fit"] = random_forest_reg_fit
    registry["gbt_reg_fit"] = gbt_reg_fit
    registry["ml_reg_predict"] = ml_reg_predict
    registry["r2_score"] = r2_score
    registry["ml_models"] = ml_models

    registry["generate_series"] = generate_series
    registry["tf_mandelbrot"] = tf_mandelbrot
    registry["linear_reg_fit"] = linear_reg_fit
    registry["linear_reg_predict"] = linear_reg_predict
    registry["kmeans"] = kmeans
    registry["pca_project"] = pca_project
    registry["tf_compute_dwell_times"] = tf_compute_dwell_times
