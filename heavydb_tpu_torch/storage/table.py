"""Columnar table storage: descriptors, fragments, chunk metadata.

Role of the reference's Catalog/TableDescriptor.h + Fragmenter/
InsertOrderFragmenter + DataMgr/Chunk + ChunkMetadata: a table is a list of
row-wise *fragments*; each fragment holds one dense numpy array per column
("chunk") plus per-chunk stats {min, max, has_nulls} used for perfect-hash
range decisions and fragment skipping (reference Executor::skipFragment,
Execute.cpp:4776).

TPU-first deviations from the reference:
- The host master copy is numpy; the device working set is a per-table cache
  of concatenated, block-padded device tensors (padding uses null sentinels), so
  ONE compiled XLA program serves any number of fragments — the analogue of
  HeavyDB's multifrag GPU kernels (RuntimeFunctions.cpp multifrag_query).
- Null storage is in-band sentinels (types.TypeInfo.null_sentinel), never
  bitmaps, matching Shared/InlineNullValues.h.
"""

from __future__ import annotations

import datetime as _dt
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import CatalogError, StorageError
from heavydb_tpu_torch.storage.string_dict import StringDictionary

EPOCH = _dt.date(1970, 1, 1)


@dataclass
class ColumnDescriptor:
    name: str
    type: T.TypeInfo
    col_id: int  # 1-based like the reference
    default: Optional[object] = None
    # COMMENT ON COLUMN (reference Catalog::setColumnComment)
    comment: Optional[str] = None


@dataclass
class ChunkStats:
    """Per-(fragment, column) metadata (reference DataMgr/ChunkMetadata.h:56)."""

    min: object = None
    max: object = None
    has_nulls: bool = False
    num_rows: int = 0


class Fragment:
    def __init__(self, fragment_id: int, capacity: int):
        self.fragment_id = fragment_id
        self.capacity = capacity
        self.num_rows = 0
        self.chunks: Dict[int, np.ndarray] = {}  # col_id -> values
        self.stats: Dict[int, ChunkStats] = {}
        # columns mutated in place since the last checkpoint (reference
        # Chunk dirty flags; append-only row counts don't catch these)
        self.dirty_cols: set = set()

    def append(self, col_arrays: Dict[int, np.ndarray], start: int, n: int):
        for col_id, arr in col_arrays.items():
            piece = arr[start : start + n]
            if col_id in self.chunks:
                self.chunks[col_id] = np.concatenate([self.chunks[col_id], piece])
            else:
                self.chunks[col_id] = piece.copy()
        self.num_rows += n

    def compute_stats(self, cd: ColumnDescriptor):
        vals = self.chunks[cd.col_id]
        st = ChunkStats(num_rows=self.num_rows)
        if cd.type.is_none_string:
            st.has_nulls = any(v is None for v in vals)
            self.stats[cd.col_id] = st
            return st
        if cd.type.is_array:
            # stats over the flattened elements (reference ArrayNoneEncoder
            # updateStats walks every element)
            st.has_nulls = any(row is None for row in vals)
            parts = [row for row in vals if row is not None and row.size]
            if parts:
                flat = np.concatenate(parts)
                eti = cd.type.elem_type()
                if flat.dtype.kind == "f":
                    valid = flat[~np.isnan(flat)]
                else:
                    valid = flat[flat != eti.null_sentinel()]
                st.has_nulls = st.has_nulls or valid.size < flat.size
                if valid.size:
                    st.min = valid.min().item()
                    st.max = valid.max().item()
            self.stats[cd.col_id] = st
            return st
        if vals.size:
            if vals.dtype.kind == "f":
                valid = vals[~np.isnan(vals)]
            else:
                valid = vals[vals != cd.type.null_sentinel()]
            st.has_nulls = valid.size < vals.size
            if valid.size:
                st.min = valid.min().item()
                st.max = valid.max().item()
        else:
            st.has_nulls = False
        self.stats[cd.col_id] = st
        return st


def torch_to_np_dtype(dt) -> np.dtype:
    """numpy dtype of a torch dtype (bool/int/float widths the engine uses)."""
    return np.dtype(str(dt).replace("torch.", ""))


class LazyDeviceChunk:
    """Host-master chunk backed by a DEVICE array (api.load_table_device):
    quacks like a read-only numpy array; materializes via one D2H on first
    host access (checkpoint, UPDATE, COPY TO).  Query execution never
    touches it — the device scan cache is seeded directly at load."""

    def __init__(self, dev, start: int = 0, stop: Optional[int] = None):
        # (start, stop) bounds a fragment VIEW over a shared whole-table
        # device array — fragment slicing must not copy device memory
        # (a 1B-row ingest would double its HBM footprint otherwise)
        self.device_array = dev
        self.start = int(start)
        self.stop = int(dev.shape[0] if stop is None else stop)
        self._np: Optional[np.ndarray] = None
        self.dtype = torch_to_np_dtype(dev.dtype)
        self.shape = (self.stop - self.start,) + tuple(dev.shape[1:])
        self.size = int(np.prod(self.shape)) if self.shape else 1

    def _materialize(self) -> np.ndarray:
        if self._np is None:
            a = self.device_array
            if (self.start, self.stop) != (0, a.shape[0]):
                a = a[self.start:self.stop]
            self._np = a.cpu().numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self._materialize()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a

    def head(self, n: int) -> np.ndarray:
        """First n values WITHOUT materializing the fragment — one tiny
        D2H (estimators sample prefixes; a full fetch over the relay
        costs seconds per 20M rows)."""
        if self._np is not None:
            return self._np[:n]
        stop = min(self.start + int(n), self.stop)
        return self.device_array[self.start:stop].cpu().numpy()

    def __getitem__(self, i):
        return self._materialize()[i]

    def __len__(self):
        return self.shape[0]

    def min(self, *a, **k):
        return self._materialize().min(*a, **k)

    def max(self, *a, **k):
        return self._materialize().max(*a, **k)

    def copy(self):
        return self._materialize().copy()

    def astype(self, dt):
        return self._materialize().astype(dt)

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize


class Table:
    """A table: descriptor + fragments + per-dict-column StringDictionary."""

    def __init__(
        self,
        table_id: int,
        name: str,
        columns: Sequence[ColumnDescriptor],
        fragment_rows: int,
        is_temporary: bool = False,
    ):
        self.table_id = table_id
        self.name = name
        self.columns: List[ColumnDescriptor] = list(columns)
        self.fragment_rows = fragment_rows
        self.is_temporary = is_temporary
        self.fragments: List[Fragment] = []
        self.dicts: Dict[int, StringDictionary] = {}  # col_id -> dict
        for cd in self.columns:
            if cd.type.is_dict_string or (
                cd.type.is_array and cd.type.elem_type().is_dict_string
            ):
                self.dicts[cd.col_id] = StringDictionary(dict_id=cd.col_id)
        # SHARD KEY metadata (reference TableDescriptor.h:59-66)
        self.shard_key: Optional[str] = None
        self.shard_count = 0
        # per-batch insert ordering (reference sortedColumnId)
        self.sort_column: Optional[str] = None
        # COMMENT ON TABLE (reference Catalog::setTableComment)
        self.comment: Optional[str] = None
        # generation bumps on every data mutation; device caches key on it
        # (reference TableGenerations for multi-host snapshot consistency)
        self.generation = 0
        self._lock = threading.RLock()

    # ---- schema helpers ----
    def column_by_name(self, name: str) -> Optional[ColumnDescriptor]:
        lname = name.lower()
        for cd in self.columns:
            if cd.name.lower() == lname:
                return cd
        return None

    def column_by_id(self, col_id: int) -> ColumnDescriptor:
        for cd in self.columns:
            if cd.col_id == col_id:
                return cd
        raise CatalogError(f"no column id {col_id} in {self.name}")

    @property
    def num_rows(self) -> int:
        return sum(f.num_rows for f in self.fragments)

    def dict_for(self, col_id: int) -> StringDictionary:
        d = self.dicts.get(col_id)
        if d is not None:
            return d
        cd = self.column_by_id(col_id)
        if cd.type.is_none_string:
            return self.lazy_text_dict(col_id)[0]
        return self.dicts[col_id]

    def lazy_text_dict(self, col_id: int):
        """Per-generation dictionary over a none-encoded TEXT column
        (reference StringDictionaryProxy: transient interning at query
        time).  Returns (dict, ids[num_rows] int32).  Rebuilt when the
        table mutates; only the CURRENT generation is kept."""
        cache = getattr(self, "_lazy_text", None)
        if cache is None:
            cache = self._lazy_text = {}
        key = (col_id, self.generation)
        hit = cache.get(key)
        if hit is not None:
            return hit
        with self._lock:
            hit = cache.get(key)
            if hit is not None:
                return hit
            parts = [f.chunks[col_id] for f in self.fragments
                     if f.num_rows]
            vals = []
            for pc in parts:
                vals.extend(np.asarray(pc, object).tolist())
            d = StringDictionary(dict_id=col_id)
            ids = d.get_or_add_bulk(vals) if vals \
                else np.empty(0, np.int32)
            # drop stale generations (ids arrays are O(rows))
            for k in [k for k in cache if k[0] == col_id]:
                cache.pop(k)
            cache[key] = (d, ids)
            return d, ids

    def fragments_by_id(self) -> Dict[int, Fragment]:
        return {f.fragment_id: f for f in self.fragments}

    # ---- ingest ----
    def insert_columns(self, col_arrays: Dict[int, np.ndarray]):
        """Append physical (already-converted) column arrays.  All arrays must
        have equal length.  Reference: InsertOrderFragmenter::insertData."""
        lens = {a.shape[0] for a in col_arrays.values()}
        if len(lens) != 1:
            raise StorageError(f"ragged insert: lengths {lens}")
        (n,) = lens
        if set(col_arrays) != {cd.col_id for cd in self.columns}:
            raise StorageError("insert must cover all columns")
        # sort_column (reference TableDescriptor sortedColumnId): order each
        # incoming batch by the column so fragment min/max ranges tighten
        # and fragment skipping prunes harder
        sc = getattr(self, "sort_column", None)
        if sc and n > 1:
            cd = self.column_by_name(sc)
            if cd is not None and cd.col_id in col_arrays \
                    and not cd.type.is_array:
                order = np.argsort(col_arrays[cd.col_id], kind="stable")
                col_arrays = {
                    cid: np.ascontiguousarray(a[order])
                    for cid, a in col_arrays.items()
                }
        with self._lock:
            pos = 0
            while pos < n:
                if not self.fragments or (
                    self.fragments[-1].num_rows >= self.fragment_rows
                ):
                    self.fragments.append(
                        Fragment(len(self.fragments), self.fragment_rows)
                    )
                frag = self.fragments[-1]
                room = self.fragment_rows - frag.num_rows
                take = min(room, n - pos)
                frag.append(col_arrays, pos, take)
                pos += take
            # refresh stats for affected fragments lazily: recompute all stats of
            # the last fragments touched
            for frag in self.fragments:
                for cd in self.columns:
                    if cd.col_id not in frag.stats or frag.stats[
                        cd.col_id
                    ].num_rows != frag.num_rows:
                        frag.compute_stats(cd)
            self.generation += 1

    def _fragment_offsets(self) -> np.ndarray:
        return np.cumsum([0] + [f.num_rows for f in self.fragments])

    def update_rows_at(self, rowids: np.ndarray,
                       new_cols: Dict[int, np.ndarray]) -> List[int]:
        """Fragment-level in-place UPDATE addressed by GLOBAL row
        position: only fragments containing a targeted row are touched,
        and only the SET columns are copied (reference
        Fragmenter/UpdelStorage.cpp:55 updateColumn — the update kernel
        yields row offsets, the fragmenter patches chunks in place).
        new_cols arrays are MATCH-ordered (aligned with rowids), not
        table-length.  Returns the touched fragment ids."""
        touched: List[int] = []
        if len(rowids) == 0:
            return touched
        with self._lock:
            offs = self._fragment_offsets()
            rid = np.asarray(rowids, np.int64)
            order = np.argsort(rid, kind="stable")
            rid = rid[order]
            fidx = np.searchsorted(offs, rid, side="right") - 1
            for fi in np.unique(fidx):
                frag = self.fragments[int(fi)]
                sel = fidx == fi
                local = (rid[sel] - offs[fi]).astype(np.int64)
                for cid, vals in new_cols.items():
                    v = np.asarray(vals)[order][sel]
                    chunk = np.array(frag.chunks[cid], copy=True)
                    chunk[local] = v.astype(chunk.dtype, copy=False)
                    frag.chunks[cid] = chunk
                    frag.dirty_cols.add(cid)
                for cd in self.columns:
                    if cd.col_id in new_cols:
                        frag.compute_stats(cd)
                touched.append(int(fi))
            self.generation += 1
        return touched

    def delete_rows_at(self, rowids: np.ndarray) -> List[int]:
        """Fragment-level DELETE addressed by GLOBAL row position:
        compacts only the fragments that lose rows (reference: $deleted
        column + vacuum, Fragmenter/UpdelStorage.cpp compactRows; we
        compact eagerly — fragment-local, so the cost is O(touched
        fragments), not O(table)).  Returns the touched fragment ids."""
        touched: List[int] = []
        if len(rowids) == 0:
            return touched
        with self._lock:
            offs = self._fragment_offsets()
            rid = np.unique(np.asarray(rowids, np.int64))
            fidx = np.searchsorted(offs, rid, side="right") - 1
            for fi in np.unique(fidx):
                frag = self.fragments[int(fi)]
                local = (rid[fidx == fi] - offs[fi]).astype(np.int64)
                keep = np.ones(frag.num_rows, bool)
                keep[local] = False
                for cid in list(frag.chunks):
                    frag.chunks[cid] = np.asarray(frag.chunks[cid])[keep]
                frag.num_rows = int(keep.sum())
                frag.dirty_cols.update(frag.chunks.keys())
                for cd in self.columns:
                    frag.compute_stats(cd)
                touched.append(int(fi))
            self.generation += 1
        return touched

    def delete_all(self):
        with self._lock:
            self.fragments = []
            self.generation += 1

    def add_column(self, name: str, ti: T.TypeInfo, default=None):
        """ALTER TABLE ADD COLUMN (reference Catalog::addColumn + fragmenter
        backfill).  Existing rows get the default (or NULL)."""
        with self._lock:
            if self.column_by_name(name) is not None:
                raise CatalogError(f"column {name!r} already exists")
            col_id = max((cd.col_id for cd in self.columns), default=0) + 1
            cd = ColumnDescriptor(name, ti, col_id, default)
            self.columns.append(cd)
            if ti.is_dict_string or (
                ti.is_array and ti.elem_type().is_dict_string
            ):
                self.dicts[col_id] = StringDictionary(dict_id=col_id)
            fill_vals = [default] if default is not None else [None]
            # a scalar column repeats the default's one physical value; an
            # array, geo or none-encoded TEXT column keeps an object a row
            one = None
            if not (ti.is_array or ti.is_geo or ti.is_none_string):
                one = to_physical(fill_vals, ti, self.dicts.get(col_id))
            for frag in self.fragments:
                if one is not None:
                    frag.chunks[col_id] = np.full(frag.num_rows, one[0], one.dtype)
                else:
                    frag.chunks[col_id] = to_physical(
                        fill_vals * frag.num_rows, ti, self.dicts.get(col_id)
                    )
                frag.compute_stats(cd)
            self.generation += 1
            return cd

    def drop_column(self, name: str):
        with self._lock:
            cd = self.column_by_name(name)
            if cd is None:
                raise CatalogError(f"no column {name!r}")
            if len(self.columns) == 1:
                raise CatalogError("cannot drop the last column")
            self.columns = [c for c in self.columns if c.col_id != cd.col_id]
            self.dicts.pop(cd.col_id, None)
            for frag in self.fragments:
                frag.chunks.pop(cd.col_id, None)
                frag.stats.pop(cd.col_id, None)
            self.generation += 1

    def alter_column_type(self, name: str, new_ti: T.TypeInfo):
        """ALTER TABLE … ALTER COLUMN … TYPE (reference
        Catalog/DdlCommandExecutor.h AlterTableAlterColumnCommand +
        AlterColumnRecovery.h).  Crash safety mirrors the reference's
        recovery manager by construction: every fragment's converted
        chunk is built BEFORE any is swapped in, the swap happens under
        the table lock, and persistence is the usual atomic epoch commit
        — an interrupted ALTER leaves the previous epoch intact, no
        recovery pass needed."""
        with self._lock:
            cd = self.column_by_name(name)
            if cd is None:
                raise CatalogError(f"no column {name!r}")
            old_ti = cd.type
            if old_ti == new_ti:
                return
            old_dict = self.dicts.get(cd.col_id)
            new_dict = (StringDictionary(dict_id=cd.col_id)
                        if new_ti.is_dict_string else None)
            converted = []
            for frag in self.fragments:
                vals = from_physical(
                    frag.chunks[cd.col_id][:frag.num_rows], old_ti, old_dict
                )
                if not new_ti.nullable and any(v is None for v in vals):
                    raise CatalogError(
                        f"column {name!r} contains NULLs; cannot alter "
                        "to NOT NULL"
                    )
                if new_ti.is_integer:
                    info = np.iinfo(new_ti.np_dtype())
                    lo, hi = info.min + 1, info.max  # min = null sentinel
                    coerced = []
                    for v in vals:
                        if v is None:
                            coerced.append(None)
                            continue
                        iv = int(v)
                        if not lo <= iv <= hi:
                            raise CatalogError(
                                f"value {v!r} out of range for "
                                f"{new_ti.sql_name()}"
                            )
                        coerced.append(iv)
                    vals = coerced
                elif new_ti.is_fp or new_ti.is_decimal:
                    vals = [None if v is None else float(v) for v in vals]
                elif new_ti.is_string:
                    vals = [None if v is None else str(v) for v in vals]
                converted.append(to_physical(vals, new_ti, new_dict))
            # all conversions succeeded — swap atomically under the lock
            for frag, chunk in zip(self.fragments, converted):
                frag.chunks[cd.col_id] = chunk
            cd.type = new_ti
            if new_dict is not None:
                self.dicts[cd.col_id] = new_dict
            elif old_dict is not None:
                self.dicts.pop(cd.col_id, None)
            for frag in self.fragments:
                frag.compute_stats(cd)
                frag.dirty_cols.add(cd.col_id)
            self.generation += 1

    def rename_column(self, old: str, new: str):
        with self._lock:
            cd = self.column_by_name(old)
            if cd is None:
                raise CatalogError(f"no column {old!r}")
            if self.column_by_name(new) is not None:
                raise CatalogError(f"column {new!r} already exists")
            cd.name = new
            self.generation += 1

    def recompute_metadata(self):
        """OPTIMIZE TABLE (reference TableOptimizer::recomputeMetadata)."""
        with self._lock:
            for frag in self.fragments:
                for cd in self.columns:
                    if cd.col_id in frag.chunks:
                        frag.compute_stats(cd)
            self.generation += 1

    # ---- reads ----
    def insert_device_columns(self, chunks: Dict[int, "LazyDeviceChunk"],
                              stats: Dict[int, ChunkStats]):
        """Append ONE fragment of device-resident chunks with stats
        precomputed on device (api.load_table_device): the host master
        stays lazy, the device scan cache is seeded by the caller."""
        self.insert_device_fragments([(chunks, stats)])

    def insert_device_fragments(self, frags):
        """Append device-resident fragments (list of (chunks, stats)) under
        ONE generation bump — api.load_table_device splits a bulk device
        ingest at fragment_rows boundaries so fragment-wave streaming and
        chunk-stat pruning work on device-loaded tables too."""
        with self._lock:
            for chunks, stats in frags:
                ns = {c.shape[0] for c in chunks.values()}
                if len(ns) != 1:
                    raise StorageError(f"ragged device insert: lengths {ns}")
                (n,) = ns
                if set(chunks) != {cd.col_id for cd in self.columns}:
                    raise StorageError("insert must cover all columns")
                frag = Fragment(
                    len(self.fragments), max(n, self.fragment_rows)
                )
                frag.num_rows = n
                frag.chunks = dict(chunks)
                for col_id, st in stats.items():
                    st.num_rows = n
                    frag.stats[col_id] = st
                self.fragments.append(frag)
            self.generation += 1

    def column_values(self, col_id: int) -> np.ndarray:
        """Concatenated host values for a column (exact length)."""
        cd = self.column_by_id(col_id)
        parts = [f.chunks[col_id] for f in self.fragments if f.num_rows]
        if not parts:
            return np.empty(0, cd.type.np_dtype())
        return np.concatenate(parts)

    def column_range(self, col_id: int) -> Tuple[object, object, bool]:
        """(min, max, has_nulls) across fragments, from chunk metadata only.
        Drives perfect-hash decisions (reference ExpressionRange)."""
        mn = mx = None
        has_nulls = False
        nullable = self.column_by_id(col_id).type.nullable
        for f in self.fragments:
            st = f.stats.get(col_id)
            if st is None:
                continue
            has_nulls = has_nulls or st.has_nulls
            if st.min is not None:
                mn = st.min if mn is None else min(mn, st.min)
                mx = st.max if mx is None else max(mx, st.max)
        return mn, mx, has_nulls and nullable


# ---------------------------------------------------------------------------
# Host-side value conversion at the ingest boundary (reference
# ImportExport/Importer TypedImportBuffer + DataConverters)
# ---------------------------------------------------------------------------


def _parse_date(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, _dt.datetime):
        return (v.date() - EPOCH).days
    if isinstance(v, _dt.date):
        return (v - EPOCH).days
    if isinstance(v, str):
        return (_dt.date.fromisoformat(v.strip()) - EPOCH).days
    raise StorageError(f"cannot convert {v!r} to DATE")


def _parse_timestamp(v, precision: int) -> int:
    mult = 10**precision
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, _dt.datetime):
        ts = v.replace(tzinfo=_dt.timezone.utc).timestamp()
        return int(round(ts * mult))
    if isinstance(v, _dt.date):
        return int((v - EPOCH).days) * 86400 * mult
    if isinstance(v, str):
        s = v.strip()
        dt = _dt.datetime.fromisoformat(s)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        return int(round(dt.timestamp() * mult))
    raise StorageError(f"cannot convert {v!r} to TIMESTAMP")


def _parse_time(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, _dt.time):
        return v.hour * 3600 + v.minute * 60 + v.second
    if isinstance(v, str):
        t = _dt.time.fromisoformat(v.strip())
        return t.hour * 3600 + t.minute * 60 + t.second
    raise StorageError(f"cannot convert {v!r} to TIME")


class RawText:
    """Un-decoded text column straight from the native CSV parser:
    (utf-8 payload bytes, int64 offsets[n+1], uint8 valid-mask[n]).
    Dict-encoded targets intern it without EVER materializing Python
    strings (strdict_ext.intern_payload); other consumers decode once
    via to_list()."""

    __slots__ = ("payload", "offsets", "mask")

    def __init__(self, payload: bytes, offsets: np.ndarray,
                 mask: np.ndarray):
        self.payload = payload
        self.offsets = np.ascontiguousarray(offsets, np.int64)
        self.mask = np.ascontiguousarray(mask, np.uint8)

    def __len__(self):
        return len(self.mask)

    def to_list(self):
        s = self.payload.decode("utf-8", "replace")
        # offsets are byte offsets — only valid as str indices when the
        # payload is pure ASCII; fall back to per-slice decode otherwise
        off = self.offsets
        if len(s) == len(self.payload):
            return [
                s[off[i]:off[i + 1]] if self.mask[i] else None
                for i in range(len(self.mask))
            ]
        p = self.payload
        return [
            p[off[i]:off[i + 1]].decode("utf-8", "replace")
            if self.mask[i] else None
            for i in range(len(self.mask))
        ]


def to_physical(
    values, ti: T.TypeInfo, sdict: Optional[StringDictionary] = None
) -> np.ndarray:
    """Convert a python/numpy/pandas sequence into the physical column array
    (sentinel nulls in-band)."""
    if isinstance(values, RawText):
        if ti.is_dict_string and sdict is not None \
                and hasattr(sdict, "get_or_add_payload"):
            return sdict.get_or_add_payload(values)
        values = values.to_list()
    if ti.is_none_string:
        # TEXT ENCODING NONE: raw strings in the host chunk (no global
        # dictionary maintained at ingest — interned lazily at query
        # time, storage/table.Table.lazy_text_dict)
        if isinstance(values, np.ndarray) and values.dtype == object:
            vals = values.tolist()
        else:
            vals = list(values)
        out = np.empty(len(vals), object)
        for i, v in enumerate(vals):
            if v is None or (isinstance(v, float) and np.isnan(v)):
                out[i] = None
            else:
                out[i] = str(v)
        return out
    if ti.is_array:
        # array column: object ndarray of per-row element arrays (None =
        # NULL array).  Reference ArrayNoneEncoder / TypedImportBuffer
        # addArray (ImportExport/Importer.h).  Geo columns accept WKT
        # strings (reference Geospatial/Types.cpp GeoPoint/GeoPolygon).
        eti = ti.elem_type()
        out = np.empty(len(values), object)
        for i, row in enumerate(values):
            if row is None or (isinstance(row, float) and np.isnan(row)):
                out[i] = None
            elif ti.is_geo and isinstance(row, str):
                c = wkt_to_coords(row, ti.kind)
                out[i] = (
                    geoint_compress(c, ti.kind)
                    if ti.is_geo_compressed else c
                )
            elif ti.is_geo_compressed and isinstance(row, np.ndarray) \
                    and row.dtype.kind == "f":
                # raw f64 payload into a compressed column (CTAS from an
                # uncompressed geo source)
                out[i] = geoint_compress(row, ti.kind)
            else:
                out[i] = to_physical(list(row), eti, sdict)
        return out
    dtype = ti.np_dtype()
    sentinel = ti.null_sentinel()

    # fast path: numeric numpy arrays without object dtype
    if isinstance(values, np.ndarray) and values.dtype.kind in "ifb":
        if ti.is_dict_string:
            raise StorageError("numeric array for TEXT column")
        arr = values
        if ti.is_decimal and arr.dtype.kind == "f":
            out = np.where(
                np.isnan(arr), sentinel, np.round(arr * 10**ti.scale)
            ).astype(np.int64)
            return out
        if dtype.kind == "f":
            return arr.astype(dtype)
        if arr.dtype.kind == "f":
            # float -> int column: NaN becomes sentinel
            out = np.where(np.isnan(arr), sentinel, arr).astype(dtype)
            return out
        if ti.is_decimal:
            return (arr.astype(np.int64)) * (10**ti.scale)
        return arr.astype(dtype)

    vals = list(values)
    n = len(vals)
    out = np.empty(n, dtype)

    if ti.is_dict_string:
        assert sdict is not None
        return sdict.get_or_add_bulk(vals)

    for i, v in enumerate(vals):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            out[i] = sentinel
            continue
        k = ti.kind
        if k == T.SQLTypeKind.BOOLEAN:
            if isinstance(v, str):
                v = v.strip().lower() in ("t", "true", "1", "yes")
            out[i] = 1 if v else 0
        elif ti.is_integer:
            out[i] = int(v)
        elif ti.is_fp:
            out[i] = float(v)
        elif ti.is_decimal:
            from decimal import Decimal

            d = Decimal(str(v)).scaleb(ti.scale)
            out[i] = int(d.to_integral_value(rounding="ROUND_HALF_UP"))
        elif k == T.SQLTypeKind.DATE:
            out[i] = _parse_date(v)
        elif k == T.SQLTypeKind.TIME:
            out[i] = _parse_time(v)
        elif k == T.SQLTypeKind.TIMESTAMP:
            out[i] = _parse_timestamp(v, ti.precision)
        else:
            raise StorageError(f"cannot ingest into {ti}")
    return out


def from_physical(arr: np.ndarray, ti: T.TypeInfo, sdict=None) -> list:
    """Physical array → python values (None for nulls) for client results.
    Vectorized per type (a per-value Python loop was the egress bottleneck;
    numpy datetime64 conversion gives C-speed date/datetime objects)."""
    if ti.is_array:
        if ti.is_geo:
            return [
                None if row is None else coords_to_wkt(row, ti.kind)
                for row in arr
            ]
        eti = ti.elem_type()
        return [
            None if row is None else from_physical(row, eti, sdict)
            for row in arr
        ]
    if ti.is_string and (sdict is None and arr.dtype.kind in ("U", "O")):
        # host-materialized strings (metadata results)
        return list(arr)
    if ti.is_dict_string:
        assert sdict is not None
        return sdict.get_strings(arr)
    k = ti.kind
    if arr.dtype.kind == "f":
        nulls = np.isnan(arr)
        out = arr.astype(object)
    else:
        sentinel = ti.null_sentinel()
        nulls = arr == sentinel
        if k == T.SQLTypeKind.BOOLEAN:
            out = (arr != 0).astype(object)
        elif ti.is_decimal:
            out = (arr / (10**ti.scale)).astype(object)
        elif k == T.SQLTypeKind.DATE:
            out = arr.astype("datetime64[D]").astype(object)  # datetime.date
        elif k == T.SQLTypeKind.TIMESTAMP:
            mult = 10**ti.precision
            us = (arr.astype(np.int64) * (10**6 // mult)) if mult <= 10**6 \
                else (arr.astype(np.int64) // (mult // 10**6))
            out = us.astype("datetime64[us]").astype(object)  # datetime
        elif k == T.SQLTypeKind.TIME:
            res = []
            for v, isnull in zip(arr.tolist(), nulls.tolist()):
                if isnull:
                    res.append(None)
                else:
                    s = int(v)
                    res.append(_dt.time(s // 3600, (s % 3600) // 60, s % 60))
            return res
        else:
            out = arr.astype(object)
    if nulls.any():
        out[nulls] = None
    return out.tolist()


# ---------------------------------------------------------------------------
# WKT ↔ flat coordinates (reference Geospatial/Types.cpp; coords are stored
# as one flat f64 array per row like the reference's geo physical columns)
# ---------------------------------------------------------------------------


def wkt_to_coords(wkt: str, kind: T.SQLTypeKind) -> np.ndarray:
    import re as _re

    s = wkt.strip()
    m = _re.match(r"(\w+)\s*\((.*)\)\s*$", s, _re.S)
    if not m:
        raise StorageError(f"bad WKT: {wkt!r}")
    tag = m.group(1).upper()
    body = m.group(2)
    K = T.SQLTypeKind
    expect = {
        K.GEO_POINT: "POINT", K.GEO_LINESTRING: "LINESTRING",
        K.GEO_POLYGON: "POLYGON", K.GEO_MULTIPOLYGON: "MULTIPOLYGON",
    }[kind]
    if tag != expect:
        raise StorageError(f"expected {expect} WKT, got {tag}")
    if kind == K.GEO_POINT:
        x, y = body.split()
        return np.array([float(x), float(y)], np.float64)
    if kind == K.GEO_LINESTRING:
        pts = [p.split() for p in body.split(",")]
        return np.array(
            [float(v) for p in pts for v in p[:2]], np.float64
        )
    # POLYGON / MULTIPOLYGON: self-describing ring header —
    # [nrings, signed_size_1 .. signed_size_R, coords...] where size is the
    # ring's coord count, positive for outer rings and NEGATIVE for holes
    # (reference: ring_sizes + poly_rings companion arrays,
    # Geospatial/Types.cpp; one flat array keeps our payload single-column)
    def ring_coords(txt: str) -> list:
        pts = [p.split() for p in txt.split(",")]
        coords = [float(v) for p in pts for v in p[:2]]
        if len(coords) >= 4 and coords[:2] == coords[-2:]:
            coords = coords[:-2]  # drop the closing vertex
        return coords

    if kind == K.GEO_POLYGON:
        rings = _re.findall(r"\(([^()]*)\)", body)
        if not rings:
            raise StorageError(f"bad POLYGON WKT: {wkt!r}")
        parts = [(ring_coords(r), i == 0) for i, r in enumerate(rings)]
    else:  # MULTIPOLYGON (((outer),(hole)),((outer)))
        polys = _re.findall(r"\(\s*(\([^()]*\)(?:\s*,\s*\([^()]*\))*)\s*\)",
                            body)
        if not polys:
            raise StorageError(f"bad MULTIPOLYGON WKT: {wkt!r}")
        parts = []
        for poly in polys:
            rings = _re.findall(r"\(([^()]*)\)", poly)
            for i, r in enumerate(rings):
                parts.append((ring_coords(r), i == 0))
    header = [float(len(parts))]
    flat = []
    for coords, outer in parts:
        header.append(float(len(coords)) if outer else -float(len(coords)))
        flat.extend(coords)
    return np.array(header + flat, np.float64)


# ---------------------------------------------------------------------------
# GEOINT32 coordinate compression (reference
# Geospatial/CompressionRuntime.h: lon int32 = trunc(x·(2^31-1)/180),
# lat int32 = trunc(y·(2^31-1)/90); INT32_MIN = NULL point; decompress
# multiplies by the exact published constants for bit-parity).  Payload
# headers (ring counts/sizes) are stored as plain ints — exact.
# ---------------------------------------------------------------------------

_GEOINT32_X = 2147483647.0 / 180.0
_GEOINT32_Y = 2147483647.0 / 90.0
_GEOINT32_DX = 8.3819031754424345e-08  # 180 / (2^31-1)
_GEOINT32_DY = 4.1909515877212172e-08  # 90 / (2^31-1)


def _geo_header_len(payload, kind) -> int:
    if kind in (T.SQLTypeKind.GEO_POLYGON, T.SQLTypeKind.GEO_MULTIPOLYGON):
        return 1 + int(payload[0])
    return 0


def geoint_compress(payload: np.ndarray, kind: T.SQLTypeKind) -> np.ndarray:
    h = _geo_header_len(payload, kind)
    out = np.empty(len(payload), np.int32)
    out[:h] = payload[:h].astype(np.int32)
    coords = payload[h:]
    out[h + 0::2] = np.trunc(coords[0::2] * _GEOINT32_X).astype(np.int32)
    out[h + 1::2] = np.trunc(coords[1::2] * _GEOINT32_Y).astype(np.int32)
    return out


def geoint_decompress(payload: np.ndarray, kind: T.SQLTypeKind) -> np.ndarray:
    h = _geo_header_len(payload, kind)
    out = np.empty(len(payload), np.float64)
    out[:h] = payload[:h].astype(np.float64)
    coords = payload[h:]
    out[h + 0::2] = coords[0::2] * _GEOINT32_DX
    out[h + 1::2] = coords[1::2] * _GEOINT32_DY
    return out


def geo_rings(payload: np.ndarray, kind: T.SQLTypeKind):
    """Decode a geo payload → [(ring_coords ndarray, is_outer), ...].
    POINT/LINESTRING payloads are one headerless pseudo-ring.
    GEOINT32-compressed payloads (int dtype) decompress inline."""
    if payload.dtype.kind in "iu":
        payload = geoint_decompress(payload, kind)
    K = T.SQLTypeKind
    if kind not in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
        return [(np.asarray(payload, np.float64), True)]
    arr = np.asarray(payload, np.float64)
    if arr.size == 0:
        return []
    r = int(arr[0])
    out = []
    off = 1 + r
    for i in range(r):
        sz = int(arr[1 + i])
        n = abs(sz)
        out.append((arr[off: off + n], sz > 0))
        off += n
    return out


def coords_to_wkt(coords: np.ndarray, kind: T.SQLTypeKind) -> str:
    if coords.dtype.kind in "iu":  # GEOINT32 payload
        coords = geoint_decompress(coords, kind)
    K = T.SQLTypeKind

    def fmt(c):
        return ", ".join(
            f"{c[i]:.15g} {c[i + 1]:.15g}" for i in range(0, len(c) - 1, 2)
        )

    if kind == K.GEO_POINT:
        return f"POINT ({fmt(coords)})"
    if kind == K.GEO_LINESTRING:
        return f"LINESTRING ({fmt(coords)})"

    def closed(c):
        body = fmt(c)
        if len(c) >= 2:
            body += f", {c[0]:g} {c[1]:g}"
        return f"({body})"

    rings = geo_rings(coords, kind)
    if kind == K.GEO_POLYGON:
        return "POLYGON (" + ", ".join(closed(c) for c, _ in rings) + ")"
    # group rings back into polygons: each outer starts a new part
    parts = []
    for c, outer in rings:
        if outer or not parts:
            parts.append([closed(c)])
        else:
            parts[-1].append(closed(c))
    return "MULTIPOLYGON (" + ", ".join(
        "(" + ", ".join(p) + ")" for p in parts
    ) + ")"
