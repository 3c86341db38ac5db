"""Disk persistence with epoch-versioned checkpoint/rollback.

Reference: DataMgr/FileMgr — per-table multipage files with an epoch counter;
a checkpoint writes pages + fsyncs the epoch; on recovery, pages above the
last committed epoch are ignored (Epoch.h:33, FileMgr::checkpoint
FileMgr.cpp:615, docs physical_layout.rst).

Our layout (one directory per table):
    <root>/catalog.json                      — schemas (write-through)
    <root>/tables/<tid>/epoch                — committed epoch (atomic rename)
    <root>/tables/<tid>/manifest.e<E>.json   — fragment/chunk map for epoch E
    <root>/tables/<tid>/f<F>_c<C>.e<E>.npy   — chunk data written at epoch E
    <root>/tables/<tid>/dict_c<C>.e<E>.json  — dictionary contents at epoch E

Chunks are copy-on-write per epoch: a checkpoint writes only chunks dirtied
since the previous epoch plus a full manifest, then commits by atomically
replacing `epoch`.  Rollback = rewriting `epoch` to an earlier value
(reference set_table_epoch); `max_rollback_epochs` caps retained manifests.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import StorageError
from heavydb_tpu_torch.storage.table import (ChunkStats, ColumnDescriptor, Fragment,
                                             LazyDeviceChunk, Table)


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes):
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _type_to_json(ti: T.TypeInfo) -> dict:
    return {
        "kind": ti.kind.value,
        "is_array": ti.is_array,
        "nullable": ti.nullable,
        "precision": ti.precision,
        "scale": ti.scale,
        "encoding": ti.encoding.value,
        "comp_param": ti.comp_param,
    }


def _type_from_json(d: dict) -> T.TypeInfo:
    kind = next(k for k in T.SQLTypeKind if k.value == d["kind"])
    enc = next(e for e in T.Encoding if e.value == d["encoding"])
    return T.TypeInfo(
        kind, d["nullable"], d["precision"], d["scale"], enc, d["comp_param"],
        is_array=d.get("is_array", False),
    )


class TableStore:
    """Persistence for one table."""

    def __init__(self, root: str, table_id: int):
        self.dir = os.path.join(root, "tables", str(table_id))
        os.makedirs(self.dir, exist_ok=True)

    # ---- epoch ----
    def committed_epoch(self) -> int:
        p = os.path.join(self.dir, "epoch")
        if not os.path.exists(p):
            return 0
        with open(p) as f:
            return int(f.read().strip())

    def _commit_epoch(self, epoch: int):
        _atomic_write(os.path.join(self.dir, "epoch"), str(epoch).encode())

    def set_epoch(self, epoch: int):
        """Rollback/forward API (reference set_table_epoch)."""
        if not os.path.exists(self._manifest_path(epoch)):
            raise StorageError(f"no manifest for epoch {epoch}")
        self._commit_epoch(epoch)

    def _manifest_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"manifest.e{epoch}.json")

    def _chunk_path(self, frag: int, col: int, epoch: int) -> str:
        return os.path.join(self.dir, f"f{frag}_c{col}.e{epoch}.npy")

    def _dict_path(self, col: int, epoch: int) -> str:
        return os.path.join(self.dir, f"dict_c{col}.e{epoch}.json")

    # ---- checkpoint ----
    def checkpoint(self, t: Table, max_rollback_epochs: int = 8):
        """Write dirty chunks + manifest at epoch+1, then commit.
        Reference: FileMgr::checkpoint (epoch++ write & fsync)."""
        old_epoch = self.committed_epoch()
        epoch = old_epoch + 1
        old_manifest = self._load_manifest(old_epoch) if old_epoch else None
        old_chunks = old_manifest["chunks"] if old_manifest else {}

        manifest = {
            "epoch": epoch,
            "num_fragments": len(t.fragments),
            "fragment_rows": t.fragment_rows,
            "fragments": [],
            "chunks": {},
            "dicts": {},
        }
        for frag in t.fragments:
            fstats = {}
            for cid, st in frag.stats.items():
                fstats[str(cid)] = {
                    "min": _json_safe(st.min),
                    "max": _json_safe(st.max),
                    "has_nulls": st.has_nulls,
                    "num_rows": st.num_rows,
                }
            manifest["fragments"].append(
                {"id": frag.fragment_id, "num_rows": frag.num_rows,
                 "stats": fstats}
            )
            for cid, arr in frag.chunks.items():
                key = f"{frag.fragment_id}:{cid}"
                prev = old_chunks.get(key)
                if (
                    prev is not None and prev["rows"] == arr.shape[0]
                    and cid not in frag.dirty_cols
                ):
                    # unchanged chunk (append-only fragments): reuse
                    manifest["chunks"][key] = prev
                    continue
                if isinstance(arr, LazyDeviceChunk):
                    # a device-resident chunk (load_table_device): its host
                    # copy, one device-to-host copy the first time
                    arr = np.asarray(arr)
                path = self._chunk_path(frag.fragment_id, cid, epoch)
                is_text = t.column_by_id(cid).type.is_none_string
                enc, parts = (
                    ("text" if is_text else "raw", [arr])
                    if arr.dtype == object
                    else encode_chunk(arr)
                )
                with open(path, "wb") as f:
                    if is_text:
                        # none-encoded TEXT: utf-8 lengths + one byte
                        # blob (reference StringNoneEncoder's
                        # offsets+payload file layout)
                        bs = [
                            None if r is None else str(r).encode()
                            for r in arr
                        ]
                        lens = np.array(
                            [-1 if b is None else len(b) for b in bs],
                            np.int64,
                        )
                        blob = np.frombuffer(
                            b"".join(b for b in bs if b), np.uint8
                        )
                        np.save(f, lens)
                        np.save(f, blob)
                    elif arr.dtype == object:
                        # array column: (lengths, flat) pair — no pickling
                        # (reference ArrayNoneEncoder's offsets+data layout)
                        lens = np.array(
                            [-1 if r is None else len(r) for r in arr],
                            np.int64,
                        )
                        parts = [r for r in arr if r is not None and r.size]
                        flat = (
                            np.concatenate(parts) if parts
                            else np.empty(0, np.int64)
                        )
                        np.save(f, lens)
                        np.save(f, flat)
                    else:
                        for p in parts:
                            np.save(f, p)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["chunks"][key] = {
                    "epoch": epoch, "rows": int(arr.shape[0]), "enc": enc
                }
        for cid, d in t.dicts.items():
            dpath = self._dict_path(cid, epoch)
            _atomic_write(
                dpath, json.dumps(list(d.entries())).encode()
            )
            manifest["dicts"][str(cid)] = {"epoch": epoch, "size": d.size}
        _atomic_write(
            self._manifest_path(epoch), json.dumps(manifest).encode()
        )
        self._commit_epoch(epoch)
        for frag in t.fragments:
            frag.dirty_cols.clear()
        self._gc(epoch, max_rollback_epochs)

    def _gc(self, epoch: int, keep: int):
        """Free pages/manifests older than epoch-keep (reference
        freePagesBeforeEpoch / max_rollback_epochs)."""
        floor = epoch - keep
        if floor <= 0:
            return
        live = set()
        for e in range(max(floor, 1), epoch + 1):
            m = self._load_manifest(e)
            if not m:
                continue
            for key, ref in m["chunks"].items():
                f, c = key.split(":")
                live.add(os.path.basename(self._chunk_path(int(f), int(c), ref["epoch"])))
            for cid, ref in m["dicts"].items():
                live.add(os.path.basename(self._dict_path(int(cid), ref["epoch"])))
            live.add(os.path.basename(self._manifest_path(e)))
        for name in os.listdir(self.dir):
            if name == "epoch" or name in live:
                continue
            if name.startswith(("f", "manifest", "dict")):
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass

    def _load_manifest(self, epoch: int) -> Optional[dict]:
        p = self._manifest_path(epoch)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    # ---- recovery ----
    def load_into(self, t: Table):
        """Populate a Table from the committed epoch (uncommitted chunk files
        from a crashed checkpoint are simply never referenced)."""
        epoch = self.committed_epoch()
        if epoch == 0:
            return
        m = self._load_manifest(epoch)
        if m is None:
            raise StorageError(f"missing manifest for epoch {epoch} in {self.dir}")
        t.fragment_rows = m["fragment_rows"]
        t.fragments = []
        for fm in m["fragments"]:
            frag = Fragment(fm["id"], t.fragment_rows)
            frag.num_rows = fm["num_rows"]
            for cid_s, st in fm["stats"].items():
                frag.stats[int(cid_s)] = ChunkStats(
                    st["min"], st["max"], st["has_nulls"], st["num_rows"]
                )
            t.fragments.append(frag)
        for key, ref in m["chunks"].items():
            f_s, c_s = key.split(":")
            cd = t.column_by_id(int(c_s))
            path = self._chunk_path(int(f_s), int(c_s), ref["epoch"])
            if cd.type.is_none_string:
                with open(path, "rb") as fh:
                    lens = np.load(fh)
                    blob = np.load(fh).tobytes()
                arr = np.empty(len(lens), object)
                pos = 0
                for i, ln in enumerate(lens.tolist()):
                    if ln < 0:
                        arr[i] = None
                    else:
                        arr[i] = blob[pos:pos + ln].decode()
                        pos += ln
            elif cd.type.is_array:
                with open(path, "rb") as fh:
                    lens = np.load(fh)
                    flat = np.load(fh)
                arr = np.empty(len(lens), object)
                pos = 0
                for i, ln in enumerate(lens.tolist()):
                    if ln < 0:
                        arr[i] = None
                    else:
                        arr[i] = flat[pos:pos + ln]
                        pos += ln
            else:
                enc = ref.get("enc", "raw")
                with open(path, "rb") as fh:
                    n_parts = {"raw": 1, "rle": 2, "diff": 2}[enc]
                    parts = [np.load(fh) for _ in range(n_parts)]
                arr = decode_chunk(enc, parts, cd.type.np_dtype())
            t.fragments_by_id()[int(f_s)].chunks[int(c_s)] = arr
        for cid_s, ref in m["dicts"].items():
            cid = int(cid_s)
            with open(self._dict_path(cid, ref["epoch"])) as f:
                strings = json.load(f)
            t.dicts[cid].load_entries(strings)
        t.generation += 1

    def destroy(self):
        shutil.rmtree(self.dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Chunk encoders — reference RL / DIFF encoders (DataMgr's RunLengthEncoder /
# DiffEncoder roles).  On the device the representation stays the flat
# physical dtype (FIXED narrowing covers device width); these encoders cut
# the DISK footprint + IO of checkpointed chunks.  The smallest of
# {raw, rle, diff} is chosen per chunk and recorded in the manifest.
# ---------------------------------------------------------------------------


def _narrowest_int(arr):
    """Smallest signed dtype that exactly holds arr (arr: int64-safe)."""
    if arr.size == 0:
        return arr.astype(np.int8)
    lo, hi = int(arr.min()), int(arr.max())
    for dt in (np.int8, np.int16, np.int32):
        ii = np.iinfo(dt)
        if ii.min <= lo and hi <= ii.max:
            return arr.astype(dt)
    return arr.astype(np.int64)


def encode_chunk(arr):
    """(encoding_name, list_of_arrays) for one fixed-width chunk."""
    if arr.dtype == object or arr.dtype.kind not in "iu" or arr.size < 64:
        return "raw", [arr]
    raw_bytes = arr.nbytes
    # RLE: values + run lengths (wins on sorted / low-NDV columns)
    change = np.empty(arr.shape[0], bool)
    change[0] = True
    np.not_equal(arr[1:], arr[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    if starts.size * 2 <= arr.shape[0]:
        values = arr[starts]
        lens = _narrowest_int(np.diff(np.append(starts, arr.shape[0])))
        rle_bytes = values.nbytes + lens.nbytes
    else:
        values = lens = None
        rle_bytes = raw_bytes + 1
    # DIFF: first value + narrowed deltas (wins on near-monotonic columns
    # like event timestamps); int64 wraparound is exact on decode cumsum
    d = np.diff(arr.astype(np.int64))
    deltas = _narrowest_int(d)
    diff_bytes = 8 + deltas.nbytes
    best = min(raw_bytes, rle_bytes, diff_bytes)
    if best == raw_bytes:
        return "raw", [arr]
    if best == rle_bytes:
        return "rle", [values, lens]
    first = np.array([arr[0]], np.int64)
    return "diff", [first, deltas]


def decode_chunk(enc, parts, dtype):
    if enc == "raw":
        return parts[0]
    if enc == "rle":
        values, lens = parts
        return np.repeat(values, lens.astype(np.int64)).astype(dtype)
    if enc == "diff":
        first, deltas = parts
        out = np.empty(deltas.shape[0] + 1, np.int64)
        out[0] = first[0]
        np.cumsum(deltas.astype(np.int64), out=out[1:])
        out[1:] += first[0]
        return out.astype(dtype)
    raise StorageError(f"unknown chunk encoding {enc!r}")


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class PersistentCatalogStore:
    """Write-through catalog persistence (reference Catalog sqlite tables
    mapd_tables/mapd_columns — here JSON; the native sqlite-backed catalog
    arrives with the server shell)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "tables"), exist_ok=True)
        self.path = os.path.join(root, "catalog.json")

    def save(self, catalog, syscatalog=None, servers=None):
        tables = []
        for name in catalog.list_tables():
            t = catalog.get_table(name)
            tables.append({
                # the id of the table's store directory, which a table
                # reopened from disk keeps apart from its id in memory
                "table_id": getattr(t, "disk_table_id", t.table_id),
                "name": t.name,
                "fragment_rows": t.fragment_rows,
                "columns": [
                    {"name": cd.name, "col_id": cd.col_id,
                     "type": _type_to_json(cd.type),
                     "comment": cd.comment}
                    for cd in t.columns
                ],
                "comment": getattr(t, "comment", None),
                "foreign": getattr(t, "foreign", None),
                "shard_key": getattr(t, "shard_key", None),
                "shard_count": getattr(t, "shard_count", 0),
                "sort_column": getattr(t, "sort_column", None),
            })
        from heavydb_tpu_torch.storage.migration import CATALOG_VERSION

        payload = {"version": CATALOG_VERSION, "tables": tables}
        if syscatalog is not None:
            payload["syscatalog"] = syscatalog.to_json()
        if servers is not None:
            # foreign servers persist with the catalog (reference
            # Catalog/ForeignServer rows in the sqlite catalog)
            payload["servers"] = {
                n: {"wrapper": s["wrapper"], "options": s.get("options", {})}
                for n, s in servers.items()
            }
        _atomic_write(self.path, json.dumps(payload).encode())

    def load_servers(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return json.load(f).get("servers")

    def load_syscatalog(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return json.load(f).get("syscatalog")

    def load(self, catalog) -> list:
        """Recreate tables in the catalog; returns the Table objects."""
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            data = json.load(f)
        from heavydb_tpu_torch.storage.migration import migrate_catalog

        data = migrate_catalog(data)
        out = []
        for tm in data["tables"]:
            cols = [
                ColumnDescriptor(c["name"], _type_from_json(c["type"]),
                                 c["col_id"], comment=c.get("comment"))
                for c in sorted(tm["columns"], key=lambda c: c["col_id"])
            ]
            t = catalog.create_table(
                tm["name"], cols, tm["fragment_rows"]
            )
            # preserve original table id mapping for on-disk dirs
            t.disk_table_id = tm["table_id"]
            t.comment = tm.get("comment")
            if tm.get("foreign"):
                t.foreign = dict(tm["foreign"])
                t.foreign["loaded"] = False  # lazy re-import on first scan
            if tm.get("shard_key"):
                t.shard_key = tm["shard_key"]
                t.shard_count = int(tm.get("shard_count", 0))
            if tm.get("sort_column"):
                t.sort_column = tm["sort_column"]
            out.append(t)
        # a new table's store directory is named by its id: ids above every
        # store on disk, so that none writes into (or, dropped, removes)
        # the store of a table reopened here
        catalog.skip_ids_through(max([tm["table_id"] for tm in data["tables"]]
                                     + [t.table_id for t in out], default=0))
        return out
