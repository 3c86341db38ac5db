"""In-memory catalog of tables (reference Catalog_Namespace::Catalog,
Catalog/Catalog.h:144).  Round 1 keeps the catalog in-process; disk
persistence (sqlite write-through like the reference) arrives with the
storage shell.

Temporary tables (intermediate query results) get negative table ids, the
same convention the reference uses for RelAlgExecutor temporary tables.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import CatalogError
from heavydb_tpu_torch.storage.table import ColumnDescriptor, Table


class Catalog:
    def __init__(self, config):
        self.config = config
        self._tables: Dict[str, Table] = {}
        self._by_id: Dict[int, Table] = {}
        self._next_id = itertools.count(1)
        self._next_temp_id = itertools.count(-1, -1)
        self._lock = threading.RLock()

    def create_table(
        self,
        name: str,
        columns: Sequence[tuple],  # (name, TypeInfo) or ColumnDescriptor
        fragment_rows: Optional[int] = None,
        if_not_exists: bool = False,
        temporary: bool = False,
    ) -> Table:
        lname = name.lower()
        with self._lock:
            if lname in self._tables:
                if if_not_exists:
                    return self._tables[lname]
                raise CatalogError(f"table {name!r} already exists")
            cds = []
            seen = set()
            for i, c in enumerate(columns):
                if isinstance(c, ColumnDescriptor):
                    cd = ColumnDescriptor(c.name, c.type, i + 1, c.default,
                                          comment=c.comment)
                else:
                    cname, ti = c
                    cd = ColumnDescriptor(cname, ti, i + 1)
                if cd.name.lower() in seen:
                    raise CatalogError(f"duplicate column {cd.name!r}")
                seen.add(cd.name.lower())
                cds.append(cd)
            tid = next(self._next_temp_id) if temporary else next(self._next_id)
            t = Table(
                tid,
                name,
                cds,
                fragment_rows or self.config.default_fragment_rows,
                is_temporary=temporary,
            )
            self._tables[lname] = t
            self._by_id[tid] = t
            return t

    def skip_ids_through(self, n: int) -> None:
        """New tables take ids above n (called after the tables of a
        database on disk are created, whose stores own ids up to n)."""
        with self._lock:
            self._next_id = itertools.count(n + 1)

    def drop_table(self, name: str, if_exists: bool = False):
        with self._lock:
            t = self._tables.pop(name.lower(), None)
            if t is None:
                if if_exists:
                    return
                raise CatalogError(f"table {name!r} does not exist")
            self._by_id.pop(t.table_id, None)

    def rename_table(self, old: str, new: str):
        with self._lock:
            t = self._tables.pop(old.lower(), None)
            if t is None:
                raise CatalogError(f"table {old!r} does not exist")
            if new.lower() in self._tables:
                self._tables[old.lower()] = t
                raise CatalogError(f"table {new!r} already exists")
            t.name = new
            self._tables[new.lower()] = t

    def get_table(self, name: str) -> Table:
        t = self._tables.get(name.lower())
        if t is None:
            raise CatalogError(f"table {name!r} does not exist")
        return t

    def get_table_opt(self, name: str) -> Optional[Table]:
        return self._tables.get(name.lower())

    def get_table_by_id(self, table_id: int) -> Table:
        t = self._by_id.get(table_id)
        if t is None:
            raise CatalogError(f"no table with id {table_id}")
        return t

    def list_tables(self) -> List[str]:
        return sorted(t.name for t in self._tables.values() if not t.is_temporary)
