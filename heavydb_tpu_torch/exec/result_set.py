"""Client-facing query results (reference QueryEngine/ResultSet.h:169 role,
but only the client-egress part — intermediate results stay as exec.batch
Batches on device)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.storage.table import from_physical
from heavydb_tpu_torch.utils.timer import NULL_TIMER


class ResultSet:
    def __init__(self, fields, types, host_cols, dicts, batch=None, timer=NULL_TIMER):
        """host_cols: list of numpy arrays (exact length), or None with
        `batch` set — then columns stay DEVICE-resident until first
        access (the reference also serializes result rows only when the
        client asks; on a remote-attached TPU the egress D2H of a large
        result costs seconds and must not land on db.sql()).  That
        access runs in the `egress` scope of `timer`, the query's."""
        self.fields = list(fields)
        self.types = list(types)
        self._cols = host_cols
        self._dicts = dicts
        self._batch = batch
        self._timer = timer
        self._n = None if batch is None else int(batch.nrows)

    def _materialize(self):
        if self._cols is None:
            with self._timer.scope("egress"):
                host = self._batch.to_numpy()
                self._cols = [
                    np.empty(0, t.np_dtype()) if c is None else c
                    for c, t in zip(host, self.types)
                ]
            self._batch = None
        return self._cols

    def timings(self):
        """The scope tree of the query that made this result
        (enable_debug_timer), read now; None without one."""
        return self._timer.to_dict()

    @property
    def row_count(self) -> int:
        if self._n is not None:
            return self._n
        cols = self._materialize()
        return 0 if not cols else int(cols[0].shape[0])

    @property
    def col_count(self) -> int:
        return len(self.fields)

    def column(self, i: int) -> list:
        """Decoded python values (None for NULL)."""
        cols = self._materialize()
        return from_physical(cols[i], self.types[i], self._dicts[i])

    def column_raw(self, i: int) -> np.ndarray:
        return self._materialize()[i]

    def rows(self) -> list:
        cols = [self.column(i) for i in range(self.col_count)]
        return list(zip(*cols)) if cols else []

    def __iter__(self):
        return iter(self.rows())

    def __len__(self):
        return self.row_count

    def to_pandas(self):
        import pandas as pd

        # dedupe duplicate output names (e.g. two SUM(...) columns)
        names = []
        seen = {}
        for f in self.fields:
            k = seen.get(f, 0)
            seen[f] = k + 1
            names.append(f if k == 0 else f"{f}_{k}")
        return pd.DataFrame(
            {nm: self.column(i) for i, nm in enumerate(names)}
        )

    def scalar(self):
        """First cell — convenience for aggregate queries."""
        r = self.rows()
        return r[0][0] if r else None

    def to_arrow(self):
        """Arrow egress (reference sql_execute_df / ArrowResultSet)."""
        import pyarrow as pa

        arrays = []
        names = []
        for i, (f, ti) in enumerate(zip(self.fields, self.types)):
            names.append(f)
            vals = self.column(i)
            if ti.is_string:
                arrays.append(pa.array(vals, pa.string()))
            elif ti.is_boolean:
                arrays.append(pa.array(vals, pa.bool_()))
            elif ti.is_decimal:
                arrays.append(pa.array(vals, pa.float64()))
            elif ti.kind.value == "DATE":
                arrays.append(pa.array(vals, pa.date32()))
            elif ti.kind.value == "TIMESTAMP":
                arrays.append(pa.array(vals, pa.timestamp("us")))
            elif ti.kind.value == "TIME":
                arrays.append(pa.array(vals, pa.time64("us")))
            else:
                arrays.append(pa.array(vals))
        # from_arrays, not pa.table(dict(...)): duplicate output names
        # (e.g. SELECT x, x) must keep every column
        return pa.Table.from_arrays(arrays, names=names)

    def __repr__(self):
        head = ", ".join(
            f"{f} {t.sql_name()}" for f, t in zip(self.fields, self.types)
        )
        return f"ResultSet([{head}], {self.row_count} rows)"


def from_batch(batch, fields, types, dicts, timer=NULL_TIMER) -> ResultSet:
    return ResultSet(fields, types, None, dicts, batch=batch, timer=timer)
