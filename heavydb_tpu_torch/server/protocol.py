"""Wire protocol: newline-delimited JSON over TCP.

The role of the reference's Thrift service `Heavy` (heavy.thrift:681-802) —
sessions, sql_execute, metadata, load, interrupt — with JSON-lines instead
of Thrift binary (client/metadata control plane only; bulk data rides
base64-encoded little-endian numpy buffers in `load_table_binary_columnar`,
the analogue of the Thrift columnar load path).
"""

from __future__ import annotations

import base64
import datetime as _dt
import json
from typing import Any, Dict

import numpy as np


def encode_value(v):
    if isinstance(v, (_dt.datetime,)):
        return v.isoformat(sep=" ")
    if isinstance(v, (_dt.date,)):
        return v.isoformat()
    if isinstance(v, _dt.time):
        return v.isoformat()
    if isinstance(v, float) and v != v:
        return None
    return v


def encode_result(rs) -> Dict[str, Any]:
    """ResultSet → JSON-safe columnar payload (reference TQueryResult
    row_set.columns)."""
    return {
        "fields": rs.fields,
        "types": [t.sql_name() for t in rs.types],
        "columns": [
            [encode_value(v) for v in rs.column(i)]
            for i in range(rs.col_count)
        ],
        "row_count": rs.row_count,
    }


def encode_array(arr: np.ndarray) -> Dict[str, Any]:
    return {
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode(),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    buf = base64.b64decode(d["data"])
    return np.frombuffer(buf, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def dumps(obj) -> bytes:
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def read_message(sock_file):
    line = sock_file.readline()
    if not line:
        return None
    return json.loads(line)
