"""Python client for the heavydb_tpu_torch server (role of the reference's
heavyai python client / JDBC driver over Thrift).  The port of
heavydb_tpu/client/client.py: the wire format is the same, so either
package's client talks to either package's server."""

from __future__ import annotations

import itertools
import socket
from typing import Dict, List

import numpy as np

from heavydb_tpu_torch.server import protocol as P


class ServerError(Exception):
    def __init__(self, type_: str, message: str):
        super().__init__(f"{type_}: {message}")
        self.type = type_


class RemoteResult:
    def __init__(self, payload: dict):
        self.fields: List[str] = payload["fields"]
        self.types: List[str] = payload["types"]
        self.columns = payload["columns"]
        self.row_count: int = payload["row_count"]
        self.execution_time_ms = payload.get("execution_time_ms")

    def rows(self) -> list:
        return list(zip(*self.columns)) if self.columns else []

    def scalar(self):
        r = self.rows()
        return r[0][0] if r else None

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(dict(zip(self.fields, self.columns)))


class Connection:
    def __init__(self, host: str = "127.0.0.1", port: int = 6274,
                 user: str = "admin", password: str = ""):
        self.sock = socket.create_connection((host, port))
        self.rfile = self.sock.makefile("rb")
        self._ids = itertools.count(1)
        self.session = self._call("connect", user=user, password=password)

    def _call(self, method: str, **params):
        msg = {"id": next(self._ids), "method": method, "params": params}
        self.sock.sendall(P.dumps(msg))
        resp = P.read_message(self.rfile)
        if resp is None:
            raise ConnectionError("server closed connection")
        if "error" in resp:
            raise ServerError(resp["error"]["type"], resp["error"]["message"])
        return resp["result"]

    def call(self, method: str, **params):
        """Raw RPC escape hatch (any rpc_* endpoint by name)."""
        return self._call(method, **params)

    def sql(self, query: str) -> RemoteResult:
        return RemoteResult(self._call("sql_execute", session=self.session,
                                       query=query))

    def sql_df(self, query: str):
        """Arrow-transport query → pyarrow.Table (reference sql_execute_df)."""
        import base64
        import io

        import pyarrow as pa

        res = self._call("sql_execute_df", session=self.session, query=query)
        buf = base64.b64decode(res["arrow_ipc"])
        with pa.ipc.open_stream(io.BytesIO(buf)) as r:
            return r.read_all()

    def get_queries_info(self) -> list:
        return self._call("get_queries_info", session=self.session)

    def interrupt(self):
        return self._call("interrupt", session=self.session)

    def get_tables(self) -> list:
        return self._call("get_tables", session=self.session)

    def get_table_details(self, table: str) -> dict:
        return self._call("get_table_details", session=self.session,
                          table=table)

    def load_table(self, table: str, columns: Dict[str, np.ndarray]) -> int:
        payload = {k: P.encode_array(np.asarray(v)) for k, v in columns.items()}
        return self._call("load_table_binary_columnar", session=self.session,
                          table=table, columns=payload)

    def get_memory(self) -> dict:
        return self._call("get_memory", session=self.session)

    def get_status(self) -> dict:
        return self._call("get_status")

    def close(self):
        try:
            self._call("disconnect", session=self.session)
        except Exception:
            pass
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
