"""CSV/Parquet import (reference ImportExport/Importer.h:808 delimited +
parquet paths).  Round 1 rides pandas/pyarrow C parsers for the parse stage;
conversion to physical columns goes through storage.to_physical."""

from __future__ import annotations

from typing import Dict

import numpy as np

from heavydb_tpu_torch.errors import StorageError
from heavydb_tpu_torch.storage.table import RawText, Table, to_physical


def detect_column_types(path: str, options: Dict = None) -> list:
    """Infer (name, TypeInfo) schema from a CSV/Parquet sample — the role of
    the reference's import Detector (ImportExport/Importer.h:753,
    detect_column_types Thrift endpoint)."""
    import pandas as pd

    from heavydb_tpu_torch import types as T

    options = options or {}
    header = options.get("header", True)
    if isinstance(header, str):
        header = header.lower() in ("true", "1", "yes")
    if path.endswith(".parquet"):
        df = pd.read_parquet(path)
    else:
        df = pd.read_csv(
            path, sep=options.get("delimiter", ","),
            header=0 if header else None, nrows=10_000,
            na_values=[r"\N", "NULL", ""],
        )
    out = []
    for c in df.columns:
        s = df[c]
        k = s.dtype.kind
        if k == "b":
            ti = T.boolean()
        elif k == "i":
            mx = s.abs().max() if len(s) else 0
            ti = T.bigint() if mx >= 2**31 else T.integer()
        elif k == "f":
            # integers-with-nulls parse as float; detect
            nn = s.dropna()
            if len(nn) and (nn == nn.round()).all() and nn.abs().max() < 2**53:
                ti = T.bigint() if nn.abs().max() >= 2**31 else T.integer()
                ti = ti.with_nullable(True)
            else:
                ti = T.double()
        elif k == "M":
            ti = T.timestamp()
        else:
            # try dates then fall back to TEXT
            nn = s.dropna().astype(str).head(100)
            try:
                import datetime as _dt

                for v in nn:
                    _dt.date.fromisoformat(v.strip())
                ti = T.date()
            except Exception:
                ti = T.text_dict()
        name = str(c) if header or path.endswith(".parquet") else f"col_{c}"
        out.append((name, ti))
    return out


def parse_csv_native(path: str, delimiter: str = ",", header: bool = True):
    """Parse with the native multithreaded C++ extension (the role of the
    reference's parallel delimited import workers).  Returns
    (names, columns, nrows) or None when the extension is unavailable.
    Columns come back as int64/float64 numpy arrays (nulls → NaN-widened
    float64) or python lists of str/None."""
    from heavydb_tpu_torch.native import load_csv_ext

    ext = load_csv_ext()
    if ext is None or len(delimiter) != 1:
        return None
    with open(path, "rb") as f:
        data = f.read()
    names, cols, nrows = ext.parse_csv(
        data, ord(delimiter), 1 if header else 0, 0
    )
    out = []
    for entry in cols:
        kind = entry[0]
        if kind == "i":
            _, buf, nulls = entry
            vals = np.frombuffer(buf, np.int64)
            mask = np.frombuffer(nulls, np.uint8).astype(bool)
            if mask.all():
                out.append(vals.copy())
            else:
                fv = vals.astype(np.float64)
                fv[~mask] = np.nan
                out.append(fv)
        elif kind == "f":
            _, buf, nulls = entry
            vals = np.frombuffer(buf, np.float64).copy()
            mask = np.frombuffer(nulls, np.uint8).astype(bool)
            vals[~mask] = np.nan
            out.append(vals)
        else:
            # un-decoded text column: dict-encoded targets intern the raw
            # payload natively (strdict_ext.intern_payload); textual null
            # tokens were already recognized during the native parse, so
            # no python-side normalization/reclassification remains
            _, payload, offs_b, nulls = entry
            offs = np.frombuffer(offs_b, np.int64)
            mask = np.frombuffer(nulls, np.uint8)
            out.append(RawText(payload, offs, mask))
    if not header:
        names = [f"col_{i}" for i in range(len(names))]
    return names, out, nrows


def _coerce_native_col(col, cd):
    """Adapt a native-parsed column to the table column's type family."""
    ti = cd.type
    if isinstance(col, RawText) and not (ti.is_string or ti.is_array):
        # non-text target fed by a string-classified CSV column
        # (booleans, dates, numbers-with-units): decode once and convert
        col = col.to_list()
    if isinstance(col, list):
        if ti.is_boolean:
            truthy = {"true", "t", "1", "yes"}
            falsy = {"false", "f", "0", "no"}

            def bconv(v):
                if v is None:
                    return None
                lv = str(v).strip().lower()
                if lv in truthy:
                    return True
                if lv in falsy:
                    return False
                return bool(int(lv))

            return [bconv(v) for v in col]
        if ti.is_number:
            def conv(v):
                if v is None:
                    return None
                try:
                    return float(v) if ti.is_fp or ti.is_decimal else int(v)
                except ValueError:
                    return float(v)  # "1e3" into an int col -> error later

            return [conv(v) for v in col]
        return col
    return col


def import_csv(t: Table, path: str, options: Dict) -> int:
    import pandas as pd

    header = options.get("header", True)
    if isinstance(header, str):
        header = header.lower() in ("true", "1", "yes")
    delim = options.get("delimiter", ",")
    quote = options.get("quote", '"')
    if not path.endswith(".parquet") and quote == '"' and \
            not options.get("no_native"):
        native = parse_csv_native(path, delim, header)
        if native is not None:
            names, cols, n = native
            if len(cols) != len(t.columns):
                raise StorageError(
                    f"CSV has {len(cols)} columns, table {t.name} has "
                    f"{len(t.columns)}"
                )
            arrays = {}
            for cd, col in zip(t.columns, cols):
                col = _coerce_native_col(col, cd)
                arrays[cd.col_id] = to_physical(
                    col, cd.type, t.dicts.get(cd.col_id)
                )
            if n:
                t.insert_columns(arrays)
            return n

    if path.endswith(".parquet"):
        df = pd.read_parquet(path)
    else:
        df = pd.read_csv(
            path,
            sep=delim,
            header=0 if header else None,
            quotechar=quote,
            na_values=[r"\N", "NULL", ""],
            keep_default_na=True,
            skipinitialspace=True,
        )
    if len(df.columns) != len(t.columns):
        raise StorageError(
            f"CSV has {len(df.columns)} columns, table {t.name} has {len(t.columns)}"
        )
    arrays = {}
    for cd, csv_col in zip(t.columns, df.columns):
        series = df[csv_col]
        vals = series.to_numpy()
        if vals.dtype.kind == "O" or cd.type.is_dict_string or cd.type.is_time:
            vals = [None if (v is None or (isinstance(v, float) and v != v)) else v
                    for v in series.tolist()]
        arrays[cd.col_id] = to_physical(vals, cd.type, t.dicts.get(cd.col_id))
    n = len(df)
    if n:
        t.insert_columns(arrays)
    return n
