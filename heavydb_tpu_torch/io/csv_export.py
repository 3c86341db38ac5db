"""COPY TO export (reference ImportExport/QueryExporterCSV + parquet via
the arrow writer)."""

from __future__ import annotations

from typing import Dict


def export_csv(rs, path: str, options: Dict) -> int:
    delim = options.get("delimiter", ",")
    header = options.get("header", True)
    if isinstance(header, str):
        header = header.lower() in ("true", "1", "yes")
    # fast path: the Arrow CSV writer (C++) — same minimal-quoting rules,
    # NULL → empty, nullable ints stay ints (a pandas round-trip would
    # float-widen them).  Exotic columns (arrays/geo lists) fall back to
    # the row loop below.
    try:
        import pyarrow.csv as pacsv

        table = rs.to_arrow()
        pacsv.write_csv(
            table, path,
            pacsv.WriteOptions(include_header=bool(header),
                               delimiter=delim),
        )
        return rs.row_count
    except Exception:
        pass
    import datetime as _dt

    # match the Arrow writer's conventions exactly (quoted headers,
    # lowercase booleans, microsecond timestamps) so the two paths —
    # chosen data-dependently — produce byte-compatible formatting
    with open(path, "w") as f:
        if header:
            f.write(delim.join(
                '"' + n.replace('"', '""') + '"' for n in rs.fields
            ) + "\n")
        for row in rs.rows():
            out = []
            for v in row:
                if v is None:
                    out.append("")
                elif isinstance(v, str):
                    if delim in v or '"' in v or "\n" in v:
                        out.append('"' + v.replace('"', '""') + '"')
                    else:
                        out.append(v)
                elif isinstance(v, bool):
                    out.append("true" if v else "false")
                elif isinstance(v, _dt.datetime):
                    out.append(v.strftime("%Y-%m-%d %H:%M:%S.%f"))
                else:
                    out.append(str(v))
            f.write(delim.join(out) + "\n")
    return rs.row_count


def export_result(rs, path: str, options: Dict) -> int:
    """Dispatch by file_type option / path suffix (reference CopyParams
    file_type: csv | parquet)."""
    ftype = str(options.get("file_type", "")).lower()
    if not ftype:
        ftype = "parquet" if path.endswith((".parquet", ".pq")) else "csv"
    if ftype == "parquet":
        import pyarrow.parquet as pq

        table = rs.to_arrow()
        pq.write_table(table, path)
        return rs.row_count
    return export_csv(rs, path, options)
