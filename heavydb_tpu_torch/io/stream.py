"""Streaming ingest — the reference's KafkaImporter / StreamImporter role
(ImportExport/KafkaImporter.cpp, ImportExport/RowToColumnLoader.cpp):
consume an unbounded stream of delimited rows, batch them into columnar
loads, apply optional per-field regex transforms, commit per batch (each
batch is an epoch — crash recovery lands on a batch boundary), and report
rejected rows instead of aborting the stream.

Sources are pluggable.  In this environment there is no network egress, so
the Kafka consumer itself is a gated adapter (any object with a
``poll(timeout) -> list[str] | None`` method works — e.g. a
confluent_kafka/rdkafka wrapper supplied by the caller); ``FileTailSource``
follows a growing file and is the stand-in for a topic partition.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from heavydb_tpu_torch.errors import SqlError


@dataclass
class StreamStats:
    rows_loaded: int = 0
    rows_rejected: int = 0
    batches: int = 0
    bytes_consumed: int = 0
    rejected_samples: List[str] = field(default_factory=list)


class StreamImporter:
    """Batched columnar stream loader for one table.

    rows → typed columns → ``db.load_table`` per batch.  A failed row is
    rejected (counted + sampled), not fatal — the reference's
    ``max_reject`` contract (Importer.cpp kImportRowLimit behavior).
    """

    MAX_REJECT_SAMPLES = 25

    def __init__(self, db, table_name: str, batch_size: int = 10_000,
                 delimiter: str = ",", transforms: Optional[Dict] = None,
                 max_reject: int = 100_000):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.db = db
        self.table = db.catalog.get_table(table_name)
        self.batch_size = batch_size
        self.delimiter = delimiter
        self.max_reject = max_reject
        self.stats = StreamStats()
        self._buf: List[tuple] = []
        # transforms: column name → (regex, replacement) applied to the
        # raw field before typing (reference --transform flag)
        self._transforms = []
        for cname, (pat, repl) in (transforms or {}).items():
            idx = self._col_index(cname)
            self._transforms.append((idx, re.compile(pat), repl))
        self._closed = False

    def _col_index(self, cname: str) -> int:
        for i, cd in enumerate(self.table.columns):
            if cd.name.lower() == cname.lower():
                return i
        raise SqlError(f"unknown column {cname!r} in stream transform")

    # -- feeding ------------------------------------------------------
    def push_rows(self, rows: Sequence[Sequence]) -> None:
        """Typed python rows (None = NULL)."""
        self._check_open()
        arity = len(self.table.columns)
        for r in rows:
            if len(r) != arity:
                self._reject(repr(r))
                continue
            self._buf.append(tuple(r))
            if len(self._buf) >= self.batch_size:
                self.flush()

    def push_delimited(self, lines) -> None:
        """Raw delimited text lines (str or bytes)."""
        self._check_open()
        cols = self.table.columns
        for line in lines:
            if isinstance(line, bytes):
                line = line.decode("utf-8", "replace")
            self.stats.bytes_consumed += len(line)
            line = line.rstrip("\r\n")
            if not line:
                continue
            fields = line.split(self.delimiter)
            if len(fields) != len(cols):
                self._reject(line)
                continue
            for idx, rx, repl in self._transforms:
                fields[idx] = rx.sub(repl, fields[idx])
            try:
                row = tuple(
                    _type_field(f, cd) for f, cd in zip(fields, cols)
                )
            except (ValueError, OverflowError):
                self._reject(line)
                continue
            self._buf.append(row)
            if len(self._buf) >= self.batch_size:
                self.flush()

    # -- lifecycle ----------------------------------------------------
    def flush(self) -> int:
        """Commit the buffered rows as one batch (one table epoch)."""
        self._check_open()
        if not self._buf:
            return 0
        import numpy as np

        n = len(self._buf)
        cols = {}
        for i, cd in enumerate(self.table.columns):
            cols[cd.name] = np.array(
                [r[i] for r in self._buf], dtype=object
            )
        self.db.load_table(self.table.name, cols)
        self._buf.clear()
        self.stats.rows_loaded += n
        self.stats.batches += 1
        return n

    def close(self) -> StreamStats:
        if not self._closed:
            self.flush()
            self._closed = True
        return self.stats

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- consume loop -------------------------------------------------
    def run(self, source, poll_timeout_s: float = 1.0,
            idle_limit: Optional[int] = None,
            max_rows: Optional[int] = None) -> StreamStats:
        """Drain a source until it reports EOF (None poll result
        ``idle_limit`` consecutive times, Kafka-style exit_eof) or
        ``max_rows`` rows have been loaded."""
        idle = 0
        while True:
            batch = source.poll(poll_timeout_s)
            if batch:
                idle = 0
                self.push_delimited(batch)
            else:
                idle += 1
                if idle_limit is not None and idle >= idle_limit:
                    break
            if max_rows is not None and (
                self.stats.rows_loaded + len(self._buf) >= max_rows
            ):
                break
        self.flush()
        return self.stats

    def _reject(self, sample: str) -> None:
        s = self.stats
        s.rows_rejected += 1
        if len(s.rejected_samples) < self.MAX_REJECT_SAMPLES:
            s.rejected_samples.append(sample[:500])
        if s.rows_rejected > self.max_reject:
            raise SqlError(
                f"stream ingest aborted: {s.rows_rejected} rejected rows "
                f"exceed max_reject={self.max_reject}"
            )

    def _check_open(self):
        if self._closed:
            raise SqlError("stream importer is closed")


def _type_field(f: str, cd):
    """One raw field → python value per the column type (NULL tokens
    like the reference CopyParams null_str)."""
    if f in ("", r"\N", "NULL", "null"):
        return None
    t = cd.type
    if t.is_boolean:
        lf = f.strip().lower()
        if lf in ("t", "true", "1"):
            return True
        if lf in ("f", "false", "0"):
            return False
        raise ValueError(f)
    if t.is_integer or t.is_time:
        if t.is_time and not f.strip().lstrip("+-").isdigit():
            return f.strip()  # date/timestamp literals type via to_physical
        return int(f)
    if t.is_fp or t.is_decimal:
        return float(f)
    return f


class FileTailSource:
    """Follow a growing file — the no-egress stand-in for a Kafka topic
    partition (poll returns newly appended complete lines)."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._carry = ""

    def poll(self, timeout_s: float = 1.0):
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
            if size > self._pos:
                with open(self.path, "r") as fh:
                    fh.seek(self._pos)
                    chunk = fh.read()
                    self._pos = fh.tell()
                data = self._carry + chunk
                lines = data.split("\n")
                self._carry = lines.pop()  # partial trailing line
                if lines:
                    return lines
            if time.monotonic() >= deadline:
                return None
            time.sleep(min(0.01, timeout_s))


class KafkaSource:
    """Gated Kafka consumer adapter (reference KafkaImporter.cpp).  This
    environment has no egress/librdkafka; pass a pre-built consumer with
    a ``poll(timeout)`` returning message objects with ``.value()``."""

    def __init__(self, consumer=None, **conf):
        if consumer is None:
            raise SqlError(
                "KafkaSource needs a consumer object (no Kafka client "
                "library in this environment); pass e.g. a "
                "confluent_kafka.Consumer"
            )
        self.consumer = consumer

    def poll(self, timeout_s: float = 1.0):
        msg = self.consumer.poll(timeout_s)
        if msg is None:
            return None
        err = getattr(msg, "error", lambda: None)()
        if err:
            return None
        v = msg.value()
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        return v.splitlines()
