"""Scheduled foreign-table refresh — the reference's refresh scheduler
(Catalog/RefreshTimeCalculator.cpp + ForeignStorage scheduled refresh:
REFRESH_TIMING_TYPE='SCHEDULED', REFRESH_START_DATE_TIME,
REFRESH_INTERVAL options on CREATE FOREIGN TABLE).

The calculator aligns the next refresh to start + k·interval (strictly in
the future); the scheduler polls due tables and re-imports them.  Poll-
driven so tests and embedded use need no thread; the server runs the
thread variant.
"""

from __future__ import annotations

import datetime as _dt
import re
import threading
import time
from typing import Dict, List, Optional

from heavydb_tpu_torch.errors import SqlError

_INTERVAL_RE = re.compile(r"^\s*(\d+)\s*([SMHD])\s*$", re.I)
_UNIT_S = {"S": 1, "M": 60, "H": 3600, "D": 86400}


def parse_interval(s: str) -> int:
    """'30S' / '10M' / '2H' / '1D' → seconds (reference REFRESH_INTERVAL)."""
    m = _INTERVAL_RE.match(str(s))
    if not m:
        raise SqlError(
            f"bad REFRESH_INTERVAL {s!r} (expected <n>S|M|H|D)"
        )
    return int(m.group(1)) * _UNIT_S[m.group(2).upper()]


def parse_start(s: Optional[str]) -> Optional[float]:
    if s is None:
        return None
    try:
        dt = _dt.datetime.fromisoformat(str(s))
    except ValueError as e:
        raise SqlError(f"bad REFRESH_START_DATE_TIME {s!r}") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.timestamp()


def next_refresh_time(options: Dict, last_refresh: Optional[float],
                      now: float) -> Optional[float]:
    """None for MANUAL tables; else the next due timestamp — aligned to
    start + k·interval, strictly after max(now, last_refresh)
    (reference RefreshTimeCalculator::getNextRefreshTime)."""
    timing = str(options.get("refresh_timing_type", "MANUAL")).upper()
    if timing != "SCHEDULED":
        return None
    interval = parse_interval(options.get("refresh_interval", "1D"))
    start = parse_start(options.get("refresh_start_date_time"))
    anchor = start if start is not None else (
        last_refresh if last_refresh is not None else now
    )
    base = max(now, last_refresh or 0.0)
    if anchor > base:
        return anchor
    k = int((base - anchor) // interval) + 1
    return anchor + k * interval


class RefreshScheduler:
    """Tracks per-table next_refresh and re-imports due foreign tables."""

    def __init__(self, db):
        self.db = db
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _foreign_tables(self):
        for name in self.db.catalog.list_tables():
            t = self.db.catalog.get_table_opt(name)
            if t is not None and getattr(t, "foreign", None) is not None:
                yield t

    def due_tables(self, now: Optional[float] = None) -> List:
        now = time.time() if now is None else now
        due = []
        for t in self._foreign_tables():
            f = t.foreign
            nxt = f.get("next_refresh")
            if nxt is None:
                # anchor at the last load/refresh, NOT the poll time —
                # otherwise the computed time always sits in the future
                # of the poll and nothing ever comes due
                anchor = f.get("last_refresh")
                nxt = next_refresh_time(
                    {k.lower(): v for k, v in f["options"].items()},
                    anchor, anchor if anchor is not None else now,
                )
                f["next_refresh"] = nxt
            if nxt is not None and now >= nxt:
                due.append(t)
        return due

    def poll(self, now: Optional[float] = None) -> int:
        """Refresh every due table; returns how many refreshed."""
        now = time.time() if now is None else now
        n = 0
        for t in self.due_tables(now):
            try:
                self.db._load_foreign(t)
                n += 1
            except Exception:
                pass  # source may be transiently missing; retry next tick
            f = t.foreign
            f["last_refresh"] = now
            f["next_refresh"] = next_refresh_time(
                {k.lower(): v for k, v in f["options"].items()}, now, now
            )
        return n

    # -- server-side thread --------------------------------------------
    def start(self, tick_s: float = 1.0):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(tick_s):
                try:
                    self.poll()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=loop, name="fsi-refresh", daemon=True
        )
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
