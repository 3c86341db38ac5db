"""Hierarchical per-query timers — the analogue of the reference's
DEBUG_TIMER tree (Logger/Logger.h:393-423, stopAndGetJson): RAII-nested
scopes aggregated per query, dumpable as JSON.

Each `scope(name)` has two outputs:
- the query's tree, built by a QueryTimer (`Config(enable_debug_timer=True)`),
  whose nodes may carry counters (`note`);
- while torch.profiler records, a profiler range named `hdb:<name>`
  (PREFIX), whatever the timer: a kineto user annotation on the device
  trace's clock, whose device-side copy spans the work the scope launched.
With the profiler off, NullTimer's scope is one shared no-op.  "Records"
is torch's own flag of an open profile (`_is_profiler_enabled`), which
every thread sees; the per-thread `torch.autograd._profiler_enabled()`
reads False in a client thread of a profile that records all threads.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import List, Optional

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

PREFIX = "hdb:"
NOOP = nullcontext()


class TimerNode:
    __slots__ = ("name", "start", "elapsed_ms", "children", "attrs")

    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()
        self.elapsed_ms = 0.0
        self.children: List[TimerNode] = []
        self.attrs: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {"name": self.name, "ms": round(self.elapsed_ms, 3)}
        if self.attrs:
            d.update(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _Scope:
    """One scope of a QueryTimer: its tree node, inside its profiler range
    while the profiler records."""
    __slots__ = ("timer", "name", "node", "range")

    def __init__(self, timer: "QueryTimer", name: str):
        self.timer = timer
        self.name = name

    def __enter__(self) -> TimerNode:
        self.range = record_function(PREFIX + self.name).__enter__() \
            if _profiler._is_profiler_enabled else None
        self.node = self.timer._open(self.name)
        return self.node

    def __exit__(self, *exc) -> bool:
        self.timer._close(self.node)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class QueryTimer:
    enabled = True

    def __init__(self):
        self.root: Optional[TimerNode] = None
        self._stack: List[TimerNode] = []

    def scope(self, name: str) -> _Scope:
        return _Scope(self, name)

    def _open(self, name: str) -> TimerNode:
        node = TimerNode(name)
        if self._stack:
            self._stack[-1].children.append(node)
        elif self.root is None:
            self.root = node
        else:
            # a scope after the root closed (the result's egress) joins it
            self.root.children.append(node)
        self._stack.append(node)
        return node

    def _close(self, node: TimerNode) -> None:
        node.elapsed_ms = (time.perf_counter() - node.start) * 1e3
        self._stack.pop()

    def add(self, node: Optional[TimerNode]) -> None:
        """A finished node (another timer's, such as the text's `parse`)
        as the next child of the innermost open scope."""
        if node is not None and self._stack:
            self._stack[-1].children.append(node)

    def note(self, **counters) -> None:
        """Counters on the innermost open scope's node (the root's once
        every scope closed)."""
        node = self._stack[-1] if self._stack else self.root
        if node is not None:
            if node.attrs is None:
                node.attrs = {}
            node.attrs.update(counters)

    def to_dict(self) -> Optional[dict]:
        return self.root.to_dict() if self.root else None


class NullTimer:
    """No tree: each scope is the profiler range alone, or the shared
    no-op while the profiler is off."""
    enabled = False
    root = None

    def scope(self, name: str):
        if _profiler._is_profiler_enabled:
            return record_function(PREFIX + name)
        return NOOP

    def add(self, node) -> None:
        pass

    def note(self, **counters) -> None:
        pass

    def to_dict(self):
        return None


NULL_TIMER = NullTimer()
