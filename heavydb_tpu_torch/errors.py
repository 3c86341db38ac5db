"""Engine error hierarchy.

Mirrors the reference's error/retry taxonomy: QueryMustRunOnCpu,
CardinalityEstimationRequired, overflow/underflow device error codes
(QueryEngine/ErrorHandling.h, Execute.cpp retry loop in
executeWorkUnitImpl:2213) — but in our engine "retry" means re-trace the
XLA program with a larger static output shape rather than re-JIT LLVM.
"""

from __future__ import annotations


class HeavyTpuError(Exception):
    """Base class for all engine errors."""


class SqlError(HeavyTpuError):
    """SQL parse/analyze errors (syntax, unknown column, type mismatch)."""


class ParserError(SqlError):
    pass


class BinderError(SqlError):
    pass


class CatalogError(HeavyTpuError):
    """Unknown/duplicate table, column, dictionary."""


class StorageError(HeavyTpuError):
    pass


class ExecutionError(HeavyTpuError):
    """Runtime query execution failure."""


class OverflowOrUnderflow(ExecutionError):
    """Arithmetic overflow detected at runtime (reference ERR_OVERFLOW_OR_UNDERFLOW)."""


class DivisionByZero(ExecutionError):
    """Reference ERR_DIV_BY_ZERO."""


class OutOfSlots(ExecutionError):
    """Hash-table/output buffer exceeded its static capacity; the executor
    retries with a larger capacity (reference ERR_OUT_OF_SLOTS retry)."""

    def __init__(self, needed: int, capacity: int):
        super().__init__(f"needed {needed} slots, capacity {capacity}")
        self.needed = needed
        self.capacity = capacity


class CardinalityEstimationRequired(ExecutionError):
    """Group-by cardinality unknown; run NDV estimator then retry
    (reference QueryEngine/CardinalityEstimator.h)."""


class DeviceMemoryExceeded(ExecutionError):
    """A Compound's working set does not fit the device's free memory, not
    even one fragment at a time; raised at plan time, before any launch."""


class WatchdogException(ExecutionError):
    """Static watchdog rejected the query (reference ERR_WATCHDOG)."""


class QueryTimedOut(ExecutionError):
    """Dynamic watchdog deadline exceeded."""


class QueryInterrupted(ExecutionError):
    """Session interrupt (reference ERR_INTERRUPTED)."""


class NotSupported(HeavyTpuError):
    """Feature recognized but not implemented yet."""
