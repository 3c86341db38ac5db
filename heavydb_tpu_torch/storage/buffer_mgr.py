"""Device buffer cache with a byte budget and LRU eviction.

The role of the reference's slab BufferMgr (DataMgr/BufferMgr/
BufferMgr.h:115-236: pre-allocated slabs, BufferSeg free lists, LRU
eviction).  PyTorch's caching allocator owns the memory, so the cache
manages *references*: evicting an entry drops our handle and the allocator
reuses the memory once no queued kernel holds it.  In-use buffers are therefore naturally
"pinned" by their consumers — eviction can never corrupt a running query,
it only bounds what the cache keeps alive across queries.  One lock
serialises the cache's operations: concurrent queries share it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterator, Optional, Tuple


def _nbytes(v) -> int:
    if hasattr(v, "nbytes"):
        return int(v.nbytes)
    if isinstance(v, (tuple, list)):
        return sum(_nbytes(x) for x in v)
    return 0


class DeviceLRUCache:
    """Mapping from cache key → device array (or pytree of arrays) with
    LRU eviction once total bytes exceed `budget_bytes` (0 = unbounded)."""

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        self._data: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.RLock()
        self._bytes = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    # -- dict-ish API used by the executor --
    def get(self, key, default=None):
        with self._lock:
            v = self._data.get(key)
            if v is None:
                self.misses += 1
                return default
            self._data.move_to_end(key)
            self.hits += 1
            return v

    def __setitem__(self, key, value):
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= _nbytes(old)
            self._data[key] = value
            self._bytes += _nbytes(value)
            self._evict()

    def __contains__(self, key):
        return key in self._data

    def __len__(self):
        return len(self._data)

    def items(self) -> Iterator[Tuple[tuple, object]]:
        """A snapshot of the entries."""
        with self._lock:
            return list(self._data.items())

    def clear(self):
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def pop(self, key, default=None):
        with self._lock:
            v = self._data.pop(key, default)
            if v is not default:
                self._bytes -= _nbytes(v)
            return v

    def evict_table(self, table_id: int):
        """Invalidate all entries whose key starts with this table id
        (UPDATE/DELETE/generation bumps)."""
        with self._lock:
            for k in [k for k in self._data if k and k[0] == table_id]:
                self.pop(k)

    @property
    def total_bytes(self) -> int:
        return self._bytes

    def _evict(self):
        if self.budget_bytes <= 0:
            return
        while self._bytes > self.budget_bytes and len(self._data) > 1:
            _, v = self._data.popitem(last=False)
            self._bytes -= _nbytes(v)
            self.evictions += 1

    def stats(self) -> dict:
        return {
            "entries": len(self._data),
            "bytes": self._bytes,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


def default_device_budget(device) -> int:
    """Cache budget: ~70% of the device memory free at start-up on CUDA
    (torch.cuda.mem_get_info), 8 GB for the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * 0.7)
    return 8 << 30
