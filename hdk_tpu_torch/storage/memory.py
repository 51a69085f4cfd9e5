"""Device memory budget manager.

Reference: omniscidb/DataMgr — slab allocators with LRU segment
eviction over a fixed GPU buffer pool (BufferMgr, min/max slab sizes,
Shared/Config.h:143-159).  PyTorch's caching allocator owns the device
memory; what the engine controls is which table columns and query
results stay resident.  This manager tracks the bytes of cached device
columns and of results, and evicts the least recently used when a budget
is exceeded: a column drops its device copies, a result moves to host
memory (``QueryResult.offload``).  The memory returns to the allocator
once nothing else holds the tensors.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

# 12 GiB of one H100's 80 GB for cached columns and results; the rest is
# the working memory of a query's steps
DEFAULT_BUDGET = 12 << 30


class DeviceCacheManager:
    """LRU over column device caches and results (process-wide
    singleton)."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET) -> None:
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()
        self._bytes = 0
        self.evictions = 0

    def set_budget(self, budget_bytes: int) -> None:
        with self._lock:
            self.budget = budget_bytes
        self._maybe_evict()

    def note_use(self, column, nbytes: int) -> None:
        """Record that a column's device copies exist / were touched;
        ``nbytes`` is their size now (a column may hold its whole copy
        and copies of fragment selections)."""
        key = id(column)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (column, nbytes)
            self._bytes += nbytes
        self._maybe_evict()

    def note_drop(self, column) -> None:
        key = id(column)
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry[1]

    def _maybe_evict(self) -> None:
        """Evict LRU columns until under budget (reference: BufferMgr LRU
        segment eviction)."""
        while True:
            with self._lock:
                if self._bytes <= self.budget or not self._entries:
                    return
                _key, (column, nbytes) = self._entries.popitem(last=False)
                self._bytes -= nbytes
                self.evictions += 1
            column.drop_device_cache(_from_manager=True)

    @property
    def resident_bytes(self) -> int:
        return self._bytes


_manager: Optional[DeviceCacheManager] = None
_manager_lock = threading.Lock()


def device_cache_manager() -> DeviceCacheManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = DeviceCacheManager()
        return _manager
