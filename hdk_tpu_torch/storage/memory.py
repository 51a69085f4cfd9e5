"""Device memory budget manager.

Reference: omniscidb/DataMgr — slab allocators with LRU segment
eviction over a fixed GPU buffer pool (BufferMgr, min/max slab sizes,
Shared/Config.h:143-159).  On TPU, XLA owns physical HBM allocation;
what the engine controls is which *table columns* stay resident.  This
manager tracks the bytes of cached device columns and evicts
least-recently-used ones when a budget is exceeded (eviction drops the
engine's reference; HBM is reclaimed when no live result still uses the
buffer).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

DEFAULT_BUDGET = 12 << 30  # leave headroom out of ~16GB HBM (v5e)


class DeviceCacheManager:
    """LRU over column device caches (process-wide singleton)."""

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
        """Record that a column's device copy exists / was touched."""
        key = id(column)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            else:
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
