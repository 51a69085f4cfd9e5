"""Columnar in-memory tables (counterpart of hdk_tpu/storage/table.py).

Host tier: each column is a contiguous numpy array with an optional
validity mask (True = valid), split into logical row fragments that carry
min/max/null stats for layout choice.  Device tier: on first use a column
becomes torch tensors on the session's device, cached per device under the
shared ``storage/memory.py`` LRU budget.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as t

ROWID_NAME = "rowid"  # hidden virtual column


@dataclass(frozen=True)
class ColumnInfo:
    table_id: int
    col_idx: int
    name: str
    type: t.Type
    is_rowid: bool = False


@dataclass(frozen=True)
class FragmentStats:
    row_start: int
    row_end: int
    min_val: Optional[float]
    max_val: Optional[float]
    null_count: int


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array (never a view of it: the executor
    may update device tensors in place)."""
    with warnings.catch_warnings():
        # a read-only array is fine: the view below is copied at once
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        host = torch.from_numpy(np.ascontiguousarray(arr))
    return host.clone() if device.type == "cpu" else host.to(device)


class Column:
    """One column: host numpy data (+validity) with cached device copies."""

    def __init__(self, info: ColumnInfo, data: np.ndarray,
                 validity: Optional[np.ndarray] = None) -> None:
        if data.ndim != 1:
            raise NotImplementedError(
                "array columns are not ported yet (ROADMAP A3)")
        if validity is not None:
            if validity.dtype != np.bool_ or validity.shape != data.shape:
                raise ValueError("validity must be a bool array shaped "
                                 "like the data")
            if bool(validity.all()):
                validity = None
        self.info = info
        self.data = data
        self.validity = validity
        self._device: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
        self._lock = threading.Lock()

    @property
    def type(self) -> t.Type:
        return self.info.type

    def __len__(self) -> int:
        return len(self.data)

    def has_nulls(self) -> bool:
        return self.validity is not None

    def device_arrays(self, device: torch.device):
        """(data, mask_or_None) as tensors on ``device``, cached with
        LRU-budget accounting."""
        from .memory import device_cache_manager

        key = str(device)
        with self._lock:
            got = self._device.get(key)
            if got is None:
                got = (to_device(self.data, device),
                       None if self.validity is None
                       else to_device(self.validity, device))
                self._device[key] = got
        nbytes = self.data.nbytes + (
            self.validity.nbytes if self.validity is not None else 0)
        # note_use may evict THIS column when the budget is smaller than
        # one column: return the local handle, not the cache entry
        device_cache_manager().note_use(self, nbytes)
        return got

    def drop_device_cache(self, _from_manager: bool = False) -> None:
        with self._lock:
            self._device = {}
        if not _from_manager:
            from .memory import device_cache_manager

            device_cache_manager().note_drop(self)

    def fragment_stats(self, row_start: int, row_end: int) -> FragmentStats:
        sl = self.data[row_start:row_end]
        if self.validity is not None:
            v = self.validity[row_start:row_end]
            nulls = int((~v).sum())
            sl = sl[v]
        else:
            nulls = 0
        if sl.size == 0 or sl.dtype == object or sl.dtype == np.bool_:
            return FragmentStats(row_start, row_end, None, None, nulls)
        return FragmentStats(row_start, row_end, sl.min().item(),
                             sl.max().item(), nulls)


class Table:
    """An in-memory columnar table split into row fragments."""

    def __init__(self, table_id: int, name: str, columns: Sequence[Column],
                 fragment_size: int, process_local: bool = False) -> None:
        if not columns:
            raise ValueError("table must have at least one column")
        if process_local:
            raise NotImplementedError(
                "process-local tables need multi-device sessions "
                "(ROADMAP A9)")
        nrows = len(columns[0])
        if any(len(c) != nrows for c in columns):
            raise ValueError("ragged columns")
        self.table_id = table_id
        self.name = name
        self.columns: List[Column] = list(columns)
        self._by_name: Dict[str, Column] = {c.info.name: c for c in columns}
        self.nrows = nrows
        self.fragment_size = max(1, fragment_size)
        self._stats: Dict[Tuple[int, int], FragmentStats] = {}
        self._stats_lock = threading.Lock()

    def column_names(self, include_rowid: bool = False) -> List[str]:
        return [c.info.name for c in self.columns
                if include_rowid or not c.info.is_rowid]

    def column(self, name: str) -> Column:
        col = self._by_name.get(name)
        if col is None:
            if name == ROWID_NAME:
                return self._make_rowid()
            raise KeyError(f"no column {name!r} in table {self.name!r}")
        return col

    def _make_rowid(self) -> Column:
        info = ColumnInfo(self.table_id, len(self.columns), ROWID_NAME,
                          t.int64(nullable=False), is_rowid=True)
        col = Column(info, np.arange(self.nrows, dtype=np.int64))
        self._by_name[ROWID_NAME] = col
        self.columns.append(col)
        return col

    @property
    def fragments(self) -> List[Tuple[int, int]]:
        out = [(s, min(s + self.fragment_size, self.nrows))
               for s in range(0, self.nrows, self.fragment_size)]
        return out or [(0, 0)]

    def stats(self, name: str, frag: Tuple[int, int]) -> FragmentStats:
        key = (self.column(name).info.col_idx, frag[0])
        with self._stats_lock:
            st = self._stats.get(key)
            if st is None:
                st = self.column(name).fragment_stats(*frag)
                self._stats[key] = st
        return st

    def column_range(self, name: str
                     ) -> Tuple[Optional[float], Optional[float], bool]:
        """Whole-table (min, max, has_nulls) from fragment stats."""
        lo: Optional[float] = None
        hi: Optional[float] = None
        has_nulls = False
        for frag in self.fragments:
            st = self.stats(name, frag)
            has_nulls |= st.null_count > 0
            if st.min_val is not None:
                lo = st.min_val if lo is None else min(lo, st.min_val)
                hi = st.max_val if hi is None else max(hi, st.max_val)
        return lo, hi, has_nulls
