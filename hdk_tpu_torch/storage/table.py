"""Columnar in-memory tables (counterpart of hdk_tpu/storage/table.py).

Host tier: each column is a contiguous numpy array with an optional
validity mask (True = valid), split into logical row fragments that carry
min/max/null stats for layout choice.  Device tier: on first use a column
becomes torch tensors on the session's device, cached per device under the
shared ``storage/memory.py`` LRU budget; ``import_arrow`` can have the
ingest worker make that copy, and the fragment stats, in the background.
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


# copies of at least this many bytes between the host and a CUDA device,
# either way, go through a ring of pinned blocks: a copy from or to
# pageable memory runs at a fraction of the pinned rate (host to device
# 6.8 against 51.4 GB/s for 1 GiB on one H100's host)
STAGE_MIN_BYTES = 1 << 24
_STAGE_BLOCK = 1 << 25
_STAGE_SLOTS = 4
_stage_rings: Dict[str, tuple] = {}
_stage_lock = threading.Lock()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array (never a view of it: the executor
    may update device tensors in place)."""
    with warnings.catch_warnings():
        # a read-only array is fine: the view below is copied at once
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return host.clone()
    if host.nbytes < STAGE_MIN_BYTES:
        return host.to(device)
    return _staged_copy(host, device)


def to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor as a numpy array (a CPU tensor's own
    memory, not a copy).  A CUDA tensor of at least ``STAGE_MIN_BYTES``
    comes back block by block through the ring of pinned buffers, up to
    ``_STAGE_SLOTS`` device copies ahead of the host copies: on one
    H100's host a pageable copy of 1 GiB from the device ran at 2.5
    GB/s, a pinned one at 55 GB/s (chip_smoke.py phase 10)."""
    if x.device.type == "cpu":
        return x.numpy()
    if x.nbytes < STAGE_MIN_BYTES:
        return x.cpu().numpy()
    out = torch.empty(x.shape, dtype=x.dtype)
    src = x.contiguous().reshape(-1).view(torch.uint8)
    dst = out.reshape(-1).view(torch.uint8)
    blocks = [(s, min(src.numel(), s + _STAGE_BLOCK))
              for s in range(0, src.numel(), _STAGE_BLOCK)]
    stream = torch.cuda.current_stream(x.device)
    with _stage_lock:
        bufs, done = _stage_ring(x.device)

        def fetch(k):  # block k from the device into its pinned buffer
            s, e = blocks[k]
            slot = k % _STAGE_SLOTS
            done[slot].synchronize()
            bufs[slot][:e - s].copy_(src[s:e], non_blocking=True)
            done[slot].record(stream)

        for k in range(min(_STAGE_SLOTS, len(blocks))):
            fetch(k)
        for k, (s, e) in enumerate(blocks):
            slot = k % _STAGE_SLOTS
            done[slot].synchronize()
            dst[s:e].copy_(bufs[slot][:e - s])
            if k + _STAGE_SLOTS < len(blocks):
                fetch(k + _STAGE_SLOTS)
    return out.numpy()


def _stage_ring(device: torch.device):
    """The device's ring of pinned buffers and their events (the caller
    holds ``_stage_lock``)."""
    ring = _stage_rings.get(str(device))
    if ring is None:
        ring = ([torch.empty(_STAGE_BLOCK, dtype=torch.uint8,
                             pin_memory=True)
                 for _ in range(_STAGE_SLOTS)],
                [torch.cuda.Event() for _ in range(_STAGE_SLOTS)])
        _stage_rings[str(device)] = ring
    return ring


def _staged_copy(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a pageable host tensor to a CUDA device block by block
    through a ring of pinned buffers: each block is copied into a free
    pinned buffer on the host, then to the device without blocking, so
    the host copy of one block overlaps the device copy of the one
    before.  A buffer is reused once its last device copy has ended."""
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    src = host.reshape(-1).view(torch.uint8)
    dst = out.reshape(-1).view(torch.uint8)
    stream = torch.cuda.current_stream(device)
    with _stage_lock:
        bufs, done = _stage_ring(device)
        for k, s in enumerate(range(0, src.numel(), _STAGE_BLOCK)):
            e = min(src.numel(), s + _STAGE_BLOCK)
            slot = k % _STAGE_SLOTS
            done[slot].synchronize()
            buf = bufs[slot][:e - s]
            buf.copy_(src[s:e])
            dst[s:e].copy_(buf, non_blocking=True)
            done[slot].record(stream)
    return out


class Column:
    """One column: host numpy data (+validity) with cached device copies."""

    def __init__(self, info: ColumnInfo, data: np.ndarray,
                 validity: Optional[np.ndarray] = None) -> None:
        # ndim 2: a fixed-width array column (rows x width) whose
        # validity, shaped like it, marks the present elements (lists of
        # other lengths pad to the widest at ingest)
        if data.ndim not in (1, 2):
            raise ValueError("a column is 1-D, or 2-D for an array column")
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
        # a CUDA event after each copy the ingest worker made, until a
        # query has seen it complete
        self._ready: Dict[str, "torch.cuda.Event"] = {}
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
            self._wait_ready(key, device)
        # note_use may evict THIS column when the budget is smaller than
        # one column: return the local handle, not the cache entry
        device_cache_manager().note_use(self, self._device_bytes())
        return got

    def _wait_ready(self, key: str, device: torch.device) -> None:
        """Order the caller's stream after the ingest worker's copy of
        this column, if it made one that may still run (the caller holds
        ``_lock``)."""
        ready = self._ready.get(key)
        if ready is not None:
            if ready.query():
                del self._ready[key]
            else:
                torch.cuda.current_stream(device).wait_event(ready)

    def prefetch_device(self, device: torch.device) -> None:
        """Copy this column to ``device`` on the ingest worker, so that
        the next column's host decode overlaps this copy.  On a CUDA
        device the copy goes on the default stream and an event records
        its end; a query on any stream waits for it.  A failure only
        drops the cache: the query's own ``device_arrays`` call copies
        again and raises there."""
        def work():
            try:
                if device.type != "cuda":
                    self.device_arrays(device)
                    return
                stream = torch.cuda.default_stream(device)
                with torch.cuda.stream(stream), self._lock:
                    key = str(device)
                    if key not in self._device:
                        self._device[key] = (
                            to_device(self.data, device),
                            None if self.validity is None
                            else to_device(self.validity, device))
                        ev = torch.cuda.Event()
                        ev.record(stream)
                        self._ready[key] = ev
                from .memory import device_cache_manager

                device_cache_manager().note_use(self, self._device_bytes())
            except Exception:  # the foreground copy raises it again
                self.drop_device_cache()

        _ingest_pool().submit(work)

    def device_rows(self, device: torch.device,
                    ranges: Sequence[Tuple[int, int]]):
        """(data, mask_or_None) of the rows in ``ranges`` ((start, end)
        pairs, ascending) on ``device``.  A copy of the whole column
        already there is sliced on the device (a view for one range);
        else only these rows are copied from the host, and the copy stays
        in the device cache under the selection."""
        from .memory import device_cache_manager

        key = str(device)
        with self._lock:
            whole = self._device.get(key)
            self._wait_ready(key, device)
        if whole is not None:
            device_cache_manager().note_use(self, self._device_bytes())
            return tuple(None if x is None else _take_rows(x, ranges)
                         for x in whole)
        skey = f"{key}|{tuple(ranges)}"
        with self._lock:
            got = self._device.get(skey)
            if got is None:
                got = (to_device(_host_rows(self.data, ranges), device),
                       None if self.validity is None else
                       to_device(_host_rows(self.validity, ranges), device))
                self._device[skey] = got
        device_cache_manager().note_use(self, self._device_bytes())
        return got

    def _device_bytes(self) -> int:
        with self._lock:
            return sum(x.nbytes for pair in self._device.values()
                       for x in pair if x is not None)

    def drop_device_cache(self, _from_manager: bool = False) -> None:
        with self._lock:
            self._device = {}
            self._ready = {}
        if not _from_manager:
            from .memory import device_cache_manager

            device_cache_manager().note_drop(self)

    def fragment_stats(self, row_start: int, row_end: int) -> FragmentStats:
        if self.data.ndim > 1:  # array columns carry no range stats
            return FragmentStats(row_start, row_end, None, None, 0)
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


_INGEST_POOL = None
_INGEST_POOL_LOCK = threading.Lock()


def _ingest_pool():
    """The process's ingest worker: one thread keeps the prefetch copies
    in order and leaves the decoding thread the rest of the host."""
    global _INGEST_POOL
    with _INGEST_POOL_LOCK:
        if _INGEST_POOL is None:
            import concurrent.futures

            _INGEST_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hdk-torch-ingest")
        return _INGEST_POOL


class Table:
    """An in-memory columnar table split into row fragments."""

    def __init__(self, table_id: int, name: str, columns: Sequence[Column],
                 fragment_size: int, process_local: bool = False) -> None:
        if not columns:
            raise ValueError("table must have at least one column")
        nrows = len(columns[0])
        if any(len(c) != nrows for c in columns):
            raise ValueError("ragged columns")
        self.table_id = table_id
        self.name = name
        self.columns: List[Column] = list(columns)
        self._by_name: Dict[str, Column] = {c.info.name: c for c in columns}
        self.nrows = nrows
        # multi-controller ingest: the host data holds only this rank's
        # rows and ``nrows`` counts them; ``rank_rows`` (every rank's
        # count, in rank order) and the global column ranges come from
        # ``set_process_layout`` at ingest
        self.process_local = process_local
        self.rank_rows: List[int] = [nrows]
        self._global_ranges: Optional[Dict[str, tuple]] = None
        self.fragment_size = max(1, fragment_size)
        self._stats: Dict[Tuple[int, int], FragmentStats] = {}
        self._stats_lock = threading.Lock()
        # bumped on every append: plan-keyed artifacts (join build tables,
        # codecache.data_plan_sig) then miss
        self.generation = 0

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

    def prefetch_stats_async(self) -> None:
        """Compute every column's fragment stats on the ingest worker, so
        that the first query's layout choice reads them ready."""
        def work():
            try:
                for c in self.columns:
                    for frag in self.fragments:
                        self.stats(c.info.name, frag)
            except Exception:  # the query's own stats call raises it
                return

        _ingest_pool().submit(work)

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

    @property
    def global_nrows(self) -> int:
        """Rows over every rank (``nrows`` but for a process-local
        table)."""
        return sum(self.rank_rows) if self.process_local else self.nrows

    def set_process_layout(self, rank_rows: Sequence[int],
                           ranges: Dict[str, tuple]) -> None:
        """Every rank's row count and each column's (min, max, has_nulls)
        over every rank, for a process-local table: the planner reads
        these, so every rank plans alike."""
        self.rank_rows = [int(n) for n in rank_rows]
        self._global_ranges = dict(ranges)

    def column_range(self, name: str
                     ) -> Tuple[Optional[float], Optional[float], bool]:
        """Whole-table (min, max, has_nulls) from fragment stats (over
        every rank for a process-local table)."""
        if self._global_ranges is not None and name in self._global_ranges:
            return self._global_ranges[name]
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

    def append(self, columns: Sequence[Column]) -> None:
        """Append rows, one column per data column in order (the hidden
        rowid is rebuilt on demand).  Array columns pad both parts to the
        wider width, the pads absent."""
        if self.process_local:
            raise ValueError(f"process_local table {self.name!r} takes no "
                             "appends: its ranks' row counts are fixed at "
                             "ingest")
        data_cols = [c for c in self.columns if not c.info.is_rowid]
        if len(columns) != len(data_cols):
            raise ValueError("append needs one column per table column")
        new_cols: List[Column] = []
        for old, new in zip(data_cols, columns):
            if old.type.physical_dtype() != new.data.dtype:
                raise TypeError(f"append dtype mismatch on {old.info.name}")
            od, ov, nd_, nv = old.data, old.validity, new.data, new.validity
            if od.ndim == 2 or nd_.ndim == 2:
                width = max(od.shape[1], nd_.shape[1])
                od, ov = _pad_width(od, ov, width)
                nd_, nv = _pad_width(nd_, nv, width)
            validity = None
            if ov is not None or nv is not None:
                validity = np.concatenate([
                    ov if ov is not None else np.ones(od.shape, np.bool_),
                    nv if nv is not None else np.ones(nd_.shape, np.bool_)])
            new_cols.append(Column(old.info, np.concatenate([od, nd_]),
                                   validity))
        for c in data_cols:
            c.drop_device_cache()
        self.columns = new_cols
        self._by_name = {c.info.name: c for c in new_cols}
        self.nrows = len(new_cols[0])
        with self._stats_lock:
            self._stats.clear()
        self.generation += 1


def _host_rows(arr: np.ndarray, ranges: Sequence[Tuple[int, int]]
               ) -> np.ndarray:
    if len(ranges) == 1:
        return arr[ranges[0][0]:ranges[0][1]]
    return np.concatenate([arr[s:e] for s, e in ranges])


def _take_rows(x: torch.Tensor, ranges: Sequence[Tuple[int, int]]
               ) -> torch.Tensor:
    if len(ranges) == 1:
        return x.narrow(0, ranges[0][0], ranges[0][1] - ranges[0][0])
    return torch.cat([x[s:e] for s, e in ranges])


def _pad_width(data: np.ndarray, validity: Optional[np.ndarray],
               width: int) -> Tuple[np.ndarray, np.ndarray]:
    """An array column's data and element validity widened to
    ``width``."""
    if validity is None:
        validity = np.ones(data.shape, np.bool_)
    pad = width - data.shape[1]
    if pad > 0:
        rows = data.shape[0]
        data = np.concatenate([data, np.zeros((rows, pad), data.dtype)], 1)
        validity = np.concatenate([validity, np.zeros((rows, pad), np.bool_)],
                                  1)
    return data, validity
