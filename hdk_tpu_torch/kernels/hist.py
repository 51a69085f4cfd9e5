"""Dense-histogram kernels of the perfect-hash GROUP BY.

Four wrappers keep the names of the TPU kernels they replace
(``hdk_tpu/ops/pallas_*.py``) and launch ``csrc/hist.cu`` (K1) or
``csrc/int_hist.cu`` (K2, K3, K4) on a CUDA tensor:

  * ``count_hist``     (K4, pallas_hist2.py)  counts of gid      -> (E,) int64
  * ``groupby_sums2``  (K2, pallas_groupby.py) bool slots       -> (E, S) int64
  * ``seg_sums_exact`` (K3, pallas_hist.py)   int8..int64 slots -> (L, E) int64
  * ``groupby_sums``   (K1, pallas_groupby.py) S f32/f64 columns -> (E, S) float64

Each computes, over the rows r with 0 <= gid[r] < E, the sum of the row's
slot values per gid; rows with gid outside [0, E) drop out.  The TPU
kernels' limits (E <= 4096, |v| <= 255, N < 2^24, f32 accumulators) came
from the MXU and do not apply: results are exact int64 (wrapping like
int64 addition) and float64.

``gid`` is an int32 array, or a ``DenseKeys`` source: the perfect-hash
layout's key columns, from which each kernel computes a row's dense id in
registers (``csrc/dense_gid.cuh``) instead of reading an array that a
chain of int64 passes built.  A keyed launch counts under its wrapper's
name like any other.

Each wrapper has a plain PyTorch version beside it (``*_ref``; for a
``DenseKeys`` source it builds the array with ``DenseKeys.gid`` first).  A
CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises; any other device raises.  ``<wrapper>.launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

# the most shared memory a block's (S x E) partials may take (H100: 227
# KB per block at most)
SMEM_LIMIT_BYTES = 200 * 1024

# K1 (csrc/hist.cu::k1_kernel): columns per launch, and the most entries
# for which each warp keeps a private (S x E) copy (above it one copy per
# block is faster: measured on one H100, PERF.md)
K1_MAX_COLS = 8
K1_PRIVATE_MAX_ENTRIES = 16

# K2-K4 (csrc/int_hist.cu::int_hist_kernel): columns per launch; a copy of
# the partials per lane while S x E is at most INT_LANE_MAX_CELLS, else one
# per block over at most INT_MAX_RANGES ranges of E that fit in
# SMEM_LIMIT_BYTES (a launch each), else global atomics (measured on one
# H100, PERF.md)
INT_MAX_COLS = 8
INT_LANE_MAX_CELLS = 64
INT_MAX_RANGES = 3

_INT_SUFFIX = {torch.int8: "i8", torch.int16: "i16", torch.int32: "i32",
               torch.int64: "i64"}
_FLOAT_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# the dense-key source on the card: at most MAX_KEYS keys, each read at its
# stored width as a signed integer (a bool as its 0/1 byte)
MAX_KEYS = 4
_KEY_WIDTH = {torch.bool: 1, torch.int8: 1, torch.int16: 2, torch.int32: 4,
              torch.int64: 8}


@dataclass(frozen=True, eq=False)
class DenseKeys:
    """The group ids of the perfect-hash layout, as a source in place of a
    gid array: row r's id is ``sum((keys[i][r] - mins[i]) * stride_i)`` in
    int64, first key outermost (``stride_i`` the product of the later
    sizes), a NULL key (``valid[i][r]`` False) taking its last slot
    ``sizes[i] - 1``; the row drops out when the id lies outside [0,
    n_entries) or ``row_mask[r]`` is False.  With no keys every live row
    is entry 0 (a scalar aggregate).  A wrapper handed this source sums
    into exactly ``n_entries`` entries.  ``device`` is that of the
    tensors, where there are any."""

    keys: Tuple[torch.Tensor, ...]
    valid: Tuple[Optional[torch.Tensor], ...]
    mins: Tuple[int, ...]
    sizes: Tuple[int, ...]
    row_mask: Optional[torch.Tensor]
    n_rows: int
    device: torch.device

    def __post_init__(self):
        if not (len(self.keys) == len(self.valid) == len(self.mins)
                == len(self.sizes)):
            raise ValueError("keys, validity, mins and sizes differ in length")
        tensors = [t for t in (*self.keys, *self.valid, self.row_mask)
                   if t is not None]
        object.__setattr__(self, "device", tensors[0].device if tensors
                           else torch.device(self.device))
        for t in tensors:
            if t.dim() != 1 or t.shape[0] != self.n_rows:
                raise ValueError(f"key column {tuple(t.shape)} does not "
                                 f"match {self.n_rows} rows")
            if t.device != self.device:
                raise ValueError(f"tensors on {self.device} and {t.device}")
        for t in (*self.valid, self.row_mask):
            if t is not None and t.dtype != torch.bool:
                raise ValueError(f"validity and row masks are bool, got "
                                 f"{t.dtype}")

    @property
    def n_entries(self) -> int:
        return int(math.prod(self.sizes))

    def strides(self) -> List[int]:
        out, acc = [], 1
        for size in reversed(self.sizes):
            out.append(acc)
            acc *= size
        return out[::-1]

    def kernel_ready(self) -> bool:
        """The kernels can derive the ids: at most ``MAX_KEYS`` keys of
        the widths they read, and E within int32."""
        return (len(self.keys) <= MAX_KEYS
                and all(k.dtype in _KEY_WIDTH for k in self.keys)
                and self.n_entries <= torch.iinfo(torch.int32).max)

    def gid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int32 id per row, in-range mask): the array the kernels never
        build, a row that drops out taking the discard id ``n_entries``."""
        n = self.n_entries
        gid = torch.zeros((self.n_rows,), dtype=torch.int64,
                          device=self.device)
        # row-major over keys, first key outermost
        for key, valid, mn, size, stride in zip(
                reversed(self.keys), reversed(self.valid),
                reversed(self.mins), reversed(self.sizes),
                reversed(self.strides())):
            idx = key.to(torch.int64) - mn
            if valid is not None:
                idx = torch.where(valid, idx, size - 1)
            gid = gid + idx * stride
        in_range = (gid >= 0) & (gid < n)
        if self.row_mask is not None:
            in_range = in_range & self.row_mask
        return torch.where(in_range, gid, n).to(torch.int32), in_range

    def struct(self):
        """(``build.DenseKeysC`` of this source, the tensors it points
        at): each column 16-byte aligned, copied where it is not; keep the
        tensors until the launch is issued."""
        from .build import DenseKeysC

        if not self.kernel_ready():
            raise ValueError(f"no kernel takes keys of "
                             f"{[str(k.dtype) for k in self.keys]}")
        keys = [_aligned(k) for k in self.keys]
        valid = [None if v is None else _aligned(v) for v in self.valid]
        mask = None if self.row_mask is None else _aligned(self.row_mask)
        c = DenseKeysC()
        for i, (k, v, mn, size, stride) in enumerate(zip(
                keys, valid, self.mins, self.sizes, self.strides())):
            c.key[i] = k.data_ptr()
            c.valid[i] = None if v is None else v.data_ptr()
            c.width[i] = _KEY_WIDTH[k.dtype]
            c.min[i], c.size[i], c.stride[i] = mn, size, stride
        c.row_mask = None if mask is None else mask.data_ptr()
        c.n_keys = len(keys)
        c.n_entries = self.n_entries
        return c, (keys, valid, mask)


GidSource = Union[torch.Tensor, DenseKeys]


def _gid_array(gid: GidSource) -> torch.Tensor:
    """The int32 ids of a source, built for a plain version."""
    return gid.gid()[0] if isinstance(gid, DenseKeys) else gid


def _n_rows(gid: GidSource) -> int:
    return gid.n_rows if isinstance(gid, DenseKeys) else gid.shape[0]


def _route(gid: GidSource, *others: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version; raises on a
    device that has neither, or on mixed devices."""
    for o in others:
        if o.device != gid.device:
            raise ValueError(f"tensors on {gid.device} and {o.device}")
    if gid.device.type == "cuda":
        return True
    if gid.device.type == "cpu":
        return False
    raise ValueError(f"no histogram kernel for device {gid.device}")


def _check_gid(gid: GidSource, n: int) -> None:
    if isinstance(gid, DenseKeys):
        if n != gid.n_entries:
            raise ValueError(f"a dense-key source sums into its layout's "
                             f"{gid.n_entries} entries, not {n}")
        return
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError(f"gid must be 1-D int32, got {gid.dtype} "
                         f"{tuple(gid.shape)}")


def _check_rows(gid: GidSource, vals: torch.Tensor) -> None:
    if vals.dim() != 2 or vals.shape[0] != _n_rows(gid):
        raise ValueError(f"slots {tuple(vals.shape)} do not match "
                         f"{_n_rows(gid)} rows")


def _source(gid: GidSource):
    """(the gid array a launch reads, or the key source; its pointer; the
    DenseKeys struct's pointer or None; what to keep until the launch is
    issued)."""
    if isinstance(gid, DenseKeys):
        struct, keep = gid.struct()
        return gid, None, ctypes.byref(struct), (struct, keep)
    gid = _aligned(gid)
    return gid, gid.data_ptr(), None, None


def _launch(name: str, gid: GidSource, *args) -> None:
    from . import build

    if isinstance(gid, torch.Tensor) and not gid.is_contiguous():
        raise ValueError(f"{name}: gid must be contiguous")
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        err = getattr(build.library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _live(gid: torch.Tensor, n: int) -> torch.Tensor:
    return (gid >= 0) & (gid < n)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels' 16-byte loads can read it, else a
    contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


# -- K2, K3 and K4: one integer histogram (csrc/int_hist.cu) -------------

def _partial_bytes(dtype) -> int:
    """Bytes of one partial sum of int_hist_kernel: 32-bit for counts
    (``dtype`` None), bool, int8 and int16, 64-bit for int32 and int64."""
    return 8 if dtype in (torch.int32, torch.int64) else 4


def _int_span(n_slots: int, dtype) -> int:
    """Entries of one block-shared (S x E) copy within SMEM_LIMIT_BYTES."""
    return SMEM_LIMIT_BYTES // (n_slots * _partial_bytes(dtype))


def _int_mode(n_slots: int, n_entries: int, dtype=None) -> int:
    """Where the integer kernel's partials go, for ``n_slots`` columns of
    ``dtype`` (None: counts): 2 a copy per lane, 1 one copy per block (over
    several ranges of E when one copy does not fit), 0 global atomics."""
    if n_slots * n_entries <= INT_LANE_MAX_CELLS:
        return 2
    if n_entries <= INT_MAX_RANGES * _int_span(n_slots, dtype):
        return 1
    return 0


def _int_ranges(mode: int, n_slots: int, n_entries: int,
                dtype=None) -> List[Tuple[int, int]]:
    """[lo, hi) entry ranges of a call, one launch each: several only for
    a block-shared copy larger than shared memory, split evenly."""
    if mode != 1:
        return [(0, n_entries)]
    span = _int_span(n_slots, dtype)
    k = -(-n_entries // span)
    width = -(-n_entries // k)
    return [(lo, min(lo + width, n_entries))
            for lo in range(0, n_entries, width)]


def count_hist_ref(gid: GidSource, n: int) -> torch.Tensor:
    gid = _gid_array(gid)
    live = _live(gid, n)
    return torch.bincount(gid[live].long(), minlength=n)[:n]


def count_hist(gid: GidSource, n: int) -> torch.Tensor:
    """(n,) int64 counts of gid values in [0, n)."""
    _check_gid(gid, n)
    if not _route(gid):
        return count_hist_ref(gid, n)
    out = torch.zeros((n,), dtype=torch.int64, device=gid.device)
    n_rows = _n_rows(gid)
    if n_rows == 0 or n == 0:
        return out
    gid, gid_ptr, keys, _keep = _source(gid)
    mode = _int_mode(1, n)
    for lo, hi in _int_ranges(mode, 1, n):
        _launch("hdk_count_hist", gid, gid_ptr, n_rows, lo, hi - lo,
                out.data_ptr() + 8 * lo, mode, keys)
        count_hist.launches += 1
    return out


def _slot_columns(name: str, gid: GidSource, slots, what: str,
                  dtypes) -> List[torch.Tensor]:
    """The 1-D columns of a list, or views of the columns of an (N, S)
    tensor; one dtype of ``dtypes`` (``what`` names them), one length."""
    if isinstance(slots, torch.Tensor):
        _check_rows(gid, slots)
        cols = list(slots.unbind(1))
    else:
        cols = list(slots)
        if not cols:
            raise ValueError(f"{name} takes at least one column")
        for c in cols:
            if c.dim() != 1 or c.shape[0] != _n_rows(gid):
                raise ValueError(f"column {tuple(c.shape)} does not match "
                                 f"{_n_rows(gid)} rows")
    dtype = cols[0].dtype if cols else slots.dtype
    if dtype not in dtypes or any(c.dtype != dtype for c in cols):
        raise ValueError(f"{name} takes {what} columns of one dtype, got "
                         f"{sorted({str(c.dtype) for c in cols})}")
    return cols


def _int_sums_ref(gid: GidSource, slots,
                  n_entries: int) -> torch.Tensor:
    """(n_entries, S) int64 sums of a list of S columns or an (N, S)
    tensor, by ``index_add_``."""
    gid = _gid_array(gid)
    vals = (slots if isinstance(slots, torch.Tensor)
            else torch.stack(list(slots), 1))
    live = _live(gid, n_entries)
    out = torch.zeros((n_entries, vals.shape[1]), dtype=torch.int64,
                      device=gid.device)
    return out.index_add_(0, gid[live].long(), vals[live].to(torch.int64))


def _int_hist(entry: str, wrapper, gid: GidSource,
              cols: List[torch.Tensor], n_entries: int) -> torch.Tensor:
    """(len(cols), n_entries) int64 sums of ``cols`` (one dtype) by the
    integer kernel's ``entry``, each column read where it lies (a
    misaligned or strided one is copied first), up to ``INT_MAX_COLS`` a
    launch; each launch counts on ``wrapper``."""
    dtype = cols[0].dtype if cols else None
    out = torch.zeros((len(cols), n_entries), dtype=torch.int64,
                      device=gid.device)
    n_rows = _n_rows(gid)
    if n_rows == 0 or n_entries == 0:
        return out
    gid, gid_ptr, keys, _keep = _source(gid)
    cols = [_aligned(c) for c in cols]
    for s0 in range(0, len(cols), INT_MAX_COLS):
        chunk = cols[s0:s0 + INT_MAX_COLS]
        ptrs = (ctypes.c_void_p * len(chunk))(*[c.data_ptr() for c in chunk])
        mode = _int_mode(len(chunk), n_entries, dtype)
        for lo, hi in _int_ranges(mode, len(chunk), n_entries, dtype):
            # out[s0, lo:], the first sum this launch writes
            first = out.data_ptr() + 8 * (s0 * n_entries + lo)
            _launch(entry, gid, gid_ptr, ptrs, n_rows, len(chunk), lo,
                    hi - lo, n_entries, first, mode, keys)
            wrapper.launches += 1
    return out


def groupby_sums2_ref(gid: GidSource, slots,
                      n_entries: int) -> torch.Tensor:
    return _int_sums_ref(gid, slots, n_entries)


def groupby_sums2(gid: GidSource, slots, n_entries: int) -> torch.Tensor:
    """(n_entries, S) int64 per-gid counts of True in S bool columns, read
    where they lie: a list of S 1-D columns, or an (N, S) tensor whose
    columns are taken as views.  Up to ``INT_MAX_COLS`` columns a
    launch."""
    _check_gid(gid, n_entries)
    cols = _slot_columns("groupby_sums2", gid, slots, "bool", (torch.bool,))
    if not _route(gid, *cols):
        return groupby_sums2_ref(gid, slots, n_entries)
    return _int_hist("hdk_groupby_sums2_b8", groupby_sums2, gid, cols,
                     n_entries).t()


def seg_sums_exact_ref(gid: GidSource, slots,
                       n_entries: int) -> torch.Tensor:
    return _int_sums_ref(gid, slots, n_entries).t()


def seg_sums_exact(gid: GidSource, slots, n_entries: int) -> torch.Tensor:
    """(L, n_entries) int64 per-gid sums of L integer columns of one dtype
    (int8, int16, int32 or int64), each read at its own width where it
    lies: an (N, L) tensor, whose columns are taken as views, or a list
    of L 1-D tensors (a misaligned or strided column is copied first).  Up
    to ``INT_MAX_COLS`` columns a launch.  Sums wrap like int64 addition."""
    _check_gid(gid, n_entries)
    cols = _slot_columns("seg_sums_exact", gid, slots, "int8..int64",
                         _INT_SUFFIX)
    if not _route(gid, *cols):
        return seg_sums_exact_ref(gid, slots, n_entries)
    entry = f"hdk_seg_sums_exact_{_INT_SUFFIX[cols[0].dtype]}"
    return _int_hist(entry, seg_sums_exact, gid, cols, n_entries)


# -- K1 ---------------------------------------------------------------------

def _check_cols(gid: GidSource, cols: List[torch.Tensor]) -> None:
    if not cols:
        raise ValueError("groupby_sums takes at least one column")
    dtype = cols[0].dtype
    if dtype not in _FLOAT_SUFFIX:
        raise ValueError(f"groupby_sums takes float32/float64 columns, got "
                         f"{dtype}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != _n_rows(gid):
            raise ValueError(f"column {tuple(c.shape)} does not match "
                             f"{_n_rows(gid)} rows")
        if c.dtype != dtype:
            raise ValueError(f"groupby_sums takes columns of one dtype, got "
                             f"{dtype} and {c.dtype}")


def _k1_mode(n_slots: int, n_entries: int) -> int:
    """Where K1's warps add: 2 a private (S x E) copy per warp in shared
    memory, 1 one copy per block (shared atomics), 0 global atomics."""
    if n_entries <= K1_PRIVATE_MAX_ENTRIES:
        return 2
    return int(n_slots * n_entries * 8 <= SMEM_LIMIT_BYTES)


def groupby_sums_ref(gid: GidSource, cols: Sequence[torch.Tensor],
                     n_entries: int) -> torch.Tensor:
    gid = _gid_array(gid)
    live = _live(gid, n_entries)
    vals = torch.stack([c[live].to(torch.float64) for c in cols], dim=1)
    out = torch.zeros((n_entries, len(cols)), dtype=torch.float64,
                      device=gid.device)
    return out.index_add_(0, gid[live].long(), vals)


def groupby_sums(gid: GidSource, cols: Sequence[torch.Tensor],
                 n_entries: int) -> torch.Tensor:
    """(n_entries, S) float64 per-gid sums of S 1-D float32 or float64
    columns of one dtype, read where they lie (a misaligned or strided
    column is copied first).  Up to ``K1_MAX_COLS`` columns a launch.  The
    summation order varies from run to run on the card."""
    _check_gid(gid, n_entries)
    cols = list(cols)
    _check_cols(gid, cols)
    if not _route(gid, *cols):
        return groupby_sums_ref(gid, cols, n_entries)
    suffix = _FLOAT_SUFFIX[cols[0].dtype]
    n_rows = _n_rows(gid)
    gid, gid_ptr, keys, _keep = _source(gid)
    cols = [_aligned(c) for c in cols]
    out = torch.zeros((len(cols), n_entries), dtype=torch.float64,
                      device=gid.device)
    for s0 in range(0, len(cols), K1_MAX_COLS):
        chunk = cols[s0:s0 + K1_MAX_COLS]
        ptrs = (ctypes.c_void_p * len(chunk))(*[c.data_ptr() for c in chunk])
        _launch(f"hdk_groupby_sums_cols_{suffix}", gid, gid_ptr, ptrs,
                n_rows, len(chunk), n_entries, out[s0].data_ptr(),
                _k1_mode(len(chunk), n_entries), keys)
        groupby_sums.launches += 1
    return out.t()


KERNELS = (count_hist, groupby_sums2, seg_sums_exact, groupby_sums)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
