"""Equi-join building blocks on torch tensors (counterpart of
hdk_tpu/exec/join.py).

Two routes, as in the JAX package:

* the **sorted-hash join**: every build key tuple hashes to 64 bits
  (a splitmix finalizer), a stable argsort of the hashes is the table,
  a probe is two ``searchsorted`` passes giving each probe row its range
  of candidates, the candidate pairs are expanded (``repeat_interleave``
  to the host-synced total) and verified on the true keys, which drops
  hash collisions;
* the **perfect join**: one integer-like key over a bounded range, unique
  on the build side: build row ids scattered into a dense table indexed
  by ``key - min_key``.

NULL keys never match: the two sides fold a NULL (or filter-dead) key
into disjoint hash sentinels, and the perfect table leaves them out.
The hash is the JAX package's bit for bit, so both packages expand the
same candidate pairs in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .groupby import _orderable_int64
from .masked import MaskedCol, combine_masks


def _i64(u: int) -> int:
    """A uint64 literal as its two's-complement int64 value (a Python int
    at or above 2^63 cannot enter a torch int64 operation)."""
    return u - (1 << 64) if u >= 1 << 63 else u


# disjoint NULL sentinels per side: a NULL never matches a NULL
_BUILD_NULL = _i64(0xF0F0F0F0F0F0F0F0)
_PROBE_NULL = _i64(0x0F0F0F0F0F0F0F0F)


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right of int64 (``>>`` is arithmetic: mask off the
    sign extension)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer in int64 arithmetic (torch's int64 multiply
    wraps like uint64's)."""
    x = x ^ _lsr(x, 30)
    x = x * _i64(0xBF58476D1CE4E5B9)
    x = x ^ _lsr(x, 27)
    x = x * _i64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def hash_keys(cols: Sequence[MaskedCol], null_sentinel: int) -> torch.Tensor:
    """Combined 64-bit hash of the key columns; a row with any NULL key
    gets ``null_sentinel``."""
    h = torch.full(cols[0].data.shape, 0x243F6A8885A308D3, dtype=torch.int64,
                   device=cols[0].data.device)
    valid = None
    for c in cols:
        h = _mix64(h ^ _mix64(_orderable_int64(c.data)))
        valid = combine_masks(valid, c.mask)
    if valid is not None:
        h = torch.where(valid, h, null_sentinel)
    return h


@dataclass
class BuildTable:
    """Sorted-hash table: build row ids ordered by hash, and the sorted
    hashes."""

    perm: torch.Tensor  # int64 build row ids
    sorted_hash: torch.Tensor


def build(build_keys: Sequence[MaskedCol]) -> BuildTable:
    h = hash_keys(build_keys, _BUILD_NULL)
    perm = torch.argsort(h, stable=True)
    return BuildTable(perm, h[perm])


def probe_ranges(table: BuildTable, probe_keys: Sequence[MaskedCol]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi): each probe row's candidate positions in the sorted table."""
    ph = hash_keys(probe_keys, _PROBE_NULL)
    lo = torch.searchsorted(table.sorted_hash, ph, side="left")
    hi = torch.searchsorted(table.sorted_hash, ph, side="right")
    return lo, hi


def expand_pairs(table: BuildTable, lo: torch.Tensor, hi: torch.Tensor,
                 total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate (probe row, build row) pairs, probe rows in order and
    each row's candidates in table order; ``total`` is the host-synced
    candidate count ``sum(hi - lo)``."""
    counts = hi - lo
    rows = torch.arange(lo.shape[0], dtype=torch.int64, device=lo.device)
    l_idx = torch.repeat_interleave(rows, counts, output_size=total)
    start = torch.cumsum(counts, 0) - counts  # exclusive offsets
    within = torch.arange(total, dtype=torch.int64,
                          device=lo.device) - start[l_idx]
    return l_idx, table.perm[lo[l_idx] + within]


def verify_pairs(build_keys: Sequence[MaskedCol],
                 probe_keys: Sequence[MaskedCol],
                 l_idx: torch.Tensor, r_idx: torch.Tensor) -> torch.Tensor:
    """True key equality of candidate pairs (the hash-collision guard)."""
    ok = torch.ones(l_idx.shape, dtype=torch.bool, device=l_idx.device)
    for pk, bk in zip(probe_keys, build_keys):
        eq = pk.data[l_idx] == bk.data[r_idx]
        if pk.mask is not None:
            eq = eq & pk.mask[l_idx]
        if bk.mask is not None:
            eq = eq & bk.mask[r_idx]
        ok = ok & eq
    return ok


@dataclass
class PerfectTable:
    """Dense one-to-one table: ``rows[key - min_key]`` is the build row
    id, -1 where no build row has that key."""

    rows: torch.Tensor  # (range_size,) int32
    min_key: int


def _slot_index(key: MaskedCol, min_key: int, range_size: int):
    """(key - min_key as int64, valid: in range and not NULL)."""
    idx = key.data.to(torch.int64) - min_key
    valid = (idx >= 0) & (idx < range_size)
    if key.mask is not None:
        valid = valid & key.mask
    return idx, valid


def build_perfect(build_key: MaskedCol, min_key: int, range_size: int):
    """(table, unique, n_set).  Invalid rows scatter into one extra slot
    that is cut off; a duplicate key loses a row in the scatter, which
    ``n_set < n_valid`` detects (which duplicate wins is unspecified)."""
    n = build_key.data.shape[0]
    dev = build_key.data.device
    pos = build_slots(build_key, min_key, range_size)
    rows = torch.full((range_size + 1,), -1, dtype=torch.int32, device=dev)
    rows[pos] = torch.arange(n, dtype=torch.int32, device=dev)
    rows = rows[:range_size]
    n_set = (rows >= 0).sum()
    return PerfectTable(rows, min_key), n_set == (pos < range_size).sum(), n_set


def probe_perfect(table: PerfectTable, probe_key: MaskedCol,
                  range_size: int) -> torch.Tensor:
    """Per probe row, its build row id (-1: no match; NULL never
    matches)."""
    slots, in_range = perfect_slots(probe_key, table.min_key, range_size)
    return torch.where(in_range, table.rows[slots], -1)


def perfect_slots(probe_key: MaskedCol, min_key: int, range_size: int):
    """(slot, in_range) per probe row, without reading the table."""
    idx, in_range = _slot_index(probe_key, min_key, range_size)
    return torch.clamp(idx, 0, range_size - 1), in_range


def perfect_match(table: PerfectTable, probe_key: MaskedCol, *,
                  range_size: int, complete: bool):
    """(slot, matched) per probe row.  ``complete`` (every slot occupied,
    known from the build) skips the occupancy read."""
    slots, in_range = perfect_slots(probe_key, table.min_key, range_size)
    if complete:
        return slots, in_range
    return slots, in_range & (table.rows[slots] >= 0)


def build_slots(build_key: MaskedCol, min_key: int,
                range_size: int) -> torch.Tensor:
    """Per build row, its key slot; ``range_size`` for NULL or out-of-range
    keys."""
    idx, valid = _slot_index(build_key, min_key, range_size)
    return torch.where(valid, idx, range_size)
