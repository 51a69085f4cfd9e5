"""Equi-join building blocks on torch tensors (counterpart of
hdk_tpu/exec/join.py).

Two routes, as in the JAX package:

* the **sorted-hash join**: every build key tuple hashes to 64 bits
  (a splitmix finalizer), a stable argsort of the hashes is the table,
  a probe is two ``searchsorted`` passes giving each probe row its range
  of candidates, the candidate pairs are expanded (``repeat_interleave``
  to the host-synced total) and verified on the true keys, which drops
  hash collisions; ``expand_pairs_capped`` expands into a fixed capacity
  without that sync and reports the true total, for the shard bodies of
  the distributed join;
* the **perfect join**: one integer-like key over a bounded range, unique
  on the build side: build row ids scattered into a dense table indexed
  by ``key - min_key``.  Its output reads **value tables**: each build
  column scattered once into key-slot order, so a probe row reads a
  column with one ``vt[slot]`` gather (no ``rows[slot]`` before it), and
  matching a complete table (every slot occupied) reads no table at all;
* the **delta-spread join** (``spread_inner_fk``), for a complete table
  whose probe rows all match: one sort of build and probe slots, the
  build columns' deltas following its permutation, and a prefix sum per
  column word give every probe row its build row's values, in slot
  order.

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


def expand_pairs_capped(table: BuildTable, lo: torch.Tensor,
                        hi: torch.Tensor, cap: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``expand_pairs`` into a fixed capacity, with no host sync (the
    shard bodies of the distributed join).  Returns (l_idx, r_idx, live,
    total): ``live`` marks the real pairs, slots past them are padding;
    ``total`` (0-d) is the true candidate count, so ``total > cap`` tells
    the caller to widen and retry.  Slot j belongs to the last probe row
    whose run starts at or before it: a binary search of the run starts.
    (The JAX package marks the run starts with a scatter-add and sums
    them up; on the card every empty run adds to one slot, and a shard's
    padding rows are all empty runs.)"""
    dev = lo.device
    n = lo.shape[0]
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    if n == 0 or table.perm.shape[0] == 0:
        zero = torch.zeros((cap,), dtype=torch.int64, device=dev)
        total = (hi - lo).sum() if n else torch.zeros(
            (), dtype=torch.int64, device=dev)
        return zero, zero, torch.zeros((cap,), dtype=torch.bool,
                                       device=dev), total
    counts = hi - lo
    offsets = torch.cumsum(counts, 0)  # inclusive
    excl = offsets - counts
    total = offsets[-1]
    l_idx = torch.clamp(torch.searchsorted(excl, j, right=True) - 1, 0,
                        n - 1)
    pos = lo[l_idx] + (j - excl[l_idx])
    r_idx = table.perm[torch.clamp(pos, 0, table.perm.shape[0] - 1)]
    return l_idx, r_idx, j < total, total


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
    """(table, unique, n_set, slots).  Invalid rows scatter into one extra
    slot that is cut off; a duplicate key loses a row in the scatter,
    which ``n_set < n_valid`` detects (which duplicate wins is
    unspecified).  ``slots``: each build row's slot (``build_slots``),
    from the same pass, which the value tables scatter through."""
    n = build_key.data.shape[0]
    dev = build_key.data.device
    pos = build_slots(build_key, min_key, range_size)
    rows = torch.full((range_size + 1,), -1, dtype=torch.int32, device=dev)
    rows[pos] = torch.arange(n, dtype=torch.int32, device=dev)
    rows = rows[:range_size]
    n_set = (rows >= 0).sum()
    return (PerfectTable(rows, min_key), n_set == (pos < range_size).sum(),
            n_set, pos)


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


def build_value_table(col: MaskedCol, slots: torch.Tensor,
                      range_size: int):
    """(data, mask or None): one build column scattered into key-slot
    order over ``range_size + 1`` entries, the last one (where NULL and
    out-of-range keys land) cut off.  The caller guarantees unique build
    keys, so every kept slot is written once; an unoccupied slot holds
    zero (and a False mask)."""
    dev = col.data.device
    shape = (range_size + 1,) + tuple(col.data.shape[1:])
    vt = torch.zeros(shape, dtype=col.data.dtype, device=dev)
    vt[slots] = col.data
    vm = None
    if col.mask is not None:
        vm = torch.zeros(shape, dtype=torch.bool, device=dev)
        vm[slots] = col.mask
        vm = vm[:range_size]
    return vt[:range_size], vm


def _words(vt: torch.Tensor):
    """A 1-D value table as int64 words (each at most 32 bits wide) and
    the inverse that rebuilds the column from them."""
    dt = vt.dtype
    if dt == torch.float32:
        return ([vt.view(torch.int32).to(torch.int64)],
                lambda w: w[0].to(torch.int32).view(torch.float32))
    if dt == torch.bool:
        return [vt.to(torch.int64)], lambda w: w[0] != 0
    if dt == torch.int64:
        # two 32-bit words: lo in [0, 2^32), hi in [-2^31, 2^31)
        return ([vt & 0xFFFFFFFF, vt >> 32],
                lambda w: (w[1] << 32) | w[0])
    if dt in (torch.int8, torch.int16, torch.int32, torch.uint8):
        return [vt.to(torch.int64)], lambda w: w[0].to(dt)
    raise ValueError(f"spread_inner_fk: no exact delta encoding of {dt}")


def spread_inner_fk(probe_slot: torch.Tensor, vts, range_size: int):
    """The delta-spread FK-join output (the JAX package's gather-free
    route, here a candidate the route A/B measures).

    For a complete perfect table (unique build keys in every slot) and
    probe rows that all match: the key ``slot << 1 | side`` (build 0,
    probe 1; it fits int32, as ``range_size`` is at most 2^24) puts each
    build row at the head of its slot's run.  Each column word's deltas
    in slot order ride one sort of build and probe keys (``torch.sort``
    carries no payloads: each payload is gathered through the sort's
    permutation), the probe rows carrying 0, and a prefix sum rebuilds
    at every row the word of its slot.  Deltas and sums are int64, so
    every prefix sum is exactly a word and nothing wraps.

    ``vts``: [(data, mask or None), ...], 1-D value tables in slot order.
    Returns (is_probe, [(data, mask or None), ...]) over ``range_size +
    n_probe`` rows in slot order; the build rows are dead rows under
    ``is_probe``."""
    dev = probe_slot.device
    npr = probe_slot.shape[0]
    key = torch.cat([
        torch.arange(range_size, dtype=torch.int32, device=dev) << 1,
        (probe_slot.to(torch.int32) << 1) | 1])
    skey, perm = torch.sort(key)
    zeros = torch.zeros((npr,), dtype=torch.int64, device=dev)

    def spread(word: torch.Tensor) -> torch.Tensor:
        delta = torch.cat([word[:1], word[1:] - word[:-1], zeros])
        # int64 in, int64 out: torch.cumsum keeps an int64 input's dtype
        return torch.cumsum(delta[perm], 0)

    cols = []
    for data, mask in vts:
        words, rebuild = _words(data)
        out = rebuild([spread(w) for w in words])
        om = None
        if mask is not None:
            om = spread(mask.to(torch.int64)) != 0
        cols.append((out, om))
    return (skey & 1) == 1, cols
