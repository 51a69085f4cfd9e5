"""Group-by and aggregates (counterpart of hdk_tpu/exec/groupby.py).

Two routes give every group a dense id in [0, n) and hand the same
aggregate step (``_reduce_specs``) the rows with that id:

  * ``groupby_perfect``: a positional id per row,
    ``gid = sum((key - min) * stride)`` over integer keys with known
    ranges, with a trailing slot per nullable key; ``n`` is the layout's
    ``entry_count`` and the caller compacts.
  * ``groupby_sort``: a stable sort of the keys (one packed composite
    where the key ranges allow, ``try_pack_keys``), group ids from the
    sorted-key boundaries, ``n`` a buffer cap; groups come in key order.

``nogroup_agg`` is the one-group case.  All sum-shaped slots of a query
share one call of ``ops/onehot.seg_sums``, which runs the histogram
kernels above ``_FEW_SEGMENTS`` segments; on sorted ids each group adds
only its own rows, in int64 or float64.

The dense route and the one-group case hand ``reduce_slots`` no id array
but its source, a ``kernels.hist.DenseKeys`` over the keys, the layout and
the row mask.  Where every aggregate is a sum (COUNT, SUM, AVG,
STDDEV/VAR, none DISTINCT) the kernels derive each row's id from the keys
on a CUDA device, at any segment count; other aggregates, more than
``hist.MAX_KEYS`` keys or key types the kernels do not read build the
array once (``perfect_gid``).  The debug timer's counters ``gid_keys``
and ``gid_array`` count the two; the array's build is the span
``agg:gid_array``, the sort of (group, value) pairs behind DISTINCT,
quantiles and TOP_K the span ``agg:pair_sort``.

Aggregate cells: COUNT(*) counts rows; COUNT(col) counts non-null;
SUM/MIN/MAX/AVG skip nulls and give NULL for all-null groups; AVG is a
(sum, count) pair finalized at the end; STDDEV/VAR use (sum, sumsq, count)
and CORR five moments and a count.  DISTINCT SUM/AVG and COUNT(DISTINCT)
dedupe (group, value) pairs by a sort; QUANTILE sorts each group's values
(on a CUDA device, where every group fits ``pairsort.CAPACITY``, each
group's value keys in their own run, ``kernels/pairsort.py``; else the
permutation of the sorted pairs; the timer counts ``pair_segsort`` and
``pair_lexsort``); APPROX_COUNT_DISTINCT and APPROX_QUANTILE build sketches
(``ops/sketches.py``); TOP_K/BOTTOM_K sort (group, value) and give each
group an array of its first k values, short groups padded with absent
elements.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import types as t
from ..ir.expr import AggKind
from ..kernels import hist, pairsort
from ..kernels.pairsort import orderable_int64 as _orderable_int64
from ..ops import onehot, sketches
from ..ops import sortops as so
from ..utils import timer
from .masked import MaskedCol, combine_masks, torch_dtype


@dataclass
class AggSpec:
    """One aggregate target, operand already evaluated."""

    kind: AggKind
    operand: Optional[MaskedCol]  # None for COUNT(*)
    out_type: t.Type
    distinct: bool = False
    arg1: object = None  # quantile fraction
    interpolation: str = "linear"
    operand2: Optional[MaskedCol] = None  # CORR's second argument
    # sketch sizing; the effective values shrink with the group count to
    # fit the budgets (ops/sketches.effective_*)
    hll_p: int = 11
    hll_budget: int = 1 << 24
    td_c: int = 300
    td_budget: int = 1 << 21


@dataclass
class PerfectHashLayout:
    """Dense positional layout over integer key ranges."""

    mins: List[int]
    sizes: List[int]  # per-key slot count (+1 trailing null slot if nullable)

    @property
    def entry_count(self) -> int:
        return int(math.prod(self.sizes))


def choose_perfect_layout(
    key_types: Sequence[t.Type],
    key_ranges: Sequence[Tuple[Optional[float], Optional[float], bool]],
    limit: int,
) -> Optional[PerfectHashLayout]:
    """The dense layout when every key is an integer-like type with a
    known range and the product of the range sizes stays within
    ``limit``; None otherwise."""
    mins: List[int] = []
    sizes: List[int] = []
    total = 1
    for typ, (lo, hi, has_nulls) in zip(key_types, key_ranges):
        ok = (typ.is_integer() or typ.is_boolean()
              or typ.is_dict_encoded_string()
              or (typ.is_date() and typ.unit == t.TimeUnit.DAY))  # type: ignore[attr-defined]
        if not ok or lo is None or hi is None:
            if typ.is_boolean():
                lo, hi = 0, 1
            else:
                return None
        size = int(hi) - int(lo) + 1
        if has_nulls or typ.nullable:
            size += 1
        if size <= 0:
            return None
        mins.append(int(lo))
        sizes.append(size)
        total *= size
        if total > limit:
            return None
    return PerfectHashLayout(mins, sizes)


# up to this many segments the sums are masked full-column reductions,
# one pass per segment, as in the JAX package; above it, the kernels
_FEW_SEGMENTS = 4


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype.is_floating_point else torch.int64


def _minmax_identity(dtype: torch.dtype, is_min: bool, device):
    if dtype.is_floating_point:
        value = math.inf if is_min else -math.inf
    else:
        info = torch.iinfo(dtype)
        value = info.max if is_min else info.min
    return torch.tensor(value, dtype=dtype, device=device)


def _seg_sum(vals: torch.Tensor, gid: torch.Tensor, n: int,
             is_ones: bool = False) -> torch.Tensor:
    """Segment sum of a 1-D column into int64 (integers, bools) or
    float64; operands go at their native width."""
    if n <= _FEW_SEGMENTS:
        if vals.dtype == torch.bool:
            return torch.stack([((gid == g) & vals).sum() for g in range(n)])
        v = vals.to(_acc_dtype(vals.dtype))
        return torch.stack([torch.where(gid == g, v, 0).sum()
                            for g in range(n)])
    return onehot.seg_sums([vals], gid, n,
                           ones_ids=(0,) if is_ones else ())[0]


def _seg_extreme(vals, gid, n: int, is_min: bool):
    ident = _minmax_identity(vals.dtype, is_min, vals.device)
    if n <= _FEW_SEGMENTS:
        red = torch.amin if is_min else torch.amax
        return torch.stack([red(torch.where(gid == g, vals, ident))
                            for g in range(n)])
    fn = onehot.seg_min if is_min else onehot.seg_max
    return fn(vals, gid, n, ident)


@dataclass
class AggResult:
    """Raw aggregate buffers; AVG/STDDEV/VAR/CORR finalized in
    ``finalize``."""

    slots: List[torch.Tensor]

    def finalize(self, spec: AggSpec) -> MaskedCol:
        k = spec.kind
        out_dt = torch_dtype(spec.out_type.physical_dtype())
        if k == AggKind.COUNT:
            return MaskedCol(self.slots[0].to(out_dt))
        if k in (AggKind.SUM, AggKind.MIN, AggKind.MAX, AggKind.SAMPLE,
                 AggKind.SINGLE_VALUE):
            data, nonnull = self.slots
            return MaskedCol(data.to(out_dt), nonnull > 0)
        if k == AggKind.AVG:
            s, c = self.slots
            avg = s.to(torch.float64) / torch.where(c == 0, 1, c)
            return MaskedCol(avg.to(out_dt), c > 0)
        if k in (AggKind.STDDEV_SAMP, AggKind.VAR_SAMP):
            s, sq, c = self.slots
            cf = c.to(torch.float64)
            mean = s / torch.where(cf == 0, 1.0, cf)
            var = (sq - cf * mean * mean) / torch.where(cf <= 1, 1.0,
                                                        cf - 1.0)
            var = torch.clamp_min(var, 0.0)
            out = torch.sqrt(var) if k == AggKind.STDDEV_SAMP else var
            return MaskedCol(out.to(out_dt), c > 1)
        if k == AggKind.COUNT_DISTINCT:
            return MaskedCol(self.slots[0].to(out_dt))
        if k == AggKind.APPROX_COUNT_DISTINCT:
            return MaskedCol(sketches.hll_estimate(self.slots[0]).to(out_dt))
        if k == AggKind.QUANTILE:
            data, nonnull = self.slots
            return MaskedCol(data.to(out_dt), nonnull > 0)
        if k == AggKind.APPROX_QUANTILE:
            means, weights = self.slots
            est = sketches.tdigest_quantile(means, weights, float(spec.arg1))
            return MaskedCol(est.to(out_dt), weights.sum(dim=1) > 0)
        if k in (AggKind.TOP_K, AggKind.BOTTOM_K):
            vals, valid = self.slots  # (n, k) in the operand's dtype
            return MaskedCol(vals, valid)
        if k == AggKind.CORR:
            # Pearson r from the five moment slots
            sx, sy, sxy, sxx, syy, c = self.slots
            cf = c.to(torch.float64)
            n_ = torch.where(cf == 0, 1.0, cf)
            cov = sxy - sx * sy / n_
            vx = sxx - sx * sx / n_
            vy = syy - sy * sy / n_
            denom = torch.sqrt(torch.clamp_min(vx * vy, 0.0))
            r = cov / torch.where(denom == 0, 1.0, denom)
            return MaskedCol(r.to(out_dt), (c > 1) & (denom > 0))
        raise NotImplementedError(f"aggregate {k}")


def _sum_plan(spec: AggSpec, gid: torch.Tensor, num: int,
              ones: torch.Tensor):
    """(columns_to_segment_sum, resolve) for sum-shaped aggregates, or
    None for kinds with their own reduction (MIN/MAX, CORR, COUNT
    DISTINCT, sketches...).  The columns of every spec of a group-by are
    summed in one ``seg_sums`` call."""
    k = spec.kind
    v = spec.operand
    if spec.distinct and k in (AggKind.SUM, AggKind.AVG):
        first = _distinct_first_mask(v, gid, num)
        acc = torch.where(first, v.fill(0), 0)
        if k == AggKind.SUM:
            return [acc, first], lambda r: AggResult([r[0], r[1]])
        return [acc, first], lambda r: AggResult(
            [r[0].to(torch.float64), r[1]])
    if spec.distinct:
        return None
    if k == AggKind.COUNT:
        if v is None or v.mask is None:
            return [ones], lambda r: AggResult([r[0]])
        return [v.mask], lambda r: AggResult([r[0]])
    if k in (AggKind.SUM, AggKind.AVG, AggKind.STDDEV_SAMP,
             AggKind.VAR_SAMP):
        nonnull = ones if v.mask is None else v.mask
        acc = v.fill(0)
        if k == AggKind.SUM:
            return [acc, nonnull], lambda r: AggResult([r[0], r[1]])
        if k == AggKind.AVG:
            return [acc, nonnull], lambda r: AggResult(
                [r[0].to(torch.float64), r[1]])
        sq = (acc.to(_acc_dtype(acc.dtype)) ** 2).to(torch.float64)
        return [acc, sq, nonnull], lambda r: AggResult(
            [r[0].to(torch.float64), r[1], r[2]])
    return None


def _seg_sum_many(cols: Sequence[torch.Tensor], gid: hist.GidSource,
                  num: int, ones_obj: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """Segment sums of many columns in one ``seg_sums`` call; duplicate
    column objects (shared ones/masks) are summed once, and ``ones_obj``
    (the all-ones COUNT column) becomes a count of gid.  A dense-key
    source goes to the kernels on a CUDA device whatever ``num``; on the
    CPU it builds its array first."""
    uniq: Dict[int, int] = {}
    ucols: List[torch.Tensor] = []
    slots = []
    for c in cols:
        if id(c) not in uniq:
            uniq[id(c)] = len(ucols)
            ucols.append(c)
        slots.append(uniq[id(c)])
    if isinstance(gid, hist.DenseKeys) and gid.device.type != "cuda":
        gid = gid.gid()[0]
    if num <= _FEW_SEGMENTS and isinstance(gid, torch.Tensor):
        results = [_seg_sum(c, gid, num) for c in ucols]
    else:
        ones_ids = [i for i, c in enumerate(ucols) if c is ones_obj]
        results = onehot.seg_sums(ucols, gid, num, ones_ids=ones_ids)
    return [results[s] for s in slots]


def _agg_slots(spec: AggSpec, gid: torch.Tensor, n: int) -> AggResult:
    """Raw slot buffers of an aggregate ``_sum_plan`` declines (MIN/MAX,
    CORR, COUNT DISTINCT, quantiles, sketches) over assigned group ids;
    rows that do not take part must already map to a discard segment
    >= n."""
    k = spec.kind
    num = n + 1  # one discard segment at the end
    v = spec.operand
    if v is None:
        raise ValueError(f"{k} requires an operand")
    valid = v.mask
    if k == AggKind.CORR:
        return AggResult(_corr_slots(spec, lambda x: _seg_sum(x, gid,
                                                              num)[:n]))
    if k == AggKind.COUNT_DISTINCT:
        return AggResult([_count_distinct(v, gid, n, num)])
    if k == AggKind.APPROX_COUNT_DISTINCT:
        p = sketches.effective_hll_p(spec.hll_p, n, spec.hll_budget)
        return AggResult([sketches.hll_registers(v.data, valid, gid, n, p)])
    if k == AggKind.APPROX_QUANTILE:
        c = sketches.effective_td_c(spec.td_c, n, spec.td_budget)
        return AggResult(list(sketches.tdigest_build(v.data, valid, gid,
                                                     n, c)))
    if k in (AggKind.TOP_K, AggKind.BOTTOM_K):
        return AggResult(_group_topk(v, gid, n, num, int(spec.arg1),
                                     k == AggKind.TOP_K))
    nonnull = (torch.ones(gid.shape, dtype=torch.bool, device=gid.device)
               if valid is None else valid)
    nonnull_per_group = _seg_sum(nonnull, gid, num,
                                 is_ones=valid is None)[:n]
    if k == AggKind.QUANTILE:
        return AggResult([_quantile_slot(v, gid, n, num, float(spec.arg1),
                                         spec.interpolation,
                                         nonnull_per_group),
                          nonnull_per_group])
    if k in (AggKind.MIN, AggKind.MAX, AggKind.SAMPLE,
             AggKind.SINGLE_VALUE):
        is_min = k != AggKind.MAX
        ident = _minmax_identity(v.data.dtype, is_min, v.data.device)
        vals = v.data if valid is None else torch.where(valid, v.data, ident)
        m = _seg_extreme(vals, gid, num, is_min)[:n]
        return AggResult([torch.where(nonnull_per_group > 0, m, ident),
                          nonnull_per_group])
    raise NotImplementedError(f"aggregate {k}")


def _corr_slots(spec: AggSpec, reduce_fn):
    """CORR moment slots (sum x, sum y, sum xy, sum x2, sum y2, n) over
    rows where both operands are non-null."""
    x = spec.operand
    y = spec.operand2
    if y is None:
        raise ValueError("CORR requires two operands")
    both = combine_masks(x.mask, y.mask)
    xf = x.data.to(torch.float64)
    yf = y.data.to(torch.float64)
    if both is not None:
        xf = torch.where(both, xf, 0.0)
        yf = torch.where(both, yf, 0.0)
        cnt = both.to(torch.int64)
    else:
        cnt = torch.ones(xf.shape, dtype=torch.int64, device=xf.device)
    return [reduce_fn(xf), reduce_fn(yf), reduce_fn(xf * yf),
            reduce_fn(xf * xf), reduce_fn(yf * yf), reduce_fn(cnt)]


def _group_topk(v: MaskedCol, gid: torch.Tensor, n: int, num: int, kk: int,
                largest: bool) -> List[torch.Tensor]:
    """TOP_K/BOTTOM_K: rows sorted by (group, value), largest first for
    TOP_K, ties by row; each group's first ``kk`` non-null values.
    Returns the (n, kk) values and their validity (False past a group's
    non-null count).  Rows of gid >= n and NULL values drop out."""
    vkey = _orderable_int64(v.data)
    if largest:
        vkey = ~vkey
    perm, sg, _ = _sorted_pairs(v, gid, num, vkey)
    sv = v.data[perm]
    ones = torch.ones(gid.shape, dtype=torch.bool, device=gid.device)
    counts = _seg_sum(ones, sg, num, is_ones=True)
    starts = (torch.cumsum(counts, 0) - counts)[:n]
    slot = torch.arange(kk, dtype=torch.int64, device=gid.device)
    idx = torch.clamp(starts[:, None] + slot[None, :], 0,
                      max(sv.shape[0] - 1, 0))
    return [sv[idx], slot[None, :] < counts[:n, None]]


def _sorted_pairs(v: MaskedCol, gid: torch.Tensor, num: int, vkey):
    """Rows sorted by (group, value key), NULL values moved to the
    discard segment ``num - 1``: (permutation, sorted gids, sorted
    keys)."""
    with timer.DebugTimer("agg:pair_sort"):
        key_g = gid if v.mask is None else torch.where(v.mask, gid, num - 1)
        perm = so.lexsort([key_g, vkey])
        return perm, key_g[perm], vkey[perm]


def _distinct_first_mask(v: MaskedCol, gid: torch.Tensor,
                         num: int) -> torch.Tensor:
    """Per-row flag in row order: True for the first occurrence of each
    distinct non-null (group, value) pair."""
    perm, sg, sv = _sorted_pairs(v, gid, num, _orderable_int64(v.data))
    first = so.changed(sg) | so.changed(sv)
    if v.mask is not None:
        first = first & v.mask[perm]
    out = torch.zeros(gid.shape, dtype=torch.bool, device=gid.device)
    out[perm] = first
    return out


def _count_distinct(v: MaskedCol, gid: torch.Tensor, n: int,
                    num: int) -> torch.Tensor:
    """Exact COUNT(DISTINCT x) per group: sort (group, value) pairs and
    count the starts of their runs."""
    _perm, sg, sv = _sorted_pairs(v, gid, num, _orderable_int64(v.data))
    return _seg_sum(so.changed(sg) | so.changed(sv), sg, num)[:n]


def _quantile_slot(v: MaskedCol, gid: torch.Tensor, n: int, num: int,
                   q: float, interpolation: str,
                   counts: torch.Tensor) -> torch.Tensor:
    """Exact per-group quantile of the non-null values, by one of two
    routes that share no sort: where ``_segsort_largest`` admits the
    groups, each group's value keys sorted in place
    (``_group_quantile_segsort``); else the permutation of the sorted
    (group, value) pairs (``_group_quantile``).  ``counts`` are the
    groups' non-null rows.  The debug timer counts ``pair_segsort`` or
    ``pair_lexsort``."""
    largest = _segsort_largest(v.data.device, counts, pairsort.CAPACITY)
    if largest is None:
        timer.count("pair_lexsort")
        return _group_quantile(v, gid, n, num, q, interpolation)
    timer.count("pair_segsort")
    return _group_quantile_segsort(v, gid, n, q, interpolation, counts,
                                   largest)


def _segsort_largest(device: torch.device, counts: torch.Tensor,
                     capacity: int) -> Optional[int]:
    """The largest group's count where the key-carrying route takes the
    quantile: values on a CUDA device and every group within
    ``capacity`` keys (the kernel's ``pairsort.CAPACITY``).  None sends
    the CPU, a scalar quantile over more rows and skewed groups to the
    permutation.  One host sync reads the count."""
    if device.type != "cuda" or counts.numel() == 0:
        return None
    largest = int(counts.max())
    return largest if largest <= capacity else None


def _quantile_at(value_at, start: torch.Tensor, cnt: torch.Tensor, q: float,
                 interpolation: str) -> torch.Tensor:
    """Each group's quantile from its sorted run of ``cnt`` values from
    ``start``: the values at the floor and ceiling of ``q * (cnt - 1)``
    (``value_at`` reads positions), "lower", "higher" or "linear" between
    them."""
    pos = q * torch.clamp(cnt - 1, min=0).to(torch.float64)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    lo_v = value_at(start + lo)
    hi_v = value_at(start + hi)
    if interpolation == "lower":
        return lo_v
    if interpolation == "higher":
        return hi_v
    return lo_v + (hi_v - lo_v) * (pos - lo.to(torch.float64))


def _group_quantile(v: MaskedCol, gid: torch.Tensor, n: int, num: int,
                    q: float, interpolation: str) -> torch.Tensor:
    """Exact per-group quantile of the non-null values through the
    permutation: sort (group, value) and read the values at the
    quantile's position in each group's run."""
    fvals = v.data.to(torch.float64)
    perm, sg, _ = _sorted_pairs(v, gid, num, _orderable_int64(fvals))
    sv = fvals[perm]
    total = sv.shape[0]
    if total == 0:
        return torch.zeros((n,), dtype=torch.float64, device=gid.device)
    counts = _seg_sum(torch.ones(sg.shape, dtype=torch.bool,
                                 device=sg.device), sg, num, is_ones=True)
    start = (torch.cumsum(counts, 0) - counts)[:n]
    return _quantile_at(lambda i: sv[torch.clamp(i, 0, total - 1)], start,
                        counts[:n], q, interpolation)


def _group_quantile_segsort(v: MaskedCol, gid: torch.Tensor, n: int,
                            q: float, interpolation: str,
                            counts: torch.Tensor,
                            largest: int) -> torch.Tensor:
    """Exact per-group quantile of the non-null values without a
    permutation: ``pairsort.group_sorted_keys`` sorts each group's value
    keys in its own run, and the two keys a group reads turn back into
    values.  Equal to ``_group_quantile`` by ``==`` (NaN where NaN),
    but for a zero read from the runs, which is +0.0 where the
    permutation may give -0.0; SQL compares the two as equal.  A group
    without values reads 0."""
    fvals = v.data.to(torch.float64)
    rows = fvals.shape[0]
    if rows == 0:
        return torch.zeros((n,), dtype=torch.float64, device=gid.device)
    with timer.DebugTimer("agg:pair_sort"):
        keys, start = pairsort.group_sorted_keys(fvals, gid, v.mask, counts,
                                                 largest)
    out = _quantile_at(
        lambda i: pairsort.values_of(keys[torch.clamp(i, 0, rows - 1)]),
        start, counts, q, interpolation)
    return torch.where(counts > 0, out, 0.0)


def scalar_keys(nrows: int, row_mask: Optional[torch.Tensor],
                device: torch.device) -> hist.DenseKeys:
    """The id source of a scalar aggregate: no keys, every live row in
    entry 0."""
    return hist.DenseKeys((), (), (), (), row_mask, nrows, device)


def nogroup_agg(specs: Sequence[AggSpec], nrows: int,
                row_mask: Optional[torch.Tensor],
                device: torch.device) -> List[MaskedCol]:
    """Scalar aggregation: one group; filtered rows drop out."""
    agg_cols, _exists = _reduce_specs(specs,
                                      scalar_keys(nrows, row_mask, device), 1)
    return [MaskedCol(c.data[0], c.mask[0] if c.mask is not None else None)
            for c in agg_cols]


def dense_keys(keys: Sequence[MaskedCol], layout: PerfectHashLayout,
               row_mask: Optional[torch.Tensor]) -> hist.DenseKeys:
    """The dense layout's id source over the key columns: the kernels
    derive a row's id from it, ``perfect_gid`` builds the array."""
    return hist.DenseKeys(tuple(k.data for k in keys),
                          tuple(k.mask for k in keys), tuple(layout.mins),
                          tuple(layout.sizes), row_mask,
                          keys[0].data.shape[0], keys[0].data.device)


def perfect_gid(keys: Sequence[MaskedCol], layout: PerfectHashLayout,
                row_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense positional group id per row (int32); out-of-range and dead
    rows map to the discard segment ``entry_count``."""
    return dense_keys(keys, layout, row_mask).gid()


def groupby_perfect(keys: Sequence[MaskedCol], layout: PerfectHashLayout,
                    specs: Sequence[AggSpec],
                    row_mask: Optional[torch.Tensor]
                    ) -> Tuple[List[MaskedCol], List[MaskedCol], torch.Tensor]:
    """Dense positional group-by.

    Returns (key_columns, agg_columns, exists), all with
    ``layout.entry_count`` entries; ``exists`` marks observed groups and
    the caller compacts."""
    agg_cols, exists = _reduce_specs(specs, dense_keys(keys, layout, row_mask),
                                     layout.entry_count)
    return _perfect_key_columns(keys, layout), agg_cols, exists


def _reduce_specs(specs: Sequence[AggSpec], gid: hist.GidSource, n: int
                  ) -> Tuple[List[MaskedCol], torch.Tensor]:
    """(finalized aggregate columns, exists) over rows with dense group
    ids in [0, n); rows with gid n drop out."""
    results, counts = reduce_slots(specs, gid, n)
    return ([r.finalize(s) for r, s in zip(results, specs)], counts > 0)


# aggregates whose every slot is a sum: the kernels take a key source
_SUM_KINDS = frozenset({AggKind.COUNT, AggKind.SUM, AggKind.AVG,
                        AggKind.STDDEV_SAMP, AggKind.VAR_SAMP})


def _takes_keys(specs: Sequence[AggSpec], src: hist.DenseKeys) -> bool:
    return src.kernel_ready() and all(
        s.kind in _SUM_KINDS and not s.distinct for s in specs)


def reduce_slots(specs: Sequence[AggSpec], gid: hist.GidSource, n: int
                 ) -> Tuple[List[AggResult], torch.Tensor]:
    """(each aggregate's raw slots, rows a group) over rows with dense
    group ids in [0, n); rows with gid n drop out.  ``gid`` is an array
    or a dense-key source (``n`` its entry count), which the sums take
    as it is where every aggregate is sum-shaped and which otherwise
    builds its array here.  One seg_sums call takes the row counts and
    every sum-shaped slot.  A group without non-NULL values holds the
    identity in its MIN/MAX slot, so partial slots of disjoint rows merge
    by sum, min and max."""
    num = n + 1  # an array's discard segment; a key source drops rows
    if isinstance(gid, hist.DenseKeys):
        keyed = _takes_keys(specs, gid)
        timer.count("gid_keys" if keyed else "gid_array")
        if keyed:
            num = n
        else:
            with timer.DebugTimer("agg:gid_array"):
                gid = gid.gid()[0]
    n_rows = gid.n_rows if isinstance(gid, hist.DenseKeys) else gid.shape[0]
    # the all-ones COUNT column, a broadcast view: the kernels count the
    # ids and never read it
    ones = torch.ones((1,), dtype=torch.bool,
                      device=gid.device).expand(n_rows)
    batch_cols: List[torch.Tensor] = [ones]
    plans = []
    for spec in specs:
        plan = _sum_plan(spec, gid, n + 1, ones)
        if plan is not None:
            cols_i, resolve = plan
            idxs = list(range(len(batch_cols), len(batch_cols) + len(cols_i)))
            batch_cols.extend(cols_i)
            plans.append((idxs, resolve))
        else:
            plans.append(None)
    sums = _seg_sum_many(batch_cols, gid, num, ones_obj=ones)
    results = []
    for spec, plan in zip(specs, plans):
        if plan is None:
            results.append(_agg_slots(spec, gid, n))
        else:
            idxs, resolve = plan
            results.append(resolve([sums[i][:n] for i in idxs]))
    return results, sums[0][:n]


def _perfect_key_columns(keys: Sequence[MaskedCol],
                         layout: PerfectHashLayout) -> List[MaskedCol]:
    """Key values reconstructed from the dense entry index."""
    n = layout.entry_count
    entry = torch.arange(n, dtype=torch.int64, device=keys[0].data.device)
    strides = []
    acc = 1
    for size in reversed(layout.sizes):
        strides.append(acc)
        acc *= size
    strides.reverse()
    key_cols: List[MaskedCol] = []
    for key, mn, size, st in zip(keys, layout.mins, layout.sizes, strides):
        idx = torch.div(entry, st, rounding_mode="floor") % size
        data = (idx + mn).to(key.data.dtype)
        key_cols.append(MaskedCol(
            data, idx != (size - 1) if key.mask is not None else None))
    return key_cols


def perfect_key_columns_from_types(key_types: Sequence[t.Type],
                                   layout: PerfectHashLayout,
                                   device: torch.device) -> List[MaskedCol]:
    """Key values of the dense entries from the layout and the key types
    alone (the fragment stream merges partial slots and never holds the
    whole key columns); a nullable key's last slot is its NULL."""
    n = layout.entry_count
    entry = torch.arange(n, dtype=torch.int64, device=device)
    strides = []
    acc = 1
    for size in reversed(layout.sizes):
        strides.append(acc)
        acc *= size
    strides.reverse()
    out: List[MaskedCol] = []
    for typ, mn, size, st in zip(key_types, layout.mins, layout.sizes,
                                 strides):
        idx = torch.div(entry, st, rounding_mode="floor") % size
        data = (idx + mn).to(torch_dtype(typ.physical_dtype()))
        out.append(MaskedCol(data, idx != (size - 1) if typ.nullable
                             else None))
    return out


def try_pack_keys(keys: Sequence[MaskedCol],
                  key_ranges: Optional[Sequence[Tuple[int, int, bool]]]
                  ) -> Optional[Tuple[torch.Tensor, List[Tuple[int, int, int]]]]:
    """One int64 composite of several keys when their ranges fit in 62
    bits: each key takes ``hi - lo + 2`` slots (the last for NULL, so
    NULLs sort last), first key outermost.  Returns (composite, layout)
    with layout[i] = (lo, size, stride) per key, which ``unpack_keys``
    inverts; None without ranges or when they do not fit."""
    if key_ranges is None or len(key_ranges) != len(keys):
        return None
    total = 1
    sizes = []
    for lo, hi, _nul in key_ranges:
        size = int(hi) - int(lo) + 2
        if size <= 0:
            return None
        sizes.append(size)
        total *= size
        if total >= (1 << 62):
            return None
    composite = torch.zeros(keys[0].data.shape, dtype=torch.int64,
                            device=keys[0].data.device)
    strides = []
    stride = 1
    for key, (lo, _hi, _n), size in zip(reversed(list(keys)),
                                        reversed(list(key_ranges)),
                                        reversed(sizes)):
        idx = key.data.to(torch.int64) - int(lo)
        if key.mask is not None:
            idx = torch.where(key.mask, idx, size - 1)
        composite = composite + idx * stride
        strides.append(stride)
        stride *= size
    strides.reverse()
    layout = [(int(lo), size, st)
              for (lo, _hi, _n), size, st in zip(key_ranges, sizes, strides)]
    return composite, layout


def unpack_keys(comp: torch.Tensor, keys: Sequence[MaskedCol],
                layout: List[Tuple[int, int, int]]) -> List[MaskedCol]:
    """Key columns from packed composite values (``try_pack_keys``)."""
    comp = comp.to(torch.int64)
    total = max(st * size for _lo, size, st in layout)
    out: List[MaskedCol] = []
    for key, (lo, size, st) in zip(keys, layout):
        idx = torch.div(comp, st, rounding_mode="floor") if st != 1 else comp
        if st * size != total:  # the outermost key needs no modulo
            idx = idx % size
        out.append(MaskedCol((idx + lo).to(key.data.dtype),
                             (idx != size - 1) if key.mask is not None
                             else None))
    return out


def groupby_sort(keys: Sequence[MaskedCol], specs: Sequence[AggSpec],
                 entry_cap: int, row_valid: Optional[torch.Tensor] = None,
                 key_ranges: Optional[Sequence[Tuple[int, int, bool]]] = None
                 ) -> Tuple[List[MaskedCol], List[MaskedCol], torch.Tensor,
                            torch.Tensor]:
    """Sort-based group-by for keys without a dense layout.

    The rows sort stably on one packed composite where ``key_ranges``
    allow (int32 when its range fits, the half of the radix-sort bytes),
    else lexicographically on the orderable keys with a null flag before
    each nullable key.  Rows where ``row_valid`` is False sort past the
    live ones.  Group ids come from the sorted-key boundaries and are
    clamped at ``entry_cap - 1`` (the caller widens and retries when
    ``n_groups`` exceeds the cap); dead rows take the discard id
    ``entry_cap``.  The aggregates are ``_reduce_specs`` over the sorted
    ids and the operands gathered into sorted order, so each group sums
    its own rows.  Key values come from the sorted composite at each
    group's first row (packed keys), or from the source row there.

    Returns (key_cols, agg_cols, exists, n_groups) with buffers of
    ``entry_cap`` entries: the first ``n_groups`` (a 0-d tensor) are the
    groups in composite or lexicographic key order, NULL keys last."""
    nrows = keys[0].data.shape[0]
    packed = try_pack_keys(keys, key_ranges)
    if packed is not None:
        composite, pack_layout = packed
        if max(st * size for _lo, size, st in pack_layout) < (1 << 31) - 1:
            sort_key = composite.to(torch.int32)
            sentinel = torch.iinfo(torch.int32).max
        else:
            sort_key = composite
            sentinel = torch.iinfo(torch.int64).max
        if row_valid is not None:
            sort_key = torch.where(row_valid, sort_key, sentinel)
        skeys = [sort_key]
    else:
        skeys = []
        if row_valid is not None:  # live rows first
            skeys.append((~row_valid).to(torch.uint8))
        for key in keys:
            kv = _orderable_int64(key.data)
            if key.mask is not None:  # NULLs last, as one group
                skeys.append((~key.mask).to(torch.uint8))
                kv = torch.where(key.mask, kv, 0)
            skeys.append(kv)
    pay = so.PayloadSet()
    spec_slots = [[None if col is None
                   else (pay.add(col.data), pay.add(col.mask))
                   for col in (spec.operand, spec.operand2)]
                  for spec in specs]
    sorted_keys, sorted_pay, perm = so.sort_with_payload(skeys, pay.arrays)

    boundary = so.changed(sorted_keys[0])
    for sk in sorted_keys[1:]:
        boundary = boundary | so.changed(sk)
    if row_valid is None:
        valid_sorted = None
    elif packed is not None:
        valid_sorted = sorted_keys[0] != sentinel
    else:
        valid_sorted = sorted_keys[0] == 0
    gid_u = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    total_b = gid_u[-1] + 1
    n_groups = (total_b if valid_sorted is None
                else torch.where(valid_sorted, gid_u + 1, 0).max())
    gid_sorted = torch.clamp(gid_u, max=entry_cap - 1)  # overflow guard
    if valid_sorted is not None:
        gid_sorted = torch.where(valid_sorted, gid_sorted, entry_cap)

    def slot_col(slots) -> Optional[MaskedCol]:
        if slots is None:
            return None
        di, mi = slots
        return MaskedCol(sorted_pay[di],
                         sorted_pay[mi] if mi is not None else None)

    sspecs = [dataclasses.replace(spec, operand=slot_col(s[0]),
                                  operand2=slot_col(s[1]))
              for spec, s in zip(specs, spec_slots)]
    agg_cols, exists = _reduce_specs(sspecs, gid_sorted, entry_cap)

    # each group's first sorted row: the first row whose id reaches it
    # (nrows for the ids past the last group)
    starts = torch.searchsorted(gid_u, torch.arange(
        entry_cap, dtype=gid_u.dtype, device=gid_u.device))
    first_row = torch.clamp(starts, max=nrows - 1)
    if packed is not None:
        key_cols = unpack_keys(sorted_keys[0][first_row], keys, pack_layout)
    else:
        rep = perm[first_row]
        key_cols = [MaskedCol(key.data[rep],
                              key.mask[rep] if key.mask is not None else None)
                    for key in keys]
    return key_cols, agg_cols, exists, n_groups
