"""Dense (perfect-hash) group-by and scalar aggregates (counterpart of
the perfect-layout half of hdk_tpu/exec/groupby.py).

``groupby_perfect`` computes a positional group id per row,
``gid = sum((key - min) * stride)`` over the keys, with a trailing slot per
nullable key, and reduces every aggregate slot into a dense buffer of
``entry_count`` groups; ``nogroup_agg`` is the one-group case.  All
sum-shaped slots of a query share one call of ``ops/onehot.seg_sums``,
which runs the histogram kernels above ``_FEW_SEGMENTS`` segments.

Aggregate cells: COUNT(*) counts rows; COUNT(col) counts non-null;
SUM/MIN/MAX/AVG skip nulls and give NULL for all-null groups; AVG is a
(sum, count) pair finalized at the end; STDDEV/VAR use (sum, sumsq, count)
and CORR five moments and a count.  Sort-based group-by (no perfect
layout), DISTINCT aggregates, quantiles, sketches and TOP_K are not ported
yet (ROADMAP A1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import types as t
from ..ir.expr import AggKind
from ..ops import onehot
from .masked import MaskedCol, combine_masks, torch_dtype


@dataclass
class AggSpec:
    """One aggregate target, operand already evaluated."""

    kind: AggKind
    operand: Optional[MaskedCol]  # None for COUNT(*)
    out_type: t.Type
    distinct: bool = False
    operand2: Optional[MaskedCol] = None  # CORR's second argument


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
    if vals.dim() != 1:
        raise NotImplementedError(
            "multi-column aggregate slots come with sketches and TOP_K "
            "(ROADMAP A1)")
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


def _unsupported(spec: AggSpec) -> None:
    if spec.distinct or spec.kind not in _PORTED_KINDS:
        raise NotImplementedError(
            f"aggregate {spec.kind.name}{' DISTINCT' if spec.distinct else ''}"
            " is not ported yet (ROADMAP A1)")


_PORTED_KINDS = frozenset({
    AggKind.COUNT, AggKind.SUM, AggKind.AVG, AggKind.MIN, AggKind.MAX,
    AggKind.STDDEV_SAMP, AggKind.VAR_SAMP, AggKind.CORR, AggKind.SAMPLE,
    AggKind.SINGLE_VALUE,
})


def _sum_plan(spec: AggSpec, ones: torch.Tensor):
    """(columns_to_segment_sum, resolve) for sum-shaped aggregates, or
    None for kinds with their own reduction (MIN/MAX, CORR...).  The
    columns of every spec of a group-by are summed in one ``seg_sums``
    call."""
    k = spec.kind
    v = spec.operand
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


def _seg_sum_many(cols: Sequence[torch.Tensor], gid: torch.Tensor, num: int,
                  ones_obj: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """Segment sums of many columns in one ``seg_sums`` call; duplicate
    column objects (shared ones/masks) are summed once, and ``ones_obj``
    (the all-ones COUNT column) becomes a count of gid."""
    uniq: Dict[int, int] = {}
    ucols: List[torch.Tensor] = []
    slots = []
    for c in cols:
        if id(c) not in uniq:
            uniq[id(c)] = len(ucols)
            ucols.append(c)
        slots.append(uniq[id(c)])
    if num <= _FEW_SEGMENTS:
        results = [_seg_sum(c, gid, num) for c in ucols]
    else:
        ones_ids = [i for i, c in enumerate(ucols) if c is ones_obj]
        results = onehot.seg_sums(ucols, gid, num, ones_ids=ones_ids)
    return [results[s] for s in slots]


def _agg_slots(spec: AggSpec, gid: torch.Tensor, n: int) -> AggResult:
    """Raw slot buffers of one aggregate over assigned group ids; rows
    that do not take part must already map to a discard segment >= n."""
    _unsupported(spec)
    k = spec.kind
    num = n + 1  # one discard segment at the end

    def ones_like_rows():
        return torch.ones(gid.shape, dtype=torch.bool, device=gid.device)

    if k == AggKind.COUNT and spec.operand is None:
        return AggResult([_seg_sum(ones_like_rows(), gid, num,
                                   is_ones=True)[:n]])
    v = spec.operand
    if v is None:
        raise ValueError(f"{k} requires an operand")
    valid = v.mask
    nonnull = ones_like_rows() if valid is None else valid
    if k == AggKind.COUNT:
        return AggResult([_seg_sum(nonnull, gid, num,
                                   is_ones=valid is None)[:n]])
    nonnull_per_group = _seg_sum(nonnull, gid, num,
                                 is_ones=valid is None)[:n]
    if k in (AggKind.SUM, AggKind.AVG, AggKind.STDDEV_SAMP,
             AggKind.VAR_SAMP):
        acc = v.fill(0)  # native width; the sums widen
        s = _seg_sum(acc, gid, num)[:n]
        if k == AggKind.SUM:
            return AggResult([s, nonnull_per_group])
        if k == AggKind.AVG:
            return AggResult([s.to(torch.float64), nonnull_per_group])
        sq = _seg_sum((acc.to(_acc_dtype(acc.dtype)) ** 2).to(torch.float64),
                      gid, num)[:n]
        return AggResult([s.to(torch.float64), sq, nonnull_per_group])
    if k in (AggKind.MIN, AggKind.MAX, AggKind.SAMPLE,
             AggKind.SINGLE_VALUE):
        is_min = k != AggKind.MAX
        ident = _minmax_identity(v.data.dtype, is_min, v.data.device)
        vals = v.data if valid is None else torch.where(valid, v.data, ident)
        m = _seg_extreme(vals, gid, num, is_min)[:n]
        return AggResult([torch.where(nonnull_per_group > 0, m, ident),
                          nonnull_per_group])
    if k == AggKind.CORR:
        return AggResult(_corr_slots(spec, lambda x: _seg_sum(x, gid,
                                                              num)[:n]))
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


def _orderable_int64(data: torch.Tensor) -> torch.Tensor:
    """Map values to int64 preserving order (floats via the IEEE
    total-order trick: negative patterns flip all but the sign bit;
    +/-0.0 compare equal, NaN sorts above +inf)."""
    if data.dtype == torch.float32:
        b = data.view(torch.int32)
        o = b ^ ((b >> 31) & 0x7FFFFFFF)
        o = torch.where(data == 0, 0, o)
        return o.to(torch.int64)
    if data.is_floating_point():
        x = data.to(torch.float64)
        bits = x.view(torch.int64)
        o = bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)
        o = torch.where(x == 0, 0, o)
        return torch.where(torch.isnan(x), 0x7FF8000000000000, o)
    return data.to(torch.int64)


def nogroup_agg(specs: Sequence[AggSpec], nrows: int,
                row_mask: Optional[torch.Tensor],
                device: torch.device) -> List[MaskedCol]:
    """Scalar aggregation: one group; filtered rows go to the discard
    segment."""
    gid = (torch.zeros((nrows,), dtype=torch.int32, device=device)
           if row_mask is None
           else torch.where(row_mask, 0, 1).to(torch.int32))
    out = []
    for spec in specs:
        col = _agg_slots(spec, gid, 1).finalize(spec)
        out.append(MaskedCol(col.data[0],
                             col.mask[0] if col.mask is not None else None))
    return out


def perfect_gid(keys: Sequence[MaskedCol], layout: PerfectHashLayout,
                row_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense positional group id per row (int32); out-of-range and dead
    rows map to the discard segment ``entry_count``."""
    n = layout.entry_count
    gid = torch.zeros(keys[0].data.shape, dtype=torch.int64,
                      device=keys[0].data.device)
    stride = 1
    # row-major over keys, first key outermost
    for key, mn, size in zip(reversed(list(keys)), reversed(layout.mins),
                             reversed(layout.sizes)):
        idx = key.data.to(torch.int64) - mn
        if key.mask is not None:
            idx = torch.where(key.mask, idx, size - 1)
        gid = gid + idx * stride
        stride *= size
    in_range = (gid >= 0) & (gid < n)
    if row_mask is not None:
        in_range = in_range & row_mask
    return torch.where(in_range, gid, n).to(torch.int32), in_range


def groupby_perfect(keys: Sequence[MaskedCol], layout: PerfectHashLayout,
                    specs: Sequence[AggSpec],
                    row_mask: Optional[torch.Tensor]
                    ) -> Tuple[List[MaskedCol], List[MaskedCol], torch.Tensor]:
    """Dense positional group-by.

    Returns (key_columns, agg_columns, exists), all with
    ``layout.entry_count`` entries; ``exists`` marks observed groups and
    the caller compacts."""
    for spec in specs:
        _unsupported(spec)
    n = layout.entry_count
    gid, _ = perfect_gid(keys, layout, row_mask)
    # one seg_sums call for exists and every sum-shaped slot
    ones = torch.ones(gid.shape, dtype=torch.bool, device=gid.device)
    batch_cols: List[torch.Tensor] = [ones]
    plans = []
    for spec in specs:
        plan = _sum_plan(spec, ones)
        if plan is not None:
            cols_i, resolve = plan
            idxs = list(range(len(batch_cols), len(batch_cols) + len(cols_i)))
            batch_cols.extend(cols_i)
            plans.append((idxs, resolve))
        else:
            plans.append(None)
    sums = _seg_sum_many(batch_cols, gid, n + 1, ones_obj=ones)
    exists = sums[0][:n] > 0
    agg_cols = []
    for spec, plan in zip(specs, plans):
        if plan is None:
            res = _agg_slots(spec, gid, n)
        else:
            idxs, resolve = plan
            res = resolve([sums[i][:n] for i in idxs])
        agg_cols.append(res.finalize(spec))
    return _perfect_key_columns(keys, layout), agg_cols, exists


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
