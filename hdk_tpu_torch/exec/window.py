"""Window functions (counterpart of hdk_tpu/exec/window.py).

One stable lexicographic sort of all rows by (liveness, partition keys,
order keys) (``sortops.sort_with_payload``, whose permutation is the row
index carried through the sort); then every window kind is arithmetic on
the sorted rows' partition and tie spans, and the result goes back to
the rows' own positions with one scatter.  Semantics are the JAX
package's:

  * rank family and NTILE: standard SQL (frames never apply);
  * navigation (LAG/LEAD/FIRST/LAST/NTH_VALUE): the whole partition, or
    the explicit frame;
  * aggregates: the whole partition without ORDER BY; with it,
    cumulative to the end of the row's tie group (ties share a value);
    explicit ROWS and RANGE frames with numeric offsets.  NULL order and
    partition keys sort last in either direction.

The mechanisms differ where the JAX package's do not fit Hopper or lose
exactness:

  * partition and tie spans: ``sortops.span_bounds`` (binary searches
    of a running count of the span starts);
  * whole-partition COUNT/SUM/AVG/MIN/MAX: a group-by over the sorted
    partition id (``groupby._seg_sum_many``: the histogram kernels K1,
    K3 and K4 on a CUDA device; ``onehot.seg_min``/``seg_max``), read
    back by partition id.  Integer sums are exact, and a NaN or an
    infinity stays in its own partition (the reference's one float64
    prefix over all sorted rows carries it into every later partition);
  * cumulative aggregates: COUNT and integer SUM are int64 prefix
    differences from the partition's own start; float SUM and MIN/MAX
    are a log-step (Hillis-Steele) scan that restarts at each partition;
  * frame COUNT and integer SUM: int64 prefix differences; frame float
    SUM/AVG: the sum of the frame's shifted slices for a bounded ROWS
    frame up to ``_SLICE_FRAME_MAX`` rows wide, else prefixes of the
    finite values that restart at each partition, with NaN, +inf and
    -inf counted in integer prefixes of their own, so a frame holding
    one gets the IEEE result;
  * frame MIN/MAX: a sparse table built only up to the longest frame's
    level, two levels alive at once (the reference stacks all
    floor(log2 N) + 1 levels);
  * RANGE offsets: a vectorized bisection inside each partition.

Host syncs: none for the rank family, navigation, COUNT and integer
sums; one (the partition count) for a whole-partition aggregate; one
(the longest partition) for a cumulative float SUM/AVG or MIN/MAX and
for a frame float SUM/AVG wider than ``_SLICE_FRAME_MAX``; one (the
longest frame) for a frame MIN/MAX.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..ir.expr import WindowKind
from ..ops import onehot
from ..ops import sortops as so
from .groupby import _minmax_identity, _orderable_int64, _seg_sum_many
from .masked import MaskedCol

# a bounded ROWS frame up to this many rows wide sums its shifted slices
_SLICE_FRAME_MAX = 64


def _orderable(data: torch.Tensor) -> torch.Tensor:
    """An integer key ordered as ``data`` (the JAX package's
    ``_orderable_int64`` order), at the value's own width: the radix
    sort's passes follow the key's bytes."""
    if data.dtype == torch.float32:
        b = data.view(torch.int32)
        o = b ^ ((b >> 31) & 0x7FFFFFFF)
        return torch.where(data == 0, 0, o)
    if data.is_floating_point():
        return _orderable_int64(data)
    if data.dtype == torch.bool:
        return data.to(torch.uint8)
    return data


def _sort_keys(col: MaskedCol, desc: bool) -> List[torch.Tensor]:
    """Ascending keys of one column: an optional null flag (NULLs last,
    in either direction) and the orderable value (bits flipped for
    DESC)."""
    kv = _orderable(col.data)
    if desc:
        kv = ~kv
    if col.mask is None:
        return [kv]
    return [(~col.mask).to(torch.uint8), torch.where(col.mask, kv, 0)]


def _bitlen(w: torch.Tensor) -> torch.Tensor:
    """floor(log2(w)) + 1 for positive int64 (0 -> 0)."""
    pos = torch.zeros_like(w)
    cur = w
    for s in (32, 16, 8, 4, 2, 1):
        hi = cur >> s
        take = hi > 0
        pos = pos + torch.where(take, s, 0)
        cur = torch.where(take, hi, cur)
    return torch.where(w > 0, pos + 1, 0)


def _span_bisect(sorted_vals: torch.Tensor, targets: torch.Tensor,
                 lo0: torch.Tensor, hi0: torch.Tensor,
                 left: bool) -> torch.Tensor:
    """Per-row binary search restricted to [lo0, hi0): the first index
    where sorted_vals >= target (left) or > target (right)."""
    n = sorted_vals.shape[0]
    steps = max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)
    lo, hi = lo0, hi0
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        mv = sorted_vals[torch.clamp(mid, 0, n - 1)]
        go_right = (mv < targets) if left else (mv <= targets)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _shift(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """y[i] = x[i + d] where i + d lies in [0, n), else ``fill``."""
    n = x.shape[0]
    out = torch.full_like(x, fill)
    if d >= 0 and d < n:
        out[:n - d] = x[d:]
    elif d < 0 and -d < n:
        out[-d:] = x[:n + d]
    return out


def _seg_scan(vals: torch.Tensor, pos0: torch.Tensor, combine, ident,
              longest: int) -> torch.Tensor:
    """Segmented inclusive scan: row i combines the values of its
    partition from the partition's start (``pos0`` rows before it) to
    itself; ``ident`` is the combine's identity.  Log-step
    (Hillis-Steele): after the step of distance d each row holds up to
    2d values, so ceil(log2(longest)) steps cover the longest
    partition."""
    out = vals.clone()
    d = 1
    while d < longest:
        # the row d back where it lies in the partition; the step reads
        # it whole before it writes
        back = torch.where(pos0[d:] >= d, out[:-d], ident)
        combine(out[d:], back, out=out[d:])
        d *= 2
    return out


def _prefix_diff(vals: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Sum of vals[lo..hi] (inclusive) per row from one int64 prefix
    (exact; wraps as int64 addition does)."""
    pad = torch.zeros((vals.shape[0] + 1,), dtype=torch.int64,
                      device=vals.device)
    torch.cumsum(vals.to(torch.int64), 0, out=pad[1:])
    return pad[hi + 1] - pad[lo]


def _range_min_max(filled: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   nonempty: torch.Tensor, is_min: bool) -> torch.Tensor:
    """MIN/MAX over [lo, hi] per row from a sparse table whose level k
    holds the extreme over [i, i + 2^k).  Levels go only up to the
    longest frame's (one host sync); each row reads its own level
    twice."""
    combine = torch.minimum if is_min else torch.maximum
    dt = filled.dtype
    if dt.is_floating_point:  # the identity as a number: no device read
        ident = math.inf if is_min else -math.inf
    else:
        ident = torch.iinfo(dt).max if is_min else torch.iinfo(dt).min
    n = filled.shape[0]
    length = torch.where(nonempty, hi - lo + 1, 1)
    level = _bitlen(length) - 1
    top = int(level.max())  # host sync: the longest frame's level
    loc = torch.clamp(lo, 0, n - 1)
    out = torch.full_like(filled, ident)
    table = filled
    for k in range(top + 1):
        if k:
            span = 1 << (k - 1)
            table = combine(table, _shift(table, span, ident))
        at = torch.clamp(hi - (1 << k) + 1, 0, n - 1)
        out = torch.where(level == k, combine(table[loc], table[at]), out)
    return out


def compute_window(kind: WindowKind, args: Sequence[MaskedCol],
                   part_cols: Sequence[MaskedCol],
                   order_cols: Sequence[MaskedCol],
                   order_desc: Sequence[bool], arg1, nrows: int,
                   row_mask: Optional[torch.Tensor],
                   out_dtype: torch.dtype, frame=None) -> MaskedCol:
    """One window function over ``nrows`` rows; rows where ``row_mask``
    is False sort past the live ones and form partitions of their own."""
    device = (row_mask.device if row_mask is not None else
              next(c.data.device for c in (*args, *part_cols, *order_cols)))
    if nrows == 0:
        return MaskedCol(torch.zeros((0,), dtype=out_dtype, device=device))

    # -- the one sort: (liveness, partition keys, order keys) ------------
    live_keys = [(~row_mask).to(torch.uint8)] if row_mask is not None else []
    part_keys = [k for c in part_cols for k in _sort_keys(c, False)]
    order_keys = [k for c, d in zip(order_cols, order_desc)
                  for k in _sort_keys(c, d)]
    keys = live_keys + part_keys + order_keys
    pos = torch.arange(nrows, dtype=torch.int64, device=device)
    if keys:
        skeys, _, perm = so.sort_with_payload(keys, [])
    else:
        skeys, perm = [], pos
    n_part = len(live_keys) + len(part_keys)

    pb = torch.zeros((nrows,), dtype=torch.bool, device=device)
    pb[0] = True
    for sk in skeys[:n_part]:
        pb = pb | so.changed(sk)
    start, pend = so.span_bounds(pb)  # the row's partition, sorted rows
    cnt = pend - start + 1
    pos0 = pos - start
    memo = {}

    def ties():
        """(tie-group boundary, first row, last row) of each sorted row's
        tie group under the order keys, made on first use."""
        if not memo:
            ob = pb
            for sk in skeys[n_part:]:
                ob = ob | so.changed(sk)
            memo["ties"] = (ob, *so.span_bounds(ob))
        return memo["ties"]

    def scatter_back(vals: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> MaskedCol:
        out = torch.empty((nrows,), dtype=out_dtype, device=device)
        out[perm] = vals.to(out_dtype)
        if mask is None:
            return MaskedCol(out)
        om = torch.empty((nrows,), dtype=torch.bool, device=device)
        om[perm] = mask
        return MaskedCol(out, om)

    if kind == WindowKind.ROW_NUMBER:
        return scatter_back(pos0 + 1)
    if kind == WindowKind.RANK:
        return scatter_back(ties()[1] - start + 1)
    if kind == WindowKind.DENSE_RANK:
        obc = torch.cumsum(ties()[0], 0, dtype=torch.int64)
        return scatter_back(obc - obc[start] + 1)
    if kind == WindowKind.PERCENT_RANK:
        rank = (ties()[1] - start).to(torch.float64)
        denom = torch.clamp(cnt - 1, min=1).to(torch.float64)
        return scatter_back(torch.where(cnt <= 1, 0.0, rank / denom))
    if kind == WindowKind.CUME_DIST:
        return scatter_back((ties()[2] - start + 1).to(torch.float64)
                            / cnt.to(torch.float64))
    if kind == WindowKind.NTILE:
        tiles = int(arg1)
        return scatter_back(torch.div(pos0 * tiles, torch.clamp(cnt, min=1),
                                      rounding_mode="floor") + 1)

    def frame_bounds() -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row frame [lo, hi] in sorted positions (inclusive; hi < lo
        is an empty frame)."""
        if frame.unit == "rows":
            def side(bound):
                bk, v = bound
                if bk == "unbounded_preceding":
                    return start
                if bk == "unbounded_following":
                    return pend
                if bk == "current_row":
                    return pos
                return pos - int(v) if bk == "preceding" else pos + int(v)

            return (torch.maximum(side(frame.start), start),
                    torch.minimum(side(frame.end), pend))
        # RANGE: offsets on the single ORDER BY key, in v' = +-v so the
        # sorted direction is ascending and "preceding" is v' - offset
        if len(order_cols) != 1:
            raise NotImplementedError(
                "RANGE frame with offsets requires exactly one ORDER BY "
                "key (reference: WindowContext frame validation)")
        oc = order_cols[0]
        v = oc.data.to(torch.float64) * (-1.0 if order_desc[0] else 1.0)
        if oc.mask is not None:  # NULLs sort last: +inf in v'-space
            v = torch.where(oc.mask, v, math.inf)
        sv = v[perm]

        def side(bound, is_start):
            bk, off = bound
            if bk == "unbounded_preceding":
                return start
            if bk == "unbounded_following":
                return pend
            if bk == "current_row":
                return ties()[1] if is_start else ties()[2]
            tgt = sv - float(off) if bk == "preceding" else sv + float(off)
            if is_start:  # the first row of the partition with v' >= tgt
                return _span_bisect(sv, tgt, start, pend + 1, left=True)
            # the last row with v' <= tgt
            return _span_bisect(sv, tgt, start, pend + 1, left=False) - 1

        return side(frame.start, True), side(frame.end, False)

    # navigation and aggregates read the argument in sorted order
    arg = args[0] if args else None
    sa = arg.data[perm] if arg is not None else None
    sm = arg.mask[perm] if arg is not None and arg.mask is not None else None

    if kind in (WindowKind.LAG, WindowKind.LEAD):
        k = int(arg1) if arg1 is not None else 1
        src = pos - k if kind == WindowKind.LAG else pos + k
        in_part = (src >= start) & (src <= pend)
        srcc = torch.clamp(src, 0, nrows - 1)
        mask = in_part if sm is None else (in_part & sm[srcc])
        return scatter_back(sa[srcc], mask)

    if kind in (WindowKind.FIRST_VALUE, WindowKind.LAST_VALUE,
                WindowKind.NTH_VALUE):
        lo, hi = frame_bounds() if frame is not None else (start, pend)
        if kind == WindowKind.FIRST_VALUE:
            idx = lo
        elif kind == WindowKind.LAST_VALUE:
            idx = hi
        else:  # NTH_VALUE(x, n): the frame's n-th row, 1-based
            idx = lo + (int(arg1) - 1)
        in_frame = (idx >= lo) & (idx <= hi)
        idx = torch.clamp(idx, 0, nrows - 1)
        mask = in_frame if sm is None else (in_frame & sm[idx])
        return scatter_back(sa[idx], mask)

    if kind not in (WindowKind.COUNT, WindowKind.SUM, WindowKind.AVG,
                    WindowKind.MIN, WindowKind.MAX):
        raise NotImplementedError(f"window function {kind}")
    nonnull = (torch.ones((nrows,), dtype=torch.bool, device=device)
               if sm is None else sm)
    is_float = sa is not None and sa.is_floating_point()

    def sum_result(s: torch.Tensor, nn: torch.Tensor) -> MaskedCol:
        if kind == WindowKind.AVG:
            avg = s.to(torch.float64) / torch.clamp(nn, min=1)
            return scatter_back(avg, nn > 0)
        return scatter_back(s, nn > 0)

    # ---- aggregates over an explicit frame ------------------------------
    if frame is not None:
        lo, hi = frame_bounds()
        nonempty = hi >= lo
        loc = torch.clamp(lo, 0, nrows - 1)
        hic = torch.clamp(hi, 0, nrows - 1)

        def frame_count(flags: torch.Tensor) -> torch.Tensor:
            return torch.where(nonempty, _prefix_diff(flags, loc, hic), 0)

        if kind == WindowKind.COUNT:
            return scatter_back(frame_count(nonnull))
        fnn = frame_count(nonnull)
        if kind in (WindowKind.MIN, WindowKind.MAX):
            is_min = kind == WindowKind.MIN
            ident = _minmax_identity(sa.dtype, is_min, device)
            filled = sa if sm is None else torch.where(sm, sa, ident)
            return scatter_back(
                _range_min_max(filled, lo, hi, nonempty, is_min), fnn > 0)
        if not is_float:
            vals = sa.to(torch.int64)
            if sm is not None:
                vals = torch.where(sm, vals, 0)
            return sum_result(torch.where(nonempty, _prefix_diff(
                vals, loc, hic), 0), fnn)
        return sum_result(_frame_float_sum(frame, sa, sm, lo, hi, loc, hic,
                                           nonempty, pos0, cnt, start), fnn)

    # ---- aggregates over the default frames -----------------------------
    if order_cols:  # cumulative to the end of the tie group
        tie_end = ties()[2]
        if kind == WindowKind.COUNT:
            if arg is None:
                return scatter_back(tie_end - start + 1)
            return scatter_back(_prefix_diff(nonnull, start, tie_end))
        nn = _prefix_diff(nonnull, start, tie_end)
        if kind in (WindowKind.SUM, WindowKind.AVG) and not is_float:
            vals = sa.to(torch.int64)
            if sm is not None:
                vals = torch.where(sm, vals, 0)
            return sum_result(_prefix_diff(vals, start, tie_end), nn)
        longest = int(cnt.max())  # host sync: the scan's step count
        if kind in (WindowKind.SUM, WindowKind.AVG):
            vals = sa.to(torch.float64)
            if sm is not None:
                vals = torch.where(sm, vals, 0.0)
            run = _seg_scan(vals, pos0, torch.add, 0.0, longest)
            return sum_result(run[tie_end], nn)
        is_min = kind == WindowKind.MIN
        ident = _minmax_identity(sa.dtype, is_min, device)
        filled = sa if sm is None else torch.where(sm, sa, ident)
        run = _seg_scan(filled, pos0, torch.minimum if is_min
                        else torch.maximum, ident, longest)
        return scatter_back(run[tie_end], nn > 0)

    # whole partition: a group-by over the sorted partition id
    pgid = torch.cumsum(pb, 0, dtype=torch.int32) - 1
    n_parts = int(pgid[-1]) + 1  # host sync: the partition count
    gid = pgid.to(torch.int64)
    ones = torch.ones((nrows,), dtype=torch.bool, device=device)
    if kind == WindowKind.COUNT:
        col = ones if arg is None or sm is None else sm
        (c,) = _seg_sum_many([col], pgid, n_parts, ones_obj=ones)
        return scatter_back(c[gid])
    nn_col = ones if sm is None else sm
    if kind in (WindowKind.SUM, WindowKind.AVG):
        vals = sa if sm is None else torch.where(sm, sa, 0)
        s, nn = _seg_sum_many([vals, nn_col], pgid, n_parts, ones_obj=ones)
        return sum_result(s[gid], nn[gid])
    is_min = kind == WindowKind.MIN
    ident = _minmax_identity(sa.dtype, is_min, device)
    filled = sa if sm is None else torch.where(sm, sa, ident)
    red = onehot.seg_min if is_min else onehot.seg_max
    (nn,) = _seg_sum_many([nn_col], pgid, n_parts, ones_obj=ones)
    return scatter_back(red(filled, pgid, n_parts, ident)[gid], nn[gid] > 0)


def _frame_float_sum(frame, sa: torch.Tensor, sm: Optional[torch.Tensor],
                     lo, hi, loc, hic, nonempty, pos0, cnt,
                     start) -> torch.Tensor:
    """Float64 sums over per-row frames [lo, hi] of sorted values (NULLs
    add nothing).  A bounded ROWS frame up to ``_SLICE_FRAME_MAX`` rows
    wide adds its shifted slices; any other frame takes the difference
    of two prefixes of the finite values that restart at the partition,
    and a frame holding a NaN, or both infinities, gives NaN, one holding
    only +inf (-inf) gives +inf (-inf)."""
    n = sa.shape[0]
    vals = sa.to(torch.float64)
    if sm is not None:
        vals = torch.where(sm, vals, 0.0)
    offsets = _rows_offsets(frame)
    if offsets is not None and offsets[1] - offsets[0] < _SLICE_FRAME_MAX:
        pos = pos0 + start
        acc = torch.zeros((n,), dtype=torch.float64, device=vals.device)
        for d in range(offsets[0], offsets[1] + 1):
            inside = (pos + d >= lo) & (pos + d <= hi)
            acc = acc + torch.where(inside, _shift(vals, d, 0.0), 0.0)
        return acc
    finite = torch.isfinite(vals)
    run = _seg_scan(torch.where(finite, vals, 0.0), pos0, torch.add, 0.0,
                    int(cnt.max()))  # host sync: the scan's step count
    before = torch.where(loc > start, run[torch.clamp(loc - 1, min=0)], 0.0)
    s = run[hic] - before

    def holds(flags: torch.Tensor) -> torch.Tensor:
        return _prefix_diff(flags, loc, hic) > 0

    pinf, ninf = holds(vals == math.inf), holds(vals == -math.inf)
    s = torch.where(pinf, math.inf, torch.where(ninf, -math.inf, s))
    s = torch.where(holds(torch.isnan(vals)) | (pinf & ninf), math.nan, s)
    return torch.where(nonempty, s, 0.0)


def _rows_offsets(frame) -> Optional[Tuple[int, int]]:
    """(first, last) row offset of a ROWS frame bounded on both sides
    (PRECEDING is negative), or None."""
    if frame.unit != "rows":
        return None
    out = []
    for bk, v in (frame.start, frame.end):
        if bk == "current_row":
            out.append(0)
        elif bk == "preceding":
            out.append(-int(v))
        elif bk == "following":
            out.append(int(v))
        else:
            return None
    return out[0], out[1]
