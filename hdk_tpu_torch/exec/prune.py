"""Fragment skipping: prune row fragments whose per-column min/max
stats cannot satisfy the query's filters.

Reference semantics matched (not copied): Execute.h:540
``skipFragmentPair`` / ``skipFragment`` — per-fragment ChunkMetadata
(min/max/null-count, ArrowStorage.h:221 computeStats) is compared
against the filter's implied value range; disjoint fragments never
transfer or execute.

The executor (``Executor._maybe_prune_scan``) takes the surviving
fragments' rows as they are: the JAX package pads them to a bucketed
size so similar selections share a compiled XLA program, which eager
torch steps do not need.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd

_INF = math.inf


@dataclass
class ColBound:
    """Conjunctive constraints on one scan column (physical values)."""

    lo: float = -_INF
    hi: float = _INF
    lo_open: bool = False  # lo is a strict (>) bound
    hi_open: bool = False  # hi is a strict (<) bound
    must_have_null: bool = False  # an IS NULL conjunct
    null_rejecting: bool = False  # comparison / IS NOT NULL conjunct

    def tighten(self, lo=None, hi=None, open_=False):
        if lo is not None:
            if lo > self.lo:
                self.lo, self.lo_open = lo, open_
            elif lo == self.lo:
                self.lo_open = self.lo_open or open_
        if hi is not None:
            if hi < self.hi:
                self.hi, self.hi_open = hi, open_
            elif hi == self.hi:
                self.hi_open = self.hi_open or open_


def _is_plain_numeric(ty: t.Type) -> bool:
    return isinstance(ty, (t.IntegerType, t.FloatingPointType))


def _unit_scale(unit: t.TimeUnit) -> Optional[int]:
    """Physical units per second (DAY < 1s handled by the caller)."""
    if unit == t.TimeUnit.DAY:
        return None  # special-cased: 86400 seconds per unit
    try:
        return t.unit_per_second(unit)
    except KeyError:
        return None  # MONTH: not a fixed scale


def _datetime_factor(col_unit: t.TimeUnit,
                     const_unit: t.TimeUnit) -> Optional[float]:
    """Multiplier converting a constant's physical value into the
    column's physical unit space (exact for whole-unit conversions)."""
    def per_sec(u):
        s = _unit_scale(u)
        if s is not None:
            return float(s)
        return 1.0 / 86400.0 if u == t.TimeUnit.DAY else None

    a, b = per_sec(col_unit), per_sec(const_unit)
    if a is None or b is None:
        return None
    return a / b


def _order_safe_scale(col_type: t.Type, const_type: t.Type
                      ) -> Optional[float]:
    """Multiplier mapping the constant's physical value into the raw
    column-stat space when the comparison is order-consistent, else
    None.  1.0 = identical physical encodings."""
    c, k = col_type, const_type
    if isinstance(c, t.DecimalType) or isinstance(k, t.DecimalType):
        # binder aligns scales; equal scale = raw int compare is ordered
        if (isinstance(c, t.DecimalType) and isinstance(k, t.DecimalType)
                and c.scale == k.scale):
            return 1.0
        return None
    if _is_plain_numeric(c) and _is_plain_numeric(k):
        return 1.0
    # date/time/timestamp: convert between fixed-scale units (the
    # runtime compares after the same conversion, so bounds stay exact)
    if (isinstance(c, (t.DateType, t.TimestampType))
            and isinstance(k, (t.DateType, t.TimestampType))):
        return _datetime_factor(c.unit, k.unit)
    if isinstance(c, t.TimeType) and isinstance(k, t.TimeType):
        return _datetime_factor(c.unit, k.unit)
    return None


def _strip_order_safe_casts(e: ir.Expr) -> ir.Expr:
    """Peel exactly-representable widening casts (int->wider int,
    fp32->fp64): they are strictly order-preserving, so the underlying
    column's stats stay usable.  int->fp is only weakly monotone above
    2^53 and is NOT stripped (a rounded constant could mis-prune)."""
    while isinstance(e, ir.Cast):
        src = e.operand.type
        dst = e.type
        int_widen = (isinstance(src, t.IntegerType)
                     and isinstance(dst, t.IntegerType)
                     and dst.size >= src.size)
        fp_widen = (isinstance(src, t.FloatingPointType)
                    and isinstance(dst, t.FloatingPointType)
                    and dst.size >= src.size)
        if not (int_widen or fp_widen):
            return e
        e = e.operand
    return e


def _const_value(e: ir.Expr):
    if isinstance(e, ir.Constant) and not e.is_null():
        v = e.value
        if hasattr(v, "item"):  # numpy scalar
            v = v.item()
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return v
    return None


def _scan_col(e: ir.Expr, src_id: int) -> Optional[int]:
    e = _strip_order_safe_casts(e)
    if isinstance(e, ir.ColumnRef) and e.node.id == src_id:
        return e.index
    return None


def column_bounds(chain: Sequence[nd.Node], src_node: nd.Node
                  ) -> Dict[int, ColBound]:
    """Per-source-column bounds implied by the Filter nodes before the
    first Project (a Project rebinds the namespace; later filters no
    longer reference scan columns directly)."""
    bounds: Dict[int, ColBound] = {}
    alias_ids = {src_node.id}

    def bound(i: int) -> ColBound:
        return bounds.setdefault(i, ColBound())

    def visit(e: ir.Expr):
        if isinstance(e, ir.BinOp):
            if e.kind == ir.BinOpKind.AND:
                visit(e.lhs)
                visit(e.rhs)
                return
            if e.kind.is_comparison() and e.kind != ir.BinOpKind.NE:
                for col_e, const_e, flip in ((e.lhs, e.rhs, False),
                                             (e.rhs, e.lhs, True)):
                    i = None
                    for aid in alias_ids:
                        i = _scan_col(col_e, aid)
                        if i is not None:
                            break
                    if i is None:
                        continue
                    v = _const_value(const_e)
                    if v is None:
                        continue
                    stripped = _strip_order_safe_casts(col_e)
                    scale = _order_safe_scale(stripped.type, const_e.type)
                    if scale is None:
                        continue
                    if scale != 1.0:
                        sv = v * scale
                        v = int(sv) if float(sv).is_integer() else sv
                    b = bound(i)
                    b.null_rejecting = True
                    kind = e.kind
                    if flip:  # const OP col  ->  col OP' const
                        kind = {ir.BinOpKind.LT: ir.BinOpKind.GT,
                                ir.BinOpKind.LE: ir.BinOpKind.GE,
                                ir.BinOpKind.GT: ir.BinOpKind.LT,
                                ir.BinOpKind.GE: ir.BinOpKind.LE,
                                ir.BinOpKind.EQ: ir.BinOpKind.EQ}[kind]
                    if kind == ir.BinOpKind.EQ:
                        b.tighten(lo=v, hi=v)
                    elif kind in (ir.BinOpKind.LT, ir.BinOpKind.LE):
                        b.tighten(hi=v, open_=kind == ir.BinOpKind.LT)
                    else:
                        b.tighten(lo=v, open_=kind == ir.BinOpKind.GT)
                    return
                # comparison not prunable: still null-rejecting for any
                # directly-referenced scan column
                for side in (e.lhs, e.rhs):
                    for aid in alias_ids:
                        i = _scan_col(side, aid)
                        if i is not None:
                            bound(i).null_rejecting = True
            return
        if isinstance(e, ir.UnOp):
            i = None
            for aid in alias_ids:
                i = _scan_col(e.operand, aid)
                if i is not None:
                    break
            if i is None:
                return
            if e.kind == "isnull":
                bound(i).must_have_null = True
            elif e.kind == "isnotnull":
                bound(i).null_rejecting = True
            return
        if isinstance(e, ir.InValues):
            i = None
            for aid in alias_ids:
                i = _scan_col(e.operand, aid)
                if i is not None:
                    break
            if i is None:
                return
            # values are raw python literals in the operand's type space
            vals = [v for v in e.values if v is not None]
            stripped = _strip_order_safe_casts(e.operand)
            if (not vals
                    or not all(isinstance(v, (int, float))
                               and not isinstance(v, bool) for v in vals)
                    or not (_is_plain_numeric(stripped.type)
                            or isinstance(stripped.type, (
                                t.DecimalType, t.DateType, t.TimeType,
                                t.TimestampType, t.DictionaryType)))):
                return
            b = bound(i)
            b.null_rejecting = True
            b.tighten(lo=min(vals), hi=max(vals))
            return
        # anything else (OR trees, LIKE, functions): no pruning info

    for n in chain:
        if isinstance(n, nd.Project):
            break
        if isinstance(n, nd.Filter):
            visit(n.condition)
            alias_ids.add(n.id)  # filters pass columns through by index
    return {i: b for i, b in bounds.items()
            if b.lo != -_INF or b.hi != _INF or b.must_have_null
            or b.null_rejecting}


def select_fragments(table, fields: Sequence[str],
                     bounds: Dict[int, ColBound]
                     ) -> Optional[List[Tuple[int, int]]]:
    """Fragments that may contain matching rows; None = no pruning
    possible (no usable stats for any bounded column)."""
    frags = table.fragments
    usable = False
    selected: List[Tuple[int, int]] = []
    for frag in frags:
        keep = True
        for i, b in bounds.items():
            name = fields[i]
            st = table.stats(name, frag)
            nrows = frag[1] - frag[0]
            all_null = st.null_count == nrows
            if b.must_have_null and st.null_count == 0:
                usable = True
                keep = False
                break
            if b.null_rejecting and all_null:
                usable = True
                keep = False
                break
            if (b.lo != -_INF or b.hi != _INF) and not all_null:
                if st.min_val is None:  # no stats for this dtype
                    continue
                usable = True
                if (st.max_val < b.lo
                        or (b.lo_open and st.max_val <= b.lo)
                        or st.min_val > b.hi
                        or (b.hi_open and st.min_val >= b.hi)):
                    keep = False
                    break
        if keep:
            selected.append(frag)
    return selected if usable else None
