"""Static expression-range inference from fragment stats.

Reference: QueryEngine/ExpressionRange.cpp — ``getExpressionRange``
walks an expr over chunk metadata (min/max per fragment) to bound
integer expressions; the result drives the perfect-hash layout choice
and fragment skipping.  Same role here: bound group-by keys without a
device round-trip.

Returns (lo, hi, has_nulls) or None when unbounded/unsupported.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd

Range = Tuple[int, int, bool]

# fields with intrinsic bounds regardless of the operand
_FIELD_BOUNDS = {
    ir.DateTimeField.MONTH: (1, 12),
    ir.DateTimeField.DAY: (1, 31),
    ir.DateTimeField.HOUR: (0, 23),
    ir.DateTimeField.MINUTE: (0, 59),
    ir.DateTimeField.SECOND: (0, 59),
    ir.DateTimeField.DOW: (0, 6),
    ir.DateTimeField.ISODOW: (1, 7),
    ir.DateTimeField.DOY: (1, 366),
    ir.DateTimeField.WEEK: (1, 53),
    ir.DateTimeField.QUARTER: (1, 4),
}


def _column_source_range(ref: ir.ColumnRef) -> Optional[Range]:
    """Range of a ColumnRef by following pass-through nodes to a Scan."""
    node = ref.node
    idx = ref.index
    # outer-join padding introduces NULLs the source stats don't know;
    # track it so the perfect layouts keep their null slot
    pad_nulls = False

    def _out(r: Optional[Range]) -> Optional[Range]:
        if r is None or not pad_nulls:
            return r
        return r[0], r[1], True

    while True:
        if isinstance(node, nd.Scan):
            name = node.fields[idx]
            lo, hi, has_nulls = node.table.column_range(name)
            if lo is None:
                return None
            typ = node.output_types[idx]
            if not (typ.is_integer() or typ.is_boolean()
                    or typ.is_dict_encoded_string() or typ.is_datetime()):
                return None
            return _out((int(lo), int(hi), has_nulls or typ.nullable))
        if isinstance(node, (nd.Filter, nd.Sort)):
            node = node.inputs[0]
            continue
        if isinstance(node, nd.Project):
            return _out(infer_range(node.exprs[idx]))
        if isinstance(node, nd.Join):
            # join output columns are value-preserving row subsets /
            # replications of one input side: the source range stays a
            # valid (superset) bound
            nl = len(node.inputs[0].fields)
            if node.output_types[idx].nullable:
                pad_nulls = True  # conservative: covers outer padding
            if idx < nl:
                node = node.inputs[0]
            else:
                node, idx = node.inputs[1], idx - nl
            continue
        if isinstance(node, nd.Aggregate) and idx < len(node.keys):
            # group-by key columns take values from the key expression
            return _out(infer_range(node.keys[idx]))
        return None


def infer_range(e: ir.Expr) -> Optional[Range]:
    if isinstance(e, ir.ColumnRef):
        return _column_source_range(e)
    if isinstance(e, ir.Constant):
        if e.value is None:
            return None
        if isinstance(e.value, (int, bool)):
            v = int(e.value)
            return v, v, False
        return None
    if isinstance(e, ir.Cast):
        inner = infer_range(e.operand)
        if inner is None:
            return None
        if e.type.is_integer() and (e.operand.type.is_integer()
                                    or e.operand.type.is_boolean()):
            return inner
        if e.operand.type.is_fp() or e.operand.type.is_decimal():
            return None
        if e.type.is_integer():
            return inner
        return None
    if isinstance(e, ir.ExtractExpr):
        b = _FIELD_BOUNDS.get(e.field)
        nullable = e.operand.type.nullable
        if b is not None:
            return b[0], b[1], nullable
        if e.field == ir.DateTimeField.YEAR:
            inner = _operand_epoch_seconds_range(e.operand)
            if inner is None:
                return None
            lo_s, hi_s, has_nulls = inner
            lo_y = datetime.datetime.fromtimestamp(
                lo_s, tz=datetime.timezone.utc).year
            hi_y = datetime.datetime.fromtimestamp(
                hi_s, tz=datetime.timezone.utc).year
            return lo_y, hi_y, has_nulls or nullable
        return None
    if isinstance(e, ir.BinOp) and e.kind.is_arith() and e.type.is_integer():
        a = infer_range(e.lhs)
        b = infer_range(e.rhs)
        if a is None or b is None:
            return None
        alo, ahi, an = a
        blo, bhi, bn = b
        if e.kind == ir.BinOpKind.ADD:
            return alo + blo, ahi + bhi, an or bn
        if e.kind == ir.BinOpKind.SUB:
            return alo - bhi, ahi - blo, an or bn
        if e.kind == ir.BinOpKind.MUL:
            cands = [alo * blo, alo * bhi, ahi * blo, ahi * bhi]
            return min(cands), max(cands), an or bn
        return None
    return None


def _operand_epoch_seconds_range(e: ir.Expr) -> Optional[Range]:
    """Range of a datetime expr in epoch seconds."""
    r = infer_range(e) if not isinstance(e, ir.ColumnRef) else _column_source_range(e)
    if r is None:
        return None
    lo, hi, has_nulls = r
    typ = e.type
    if typ.is_date() and typ.unit == t.TimeUnit.DAY:  # type: ignore[attr-defined]
        return lo * 86400, hi * 86400, has_nulls
    if typ.is_datetime():
        up = t.unit_per_second(typ.unit)  # type: ignore[attr-defined]
        return lo // up, hi // up, has_nulls
    return None
