"""Expression IR.

TPU-native analog of hdk::ir::Expr (reference: omniscidb/IR/Expr.h:47 and
~35 subclasses; op enums omniscidb/IR/OpTypeEnums.h).  Unlike the
reference (whose consumer is LLVM codegen), this IR's consumer is a JAX
tracer (hdk_tpu/exec/scalar.py), so the node set is the *logical* surface
only — physical concerns (null sentinels, slot widths) live in the
executor.

Every expr is immutable and carries a resolved ``type``.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Tuple

from .. import types as t


class BinOpKind(enum.Enum):
    # arithmetic (reference: OpType kPlus..kMod)
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    # comparison (kEq..kGe)
    EQ = "=="
    NE = "!="
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="
    # logical (kAnd/kOr)
    AND = "and"
    OR = "or"
    # bitwise (reference: kBwAnd/kBwOr/kBwXor via FunctionOper)
    BW_AND = "&"
    BW_OR = "|"
    BW_XOR = "^"

    def is_comparison(self) -> bool:
        return self in (BinOpKind.EQ, BinOpKind.NE, BinOpKind.LT,
                        BinOpKind.LE, BinOpKind.GT, BinOpKind.GE)

    def is_logic(self) -> bool:
        return self in (BinOpKind.AND, BinOpKind.OR)

    def is_arith(self) -> bool:
        return not (self.is_comparison() or self.is_logic())


class AggKind(enum.Enum):
    """reference: IR/OpTypeEnums.h:78-93 (AggType)."""

    COUNT = "count"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    AVG = "avg"
    COUNT_DISTINCT = "count_distinct"
    APPROX_COUNT_DISTINCT = "approx_count_distinct"
    APPROX_QUANTILE = "approx_quantile"
    QUANTILE = "quantile"
    SAMPLE = "sample"
    SINGLE_VALUE = "single_value"
    STDDEV_SAMP = "stddev"
    VAR_SAMP = "var"
    CORR = "corr"
    TOP_K = "top_k"
    BOTTOM_K = "bottom_k"


class DateTimeField(enum.Enum):
    """reference: IR/DateTime.h fields used by Extract/DateTrunc/DateAdd."""

    YEAR = "year"
    QUARTER = "quarter"
    MONTH = "month"
    DAY = "day"
    HOUR = "hour"
    MINUTE = "minute"
    SECOND = "second"
    MILLI = "millisecond"
    MICRO = "microsecond"
    NANO = "nanosecond"
    DOW = "dow"
    ISODOW = "isodow"
    DOY = "doy"
    EPOCH = "epoch"
    WEEK = "week"


class WindowKind(enum.Enum):
    """reference: IR/OpTypeEnums.h:95-112 (WindowFunctionKind)."""

    ROW_NUMBER = "row_number"
    RANK = "rank"
    DENSE_RANK = "dense_rank"
    PERCENT_RANK = "percent_rank"
    CUME_DIST = "cume_dist"
    NTILE = "ntile"
    LAG = "lag"
    LEAD = "lead"
    FIRST_VALUE = "first_value"
    LAST_VALUE = "last_value"
    NTH_VALUE = "nth_value"
    # windowed aggregates
    COUNT = "count"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    AVG = "avg"


class Expr:
    """Base expression; subclasses set ``type`` and operand slots."""

    type: t.Type

    def operands(self) -> Tuple["Expr", ...]:
        return ()

    def rebuild(self, *operands: "Expr") -> "Expr":
        """Clone with replaced operands (visitor/rewriter support —
        reference: IR/ExprRewriter.h)."""
        assert not operands
        return self

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return self.to_str()

    def to_str(self) -> str:
        raise NotImplementedError


class ColumnRef(Expr):
    """Reference to output column ``index`` of input ``node``
    (reference: IR/Expr.h ColumnRef)."""

    def __init__(self, typ: t.Type, node, index: int) -> None:
        self.type = typ
        self.node = node
        self.index = index

    def to_str(self) -> str:
        return f"{self.node.fields[self.index]}"

    def __eq__(self, other):
        return (
            isinstance(other, ColumnRef)
            and other.node is self.node
            and other.index == self.index
        )

    def __hash__(self):
        return hash((id(self.node), self.index))


class Constant(Expr):
    """Literal (reference: IR/Expr.h Constant).  value=None is NULL."""

    def __init__(self, typ: t.Type, value) -> None:
        self.type = typ if value is not None else typ.with_nullable(True)
        self.value = value

    def is_null(self) -> bool:
        return self.value is None

    def to_str(self) -> str:
        return f"NULL:{self.type}" if self.value is None else f"{self.value!r}:{self.type}"


class BinOp(Expr):
    def __init__(self, typ: t.Type, kind: BinOpKind, lhs: Expr, rhs: Expr) -> None:
        self.type = typ
        self.kind = kind
        self.lhs = lhs
        self.rhs = rhs

    def operands(self):
        return (self.lhs, self.rhs)

    def rebuild(self, lhs, rhs):
        return BinOp(self.type, self.kind, lhs, rhs)

    def to_str(self):
        return f"({self.lhs.to_str()} {self.kind.value} {self.rhs.to_str()})"


class UnOp(Expr):
    KINDS = ("not", "neg", "isnull", "isnotnull", "bw_not")

    def __init__(self, typ: t.Type, kind: str, operand: Expr) -> None:
        assert kind in self.KINDS, kind
        self.type = typ
        self.kind = kind
        self.operand = operand

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return UnOp(self.type, self.kind, operand)

    def to_str(self):
        return f"{self.kind}({self.operand.to_str()})"


class Cast(Expr):
    """reference: IR/Expr.h UOper(kCast)."""

    def __init__(self, typ: t.Type, operand: Expr) -> None:
        self.type = typ
        self.operand = operand

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return Cast(self.type, operand)

    def to_str(self):
        return f"cast({self.operand.to_str()} as {self.type})"


class CaseExpr(Expr):
    """reference: IR/Expr.h CaseExpr — WHEN/THEN pairs + ELSE."""

    def __init__(self, typ: t.Type, branches: Sequence[Tuple[Expr, Expr]],
                 else_expr: Expr) -> None:
        self.type = typ
        self.branches = tuple(branches)
        self.else_expr = else_expr

    def operands(self):
        out: List[Expr] = []
        for c, v in self.branches:
            out += [c, v]
        out.append(self.else_expr)
        return tuple(out)

    def rebuild(self, *ops):
        n = len(self.branches)
        branches = [(ops[2 * i], ops[2 * i + 1]) for i in range(n)]
        return CaseExpr(self.type, branches, ops[-1])

    def to_str(self):
        parts = " ".join(
            f"when {c.to_str()} then {v.to_str()}" for c, v in self.branches
        )
        return f"case {parts} else {self.else_expr.to_str()} end"


class AggExpr(Expr):
    """reference: IR/Expr.h AggExpr; arg1 carries quantile/k/lag-style
    scalar parameters."""

    def __init__(self, typ: t.Type, kind: AggKind, operand: Optional[Expr],
                 distinct: bool = False, arg1=None,
                 interpolation: str = "linear",
                 operand2: Optional[Expr] = None) -> None:
        self.type = typ
        self.kind = kind
        self.operand = operand
        self.distinct = distinct
        self.arg1 = arg1
        self.interpolation = interpolation
        self.operand2 = operand2  # CORR's second argument

    def operands(self):
        out = () if self.operand is None else (self.operand,)
        if self.operand2 is not None:
            out = out + (self.operand2,)
        return out

    def rebuild(self, *ops):
        operand = ops[0] if ops else None
        operand2 = ops[1] if len(ops) > 1 else None
        return AggExpr(self.type, self.kind, operand, self.distinct, self.arg1,
                       self.interpolation, operand2)

    def to_str(self):
        inner = self.operand.to_str() if self.operand is not None else "*"
        d = "distinct " if self.distinct else ""
        return f"{self.kind.value}({d}{inner})"


class ExtractExpr(Expr):
    """reference: IR/Expr.h ExtractExpr; semantics ExtractFromTime.cpp."""

    def __init__(self, typ: t.Type, field: DateTimeField, operand: Expr) -> None:
        self.type = typ
        self.field = field
        self.operand = operand

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return ExtractExpr(self.type, self.field, operand)

    def to_str(self):
        return f"extract({self.field.value} from {self.operand.to_str()})"


class DateTruncExpr(Expr):
    """reference: DateTruncate.cpp semantics."""

    def __init__(self, typ: t.Type, field: DateTimeField, operand: Expr) -> None:
        self.type = typ
        self.field = field
        self.operand = operand

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return DateTruncExpr(self.type, self.field, operand)

    def to_str(self):
        return f"date_trunc({self.field.value}, {self.operand.to_str()})"


class DateAddExpr(Expr):
    """reference: IR/Expr.h DateAddExpr; DateAdd.cpp semantics."""

    def __init__(self, typ: t.Type, field: DateTimeField, number: Expr,
                 datetime: Expr) -> None:
        self.type = typ
        self.field = field
        self.number = number
        self.datetime = datetime

    def operands(self):
        return (self.number, self.datetime)

    def rebuild(self, number, datetime):
        return DateAddExpr(self.type, self.field, number, datetime)

    def to_str(self):
        return f"date_add({self.field.value}, {self.number.to_str()}, {self.datetime.to_str()})"


class DateDiffExpr(Expr):
    def __init__(self, typ: t.Type, field: DateTimeField, start: Expr, end: Expr) -> None:
        self.type = typ
        self.field = field
        self.start = start
        self.end = end

    def operands(self):
        return (self.start, self.end)

    def rebuild(self, start, end):
        return DateDiffExpr(self.type, self.field, start, end)

    def to_str(self):
        return f"date_diff({self.field.value}, {self.start.to_str()}, {self.end.to_str()})"


class InValues(Expr):
    """reference: IR/Expr.h InValues (value list is literal)."""

    def __init__(self, operand: Expr, values: Sequence) -> None:
        self.type = t.boolean(operand.type.nullable)
        self.operand = operand
        self.values = tuple(values)

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return InValues(operand, self.values)

    def to_str(self):
        return f"{self.operand.to_str()} in {list(self.values)!r}"


class LikeExpr(Expr):
    """reference: IR/Expr.h LikeExpr.  Evaluated on the host dictionary,
    then as code-space membership on device (StringDictionary::getLike
    pattern)."""

    def __init__(self, operand: Expr, pattern: str, escape: Optional[str] = None,
                 case_insensitive: bool = False, is_regexp: bool = False) -> None:
        self.type = t.boolean(operand.type.nullable)
        self.operand = operand
        self.pattern = pattern
        self.escape = escape
        self.case_insensitive = case_insensitive
        self.is_regexp = is_regexp

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return LikeExpr(operand, self.pattern, self.escape,
                        self.case_insensitive, self.is_regexp)

    def to_str(self):
        op = "regexp" if self.is_regexp else ("ilike" if self.case_insensitive else "like")
        return f"{self.operand.to_str()} {op} {self.pattern!r}"


class KeyForString(Expr):
    """Dictionary code of a string column (reference: IR/Expr.h
    KeyForStringExpr)."""

    def __init__(self, operand: Expr) -> None:
        self.type = t.int32(operand.type.nullable)
        self.operand = operand

    def operands(self):
        return (self.operand,)

    def rebuild(self, operand):
        return KeyForString(operand)

    def to_str(self):
        return f"key_for_string({self.operand.to_str()})"


class FunctionCall(Expr):
    """Scalar builtin call (reference: IR/Expr.h FunctionOper /
    ExtensionFunctionsWhitelist).  Supported names are listed in
    exec/scalar.py _FUNCTIONS."""

    def __init__(self, typ: t.Type, name: str, args: Sequence[Expr]) -> None:
        self.type = typ
        self.name = name
        self.args = tuple(args)

    def operands(self):
        return self.args

    def rebuild(self, *ops):
        return FunctionCall(self.type, self.name, ops)

    def to_str(self):
        return f"{self.name}({', '.join(a.to_str() for a in self.args)})"


class WindowFrame:
    """Explicit ROWS/RANGE frame (reference: WindowContext.h:67-140
    WindowFrameBoundType).  ``start``/``end`` are (bound_kind, value)
    with bound_kind in {"unbounded_preceding", "preceding",
    "current_row", "following", "unbounded_following"}; value is the
    numeric offset for preceding/following, else None."""

    UNITS = ("rows", "range")
    BOUNDS = ("unbounded_preceding", "preceding", "current_row",
              "following", "unbounded_following")

    def __init__(self, unit: str, start, end) -> None:
        assert unit in self.UNITS, unit
        for kind, val in (start, end):
            assert kind in self.BOUNDS, kind
            assert (val is None) == (kind not in ("preceding", "following"))
        self.unit = unit
        self.start = tuple(start)
        self.end = tuple(end)

    def __repr__(self) -> str:
        return f"{self.unit} between {self.start} and {self.end}"

    def __eq__(self, other):
        return (isinstance(other, WindowFrame) and other.unit == self.unit
                and other.start == self.start and other.end == self.end)


class WindowFunction(Expr):
    """reference: IR/Expr.h WindowFunction; WindowContext semantics
    (SURVEY.md A.6)."""

    def __init__(self, typ: t.Type, kind: WindowKind, args: Sequence[Expr],
                 partition_keys: Sequence[Expr], order_keys: Sequence[Expr],
                 order_desc: Sequence[bool] = (), arg1=None,
                 frame: "Optional[WindowFrame]" = None) -> None:
        self.type = typ
        self.kind = kind
        self.args = tuple(args)
        self.partition_keys = tuple(partition_keys)
        self.order_keys = tuple(order_keys)
        self.order_desc = tuple(order_desc) or tuple(False for _ in order_keys)
        self.arg1 = arg1
        self.frame = frame

    def operands(self):
        return self.args + self.partition_keys + self.order_keys

    def rebuild(self, *ops):
        na, np_, no = len(self.args), len(self.partition_keys), len(self.order_keys)
        return WindowFunction(
            self.type, self.kind, ops[:na], ops[na:na + np_],
            ops[na + np_:na + np_ + no], self.order_desc, self.arg1,
            self.frame,
        )

    def to_str(self):
        return (f"{self.kind.value}({', '.join(a.to_str() for a in self.args)}) over("
                f"partition by {[k.to_str() for k in self.partition_keys]} "
                f"order by {[k.to_str() for k in self.order_keys]})")


def is_agg_free(expr: Expr) -> bool:
    if isinstance(expr, AggExpr) or isinstance(expr, WindowFunction):
        return False
    return all(is_agg_free(op) for op in expr.operands())


def collect_column_refs(expr: Expr, out: Optional[List[ColumnRef]] = None) -> List[ColumnRef]:
    """reference: IR/ExprCollector.h (ColumnRef collection)."""
    if out is None:
        out = []
    if isinstance(expr, ColumnRef):
        out.append(expr)
    for op in expr.operands():
        collect_column_refs(op, out)
    return out
