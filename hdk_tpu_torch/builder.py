"""Query builder: SQL-free construction of IR DAGs.

Reference: the pyhdk dataframe API (python/pyhdk/hdk.py:31-2014 —
QueryExpr ops :31-1537, QueryNode.proj/agg/sort/join/filter/run
:1539-2014) backed by the C++ QueryBuilder
(omniscidb/QueryBuilder/QueryBuilder.h:50: BuilderExpr/BuilderNode).
This is the primary entry point (the Modin path, SURVEY.md §3.2): no
parser, IR constructed directly.

``QueryExpr`` wraps an ir.Expr with operator overloading and carries an
optional output name; ``QueryNode`` wraps an ir.Node and offers the
relational verbs.  ``run()`` hands the DAG to the session executor.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple, Union

from . import types as t
from .ir import expr as ir
from .ir import node as nd

_AGG_RE = re.compile(r"^\s*(\w+)\s*(?:\(\s*([^)]*)\s*\))?\s*$")


def _to_expr(val, like: Optional[ir.Expr] = None) -> ir.Expr:
    """Coerce python literals to Constant exprs (type inferred, or taken
    from a peer expr for numeric literals)."""
    if isinstance(val, QueryExpr):
        return val.expr
    if isinstance(val, ir.Expr):
        return val
    if val is None:
        typ = like.type if like is not None else t.null_t()
        return ir.Constant(typ, None)
    if isinstance(val, bool):
        return ir.Constant(t.boolean(False), val)
    if isinstance(val, int):
        if like is not None and like.type.is_decimal():
            return ir.Constant(like.type, val)
        return ir.Constant(t.int64(False), val)
    if isinstance(val, float):
        if like is not None and like.type.is_decimal():
            return ir.Constant(like.type, val)
        return ir.Constant(t.fp64(False), val)
    if isinstance(val, str):
        if like is not None and like.type.is_dict_encoded_string():
            return ir.Constant(like.type, val)
        return ir.Constant(t.text(False), val)
    raise TypeError(f"cannot build literal from {val!r}")


def _coerce_string_literal(lhs: ir.Expr, rhs: ir.Expr):
    """Comparing a dict-encoded string column to a raw string literal:
    re-type the literal into the column's dictionary code space so the
    compare runs on int32 codes (reference: transient literal encoding in
    StringDictionaryProxy; an absent literal gets code -1 which equals no
    real code).  Dict-vs-dict comparisons already translate in the scalar
    compiler (scalar.py translate_dict_codes)."""
    def fix(col_t, e):
        if (col_t.is_dict_encoded_string() and isinstance(e, ir.Constant)
                and e.type.is_string() and not e.type.is_dict_encoded_string()):
            return ir.Constant(col_t.with_nullable(e.value is None), e.value)
        return e

    return fix(rhs.type, lhs), fix(lhs.type, rhs)


def _arith_type(kind: ir.BinOpKind, lt: t.Type, rt: t.Type) -> t.Type:
    ct = t.common_type(lt, rt)
    if kind == ir.BinOpKind.DIV and ct.is_decimal():
        return ct  # decimal division keeps max scale
    return ct


class QueryExpr:
    """Expression wrapper (reference: QueryExprAPI, hdk.py:31-1537)."""

    def __init__(self, expr: ir.Expr, name: Optional[str] = None) -> None:
        self.expr = expr
        self._name = name

    # -- naming ------------------------------------------------------------
    def name(self, name: str) -> "QueryExpr":
        """Output column name (reference: BuilderExpr::name)."""
        return QueryExpr(self.expr, name)

    @property
    def out_name(self) -> Optional[str]:
        return self._name

    @property
    def type(self) -> t.Type:
        return self.expr.type

    def __repr__(self) -> str:  # pragma: no cover
        return f"QueryExpr({self.expr.to_str()})"

    # -- arithmetic --------------------------------------------------------
    def _bin(self, kind: ir.BinOpKind, other, reflected: bool = False) -> "QueryExpr":
        oe = _to_expr(other, like=self.expr)
        lhs, rhs = (oe, self.expr) if reflected else (self.expr, oe)
        if kind.is_comparison():
            lhs, rhs = _coerce_string_literal(lhs, rhs)
        if kind.is_comparison() or kind.is_logic():
            typ = t.boolean(lhs.type.nullable or rhs.type.nullable)
        else:
            typ = _arith_type(kind, lhs.type, rhs.type)
        return QueryExpr(ir.BinOp(typ, kind, lhs, rhs))

    def __add__(self, o):
        return self._bin(ir.BinOpKind.ADD, o)

    def __radd__(self, o):
        return self._bin(ir.BinOpKind.ADD, o, True)

    def __sub__(self, o):
        return self._bin(ir.BinOpKind.SUB, o)

    def __rsub__(self, o):
        return self._bin(ir.BinOpKind.SUB, o, True)

    def __mul__(self, o):
        return self._bin(ir.BinOpKind.MUL, o)

    def __rmul__(self, o):
        return self._bin(ir.BinOpKind.MUL, o, True)

    def __truediv__(self, o):
        return self._bin(ir.BinOpKind.DIV, o)

    def __rtruediv__(self, o):
        return self._bin(ir.BinOpKind.DIV, o, True)

    def __mod__(self, o):
        return self._bin(ir.BinOpKind.MOD, o)

    def __neg__(self):
        return QueryExpr(ir.UnOp(self.expr.type, "neg", self.expr))

    # -- comparison --------------------------------------------------------
    def __eq__(self, o):  # type: ignore[override]
        return self._bin(ir.BinOpKind.EQ, o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(ir.BinOpKind.NE, o)

    def __lt__(self, o):
        return self._bin(ir.BinOpKind.LT, o)

    def __le__(self, o):
        return self._bin(ir.BinOpKind.LE, o)

    def __gt__(self, o):
        return self._bin(ir.BinOpKind.GT, o)

    def __ge__(self, o):
        return self._bin(ir.BinOpKind.GE, o)

    def __hash__(self):
        return id(self)

    # -- logical -----------------------------------------------------------
    def __and__(self, o):
        return self._bin(ir.BinOpKind.AND, o)

    def __or__(self, o):
        return self._bin(ir.BinOpKind.OR, o)

    def __invert__(self):
        return QueryExpr(ir.UnOp(t.boolean(self.type.nullable), "not", self.expr))

    def logical_not(self):
        return ~self

    # -- named method aliases (reference: QueryExprAPI hdk.py:31-1537) ------
    def add(self, o):
        return self + o

    def sub(self, o):
        return self - o

    def mul(self, o):
        return self * o

    def truediv(self, o):
        return self / o

    def div(self, o):
        return self / o

    def floordiv(self, o):
        """Integer (truncating) division regardless of operand types."""
        out = self / o
        if out.type.is_fp():
            from .ir.expr import FunctionCall

            return QueryExpr(FunctionCall(out.type, "floor", [out.expr]))
        return out

    def mod(self, o):
        return self % o

    def uminus(self):
        return -self

    def eq(self, o):
        return self == o

    def ne(self, o):
        return self != o

    def lt(self, o):
        return self < o

    def le(self, o):
        return self <= o

    def gt(self, o):
        return self > o

    def ge(self, o):
        return self >= o

    def logical_and(self, o):
        return self & o

    def logical_or(self, o):
        return self | o

    def bw_and(self, o):
        return self._bin(ir.BinOpKind.BW_AND, o)

    def bw_or(self, o):
        return self._bin(ir.BinOpKind.BW_OR, o)

    def bw_xor(self, o):
        return self._bin(ir.BinOpKind.BW_XOR, o)

    def bw_not(self):
        return QueryExpr(ir.UnOp(self.type, "bw_not", self.expr))

    def rename(self, name: str) -> "QueryExpr":
        """Alias of name() (reference: BuilderExpr::rename)."""
        return self.name(name)

    # -- null tests --------------------------------------------------------
    def is_null(self) -> "QueryExpr":
        return QueryExpr(ir.UnOp(t.boolean(False), "isnull", self.expr))

    def is_not_null(self) -> "QueryExpr":
        return QueryExpr(ir.UnOp(t.boolean(False), "isnotnull", self.expr))

    # -- cast / misc -------------------------------------------------------
    def cast(self, type_str: Union[str, t.Type]) -> "QueryExpr":
        typ = t.parse_type(type_str) if isinstance(type_str, str) else type_str
        return QueryExpr(ir.Cast(typ, self.expr), self._name)

    def in_values(self, values: Sequence) -> "QueryExpr":
        return QueryExpr(ir.InValues(self.expr, values))

    def like(self, pattern: str, escape: Optional[str] = None) -> "QueryExpr":
        return QueryExpr(ir.LikeExpr(self.expr, pattern, escape))

    def ilike(self, pattern: str, escape: Optional[str] = None) -> "QueryExpr":
        return QueryExpr(ir.LikeExpr(self.expr, pattern, escape, True))

    def regexp(self, pattern: str) -> "QueryExpr":
        return QueryExpr(ir.LikeExpr(self.expr, pattern, None, False, True))

    def cardinality(self) -> "QueryExpr":
        """Element count of an array value (reference: IR/Expr.h
        Cardinality)."""
        return QueryExpr(ir.FunctionCall(
            t.int32(self.expr.type.nullable), "cardinality", [self.expr]))

    def at(self, index: int) -> "QueryExpr":
        """Array subscript (0-based); out-of-range -> NULL."""
        elem = self.expr.type.elem_type.with_nullable(True)
        return QueryExpr(ir.FunctionCall(
            elem, "array_at",
            [self.expr, ir.Constant(t.int32(False), int(index))]))

    def lower(self) -> "QueryExpr":
        """reference: IR/Expr.h Lower (dict-code translation on device)."""
        return QueryExpr(ir.FunctionCall(self.expr.type, "lower", [self.expr]))

    def upper(self) -> "QueryExpr":
        return QueryExpr(ir.FunctionCall(self.expr.type, "upper", [self.expr]))

    def key_for_string(self) -> "QueryExpr":
        return QueryExpr(ir.KeyForString(self.expr))

    # -- datetime ----------------------------------------------------------
    def extract(self, field: Union[str, ir.DateTimeField]) -> "QueryExpr":
        f = ir.DateTimeField(field) if isinstance(field, str) else field
        return QueryExpr(ir.ExtractExpr(t.int64(self.type.nullable), f, self.expr))

    def trunc(self, field: Union[str, ir.DateTimeField]) -> "QueryExpr":
        f = ir.DateTimeField(field) if isinstance(field, str) else field
        return QueryExpr(ir.DateTruncExpr(self.type, f, self.expr))

    def add_interval(self, number, field: Union[str, ir.DateTimeField]) -> "QueryExpr":
        f = ir.DateTimeField(field) if isinstance(field, str) else field
        n = _to_expr(number)
        return QueryExpr(ir.DateAddExpr(self.type, f, n, self.expr))

    def diff(self, field: Union[str, ir.DateTimeField], other) -> "QueryExpr":
        """Units from self to other (reference: BuilderExpr::difference)."""
        f = ir.DateTimeField(field) if isinstance(field, str) else field
        oe = _to_expr(other, like=self.expr)
        nullable = self.type.nullable or oe.type.nullable
        return QueryExpr(ir.DateDiffExpr(t.int64(nullable), f, self.expr, oe))

    # -- aggregates (reference: BuilderExpr agg ctors) ----------------------
    def _agg(self, kind: ir.AggKind, out_type: t.Type, distinct=False,
             arg1=None, name_suffix: Optional[str] = None,
             interpolation: str = "linear") -> "QueryExpr":
        agg = ir.AggExpr(out_type, kind, self.expr, distinct, arg1, interpolation)
        base = self._name or _expr_base_name(self.expr)
        suffix = name_suffix or kind.value
        return QueryExpr(agg, f"{base}_{suffix}" if base else suffix)

    def count(self, distinct: bool = False) -> "QueryExpr":
        if distinct:
            return self._agg(ir.AggKind.COUNT_DISTINCT, t.int64(False), True)
        return self._agg(ir.AggKind.COUNT, t.int64(False))

    def sum(self, distinct: bool = False) -> "QueryExpr":
        st = self.type
        if st.is_integer() or st.is_boolean():
            out = t.int64()
        elif st.is_decimal():
            out = st.with_nullable(True)
        else:
            out = st.with_nullable(True)
        return self._agg(ir.AggKind.SUM, out, distinct)

    def avg(self, distinct: bool = False) -> "QueryExpr":
        return self._agg(ir.AggKind.AVG, t.fp64(), distinct)

    def min(self) -> "QueryExpr":
        return self._agg(ir.AggKind.MIN, self.type.with_nullable(True))

    def max(self) -> "QueryExpr":
        return self._agg(ir.AggKind.MAX, self.type.with_nullable(True))

    def approx_count_distinct(self) -> "QueryExpr":
        return self._agg(ir.AggKind.APPROX_COUNT_DISTINCT, t.int64(False))

    def approx_quantile(self, prob: float) -> "QueryExpr":
        return self._agg(ir.AggKind.APPROX_QUANTILE, t.fp64(), arg1=prob)

    def quantile(self, prob: float, interpolation: str = "linear") -> "QueryExpr":
        return self._agg(ir.AggKind.QUANTILE, t.fp64(), arg1=prob,
                         interpolation=interpolation)

    def stddev(self) -> "QueryExpr":
        return self._agg(ir.AggKind.STDDEV_SAMP, t.fp64())

    def var(self) -> "QueryExpr":
        return self._agg(ir.AggKind.VAR_SAMP, t.fp64())

    def top_k(self, k: int) -> "QueryExpr":
        """k largest values per group, as an array column
        (reference: hdk.py top_k / TopKRuntime.cpp)."""
        agg = ir.AggExpr(t.array(self.type.with_nullable(False)),
                         ir.AggKind.TOP_K, self.expr, arg1=k)
        base = self._name or _expr_base_name(self.expr)
        return QueryExpr(agg, f"{base}_top_k" if base else "top_k")

    def bottom_k(self, k: int) -> "QueryExpr":
        """k smallest values per group (reference: hdk.py bottom_k)."""
        agg = ir.AggExpr(t.array(self.type.with_nullable(False)),
                         ir.AggKind.BOTTOM_K, self.expr, arg1=k)
        base = self._name or _expr_base_name(self.expr)
        return QueryExpr(agg, f"{base}_bottom_k" if base else "bottom_k")

    def corr(self, other: "QueryExpr") -> "QueryExpr":
        oe = _to_expr(other, like=self.expr)
        agg = ir.AggExpr(t.fp64(), ir.AggKind.CORR, self.expr,
                         operand2=oe)
        base = self._name or _expr_base_name(self.expr)
        return QueryExpr(agg, f"{base}_corr" if base else "corr")

    def sample(self) -> "QueryExpr":
        return self._agg(ir.AggKind.SAMPLE, self.type.with_nullable(True))

    def single_value(self) -> "QueryExpr":
        return self._agg(ir.AggKind.SINGLE_VALUE, self.type.with_nullable(True))

    # -- window functions (reference: hdk.py:2791-2922 + over :1456) --------
    def over(self, *partition_keys) -> "QueryExpr":
        """Attach a PARTITION BY to a window shell or aggregate
        (reference: QueryExpr.over, hdk.py:1456)."""
        parts = [_to_expr(k) for k in partition_keys]
        e = self.expr
        if isinstance(e, ir.WindowFunction):
            wf = ir.WindowFunction(e.type, e.kind, e.args, parts,
                                   e.order_keys, e.order_desc, e.arg1,
                                   e.frame)
        elif isinstance(e, ir.AggExpr):
            kind = ir.WindowKind(e.kind.value)  # count/sum/min/max/avg
            args = [e.operand] if e.operand is not None else []
            wf = ir.WindowFunction(e.type, kind, args, parts, [])
        else:
            raise TypeError("over() applies to window functions/aggregates")
        return QueryExpr(wf, self._name)

    def order_by(self, *keys) -> "QueryExpr":
        """ORDER BY for a window expression; keys may be (expr, "desc")."""
        e = self.expr
        assert isinstance(e, ir.WindowFunction), "order_by() needs a window fn"
        order = []
        descs = []
        for k in keys:
            if isinstance(k, tuple):
                order.append(_to_expr(k[0]))
                descs.append(str(k[1]).lower() in ("desc", "descending"))
            else:
                order.append(_to_expr(k))
                descs.append(False)
        wf = ir.WindowFunction(e.type, e.kind, e.args, e.partition_keys,
                               order, descs, e.arg1, e.frame)
        return QueryExpr(wf, self._name)

    def lag(self, n: int = 1) -> "QueryExpr":
        """reference: hdk.py:399."""
        wf = ir.WindowFunction(self.type.with_nullable(True),
                               ir.WindowKind.LAG, [self.expr], [], [], (), n)
        base = self._name or _expr_base_name(self.expr)
        return QueryExpr(wf, f"{base}_lag" if base else "lag")

    def lead(self, n: int = 1) -> "QueryExpr":
        """reference: hdk.py:429."""
        wf = ir.WindowFunction(self.type.with_nullable(True),
                               ir.WindowKind.LEAD, [self.expr], [], [], (), n)
        base = self._name or _expr_base_name(self.expr)
        return QueryExpr(wf, f"{base}_lead" if base else "lead")

    def first_value(self) -> "QueryExpr":
        wf = ir.WindowFunction(self.type.with_nullable(True),
                               ir.WindowKind.FIRST_VALUE, [self.expr], [], [])
        return QueryExpr(wf, "first_value")

    def last_value(self) -> "QueryExpr":
        wf = ir.WindowFunction(self.type.with_nullable(True),
                               ir.WindowKind.LAST_VALUE, [self.expr], [], [])
        return QueryExpr(wf, "last_value")

    def nth_value(self, n: int) -> "QueryExpr":
        """n-th row of the window frame, 1-based (reference:
        WindowContext NTH_VALUE)."""
        assert n >= 1
        wf = ir.WindowFunction(self.type.with_nullable(True),
                               ir.WindowKind.NTH_VALUE, [self.expr], [], [],
                               (), n)
        return QueryExpr(wf, "nth_value")

    def frame(self, unit: str, start, end) -> "QueryExpr":
        """Attach an explicit ROWS/RANGE frame to a window expression.

        ``start``/``end``: "unbounded_preceding", "current_row",
        "unbounded_following", or ("preceding"|"following", offset).
        """
        e = self.expr
        assert isinstance(e, ir.WindowFunction), "frame() needs a window fn"
        norm = lambda b: (b, None) if isinstance(b, str) else tuple(b)
        fr = ir.WindowFrame(unit, norm(start), norm(end))
        wf = ir.WindowFunction(e.type.with_nullable(True), e.kind, e.args,
                               e.partition_keys, e.order_keys, e.order_desc,
                               e.arg1, fr)
        return QueryExpr(wf, self._name)


def _expr_base_name(e: ir.Expr) -> Optional[str]:
    if isinstance(e, ir.ColumnRef):
        return e.node.fields[e.index]
    return None


def if_then_else(cond, then_val, else_val) -> QueryExpr:
    """reference: hdk.py:2924 if_then_else / CaseExpr."""
    ce = _to_expr(cond)
    te = _to_expr(then_val)
    ee = _to_expr(else_val, like=te)
    typ = t.common_type(te.type, ee.type)
    return QueryExpr(ir.CaseExpr(typ, [(ce, te)], ee))


class QueryNode:
    """Relational-verb wrapper over an ir.Node (reference: QueryNodeAPI,
    hdk.py:1539-2014)."""

    def __init__(self, node: nd.Node, session) -> None:
        self.node = node
        self._session = session

    # -- column access -----------------------------------------------------
    def ref(self, col: Union[str, int]) -> QueryExpr:
        if isinstance(col, int):
            idx = col if col >= 0 else self.node.size() + col
            return QueryExpr(self.node.ref(idx), self.node.fields[idx])
        if col not in self.node.fields and isinstance(self.node, nd.Scan):
            from .storage.table import ROWID_NAME

            if col == ROWID_NAME:
                return QueryExpr(self.node.ref(self.node.ensure_rowid()), col)
        return QueryExpr(self.node.ref_by_name(col), col)

    def __getitem__(self, col) -> QueryExpr:
        return self.ref(col)

    @property
    def schema(self) -> List[Tuple[str, t.Type]]:
        return list(zip(self.node.fields, self.node.output_types))

    @property
    def size(self) -> int:
        return self.node.size()

    @property
    def table_name(self):
        """Source table name for scans, None otherwise (reference:
        hdk.py:1949 table_name)."""
        tbl = getattr(self.node, "table", None)
        return getattr(tbl, "name", None)

    def column_info(self, col) -> Tuple[str, t.Type]:
        """(name, type) of a column by index, name or ref (reference:
        hdk.py:1924 column_info)."""
        if isinstance(col, QueryExpr):
            from .ir.expr import ColumnRef

            if isinstance(col.expr, ColumnRef):
                i = col.expr.index
                return self.node.fields[i], self.node.output_types[i]
            raise TypeError("column_info needs a plain column reference")
        if isinstance(col, int):
            return self.node.fields[col], self.node.output_types[col]
        i = self.node.fields.index(col)
        return self.node.fields[i], self.node.output_types[i]

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(f"{n}: {ty}" for n, ty in self.schema)
        return f"QueryNode<{type(self.node).__name__}>({cols})"

    # -- relational verbs --------------------------------------------------
    def proj(self, *cols, **named) -> "QueryNode":
        """Projection; accepts names, indices, exprs, and keyword-named
        exprs (reference: hdk.py proj)."""
        exprs: List[ir.Expr] = []
        fields: List[str] = []
        items = list(cols) + [
            (v.name(k) if isinstance(v, QueryExpr) else self.ref(v).name(k))
            for k, v in named.items()
        ]
        if not items:
            items = list(self.node.fields)
        for i, item in enumerate(items):
            qe = self._as_expr(item)
            exprs.append(_bind(qe.expr, self.node))
            fields.append(qe.out_name or f"expr_{i}")
        fields = _dedup(fields)
        return self._wrap(nd.Project(self.node, exprs, fields))

    def filter(self, *conditions) -> "QueryNode":
        node = self.node
        for cond in conditions:
            qe = self._as_expr(cond)
            # conditions were built against self.node; rebase onto the
            # growing filter chain (Filter passes the schema through 1:1)
            expr = qe.expr if node is self.node else _rebase(qe.expr, self.node, node)
            node = nd.Filter(node, _bind(expr, node))
        return self._wrap(node)

    def agg(self, group_keys, *aggs) -> "QueryNode":
        """Group-by aggregation (reference: hdk.py agg).  ``group_keys``:
        name/index/expr or list thereof ([] = global agg); ``aggs``:
        QueryExpr aggregates or strings like "count", "sum(x)",
        "approx_quantile(x, 0.5)"."""
        if group_keys is None:
            group_keys = []
        if not isinstance(group_keys, (list, tuple)):
            group_keys = [group_keys]
        key_exprs: List[ir.Expr] = []
        key_names: List[str] = []
        for k in group_keys:
            qe = self._as_expr(k)
            key_exprs.append(_bind(qe.expr, self.node))
            key_names.append(qe.out_name or f"key_{len(key_names)}")
        agg_exprs: List[ir.AggExpr] = []
        agg_names: List[str] = []
        for a in aggs:
            qe = self._parse_agg(a)
            assert isinstance(qe.expr, ir.AggExpr), f"not an aggregate: {a}"
            bound = _bind(qe.expr, self.node)
            assert isinstance(bound, ir.AggExpr)
            agg_exprs.append(bound)
            agg_names.append(qe.out_name or qe.expr.kind.value)
        fields = _dedup(key_names + agg_names)
        return self._wrap(nd.Aggregate(self.node, key_exprs, agg_exprs, fields))

    def count(self) -> "QueryNode":
        return self.agg([], "count")

    def join(self, rhs: "QueryNode", lhs_cols=None, rhs_cols=None,
             how: str = "inner", cond: Optional[QueryExpr] = None) -> "QueryNode":
        """Equi-join (reference: hdk.py join — default joins on common
        column names, like the reference's implicit key detection).
        ``how`` accepts inner/left/semi/anti plus right/full, the latter
        two canonicalized onto the 4-type IR (nd.outer_join_rewrite)."""
        jt = (None if how in ("right", "full", "outer")
              else nd.JoinType(how))
        if lhs_cols is None:
            common = [f for f in self.node.fields if f in rhs.node.fields]
            assert common, "no common columns to join on"
            lhs_cols = common
        if rhs_cols is None:
            rhs_cols = lhs_cols
        if not isinstance(lhs_cols, (list, tuple)):
            lhs_cols = [lhs_cols]
        if not isinstance(rhs_cols, (list, tuple)):
            rhs_cols = [rhs_cols]
        pairs = [
            (_bind(self.ref(lc).expr, self.node),
             _bind(rhs.ref(rc).expr, rhs.node))
            for lc, rc in zip(lhs_cols, rhs_cols)
        ]
        residual = (_bind(_bind(cond.expr, self.node), rhs.node)
                    if cond is not None else None)
        if jt is None:
            kind = "full" if how == "outer" else how
            return self._wrap(nd.outer_join_rewrite(
                self.node, rhs.node, pairs, residual, kind))
        return self._wrap(nd.Join(self.node, rhs.node, pairs, jt, residual))

    def sort(self, *fields, limit: Optional[int] = None, offset: int = 0) -> "QueryNode":
        """Sort by fields: name | index | (name, "asc"/"desc") |
        (name, dir, "nulls_first"/"nulls_last") (reference: hdk.py sort)."""
        sort_fields: List[nd.SortField] = []
        for f in fields:
            desc = False
            nulls_first: Optional[bool] = None
            if isinstance(f, tuple):
                name = f[0]
                if len(f) > 1:
                    desc = str(f[1]).lower() in ("desc", "descending")
                if len(f) > 2:
                    nulls_first = str(f[2]).lower() == "nulls_first"
            else:
                name = f
            idx = (name if isinstance(name, int)
                   else self.node.fields.index(name))
            sort_fields.append(nd.SortField(idx, desc, nulls_first))
        return self._wrap(nd.Sort(self.node, sort_fields, limit, offset))

    def limit(self, limit: int, offset: int = 0) -> "QueryNode":
        return self._wrap(nd.Sort(self.node, [], limit, offset))

    def union_all(self, *others: "QueryNode") -> "QueryNode":
        return self._wrap(nd.LogicalUnion([self.node] + [o.node for o in others]))

    def unnest(self, column: str) -> "QueryNode":
        """Explode an array column into one row per element (reference:
        Calcite UNNEST; arrays come from list ingest or TOP_K/BOTTOM_K)."""
        return self._wrap(nd.Unnest(self.node,
                                    self.node.fields.index(column)))

    # -- execution ---------------------------------------------------------
    def run(self, **options):
        return self._session._run(self.node, **options)

    # -- helpers -----------------------------------------------------------
    def _wrap(self, node: nd.Node) -> "QueryNode":
        return QueryNode(node, self._session)

    def _as_expr(self, item) -> QueryExpr:
        if isinstance(item, QueryExpr):
            return item
        if isinstance(item, (str, int)):
            return self.ref(item)
        if isinstance(item, ir.Expr):
            return QueryExpr(item)
        raise TypeError(f"cannot interpret {item!r} as an expression")

    def _parse_agg(self, a) -> QueryExpr:
        if isinstance(a, QueryExpr):
            return a
        if not isinstance(a, str):
            raise TypeError(f"bad aggregate spec: {a!r}")
        m = _AGG_RE.match(a)
        if not m:
            raise ValueError(f"cannot parse aggregate: {a!r}")
        fn = m.group(1).lower()
        args = [s.strip() for s in (m.group(2) or "").split(",") if s.strip()]
        if fn == "count" and not args:
            return QueryExpr(ir.AggExpr(t.int64(False), ir.AggKind.COUNT, None),
                             "count")
        col = self.ref(args[0]) if args else None
        extra = float(args[1]) if len(args) > 1 else None
        dispatch = {
            "count": lambda: col.count(),
            "count_distinct": lambda: col.count(distinct=True),
            "sum": lambda: col.sum(),
            "avg": lambda: col.avg(),
            "mean": lambda: col.avg(),
            "min": lambda: col.min(),
            "max": lambda: col.max(),
            "approx_count_distinct": lambda: col.approx_count_distinct(),
            "approx_quantile": lambda: col.approx_quantile(extra if extra is not None else 0.5),
            "quantile": lambda: col.quantile(extra if extra is not None else 0.5),
            "median": lambda: col.quantile(0.5),
            "stddev": lambda: col.stddev(),
            "var": lambda: col.var(),
            "sample": lambda: col.sample(),
            "single_value": lambda: col.single_value(),
            "corr": lambda: col.corr(self.ref(args[1])),
        }
        if fn not in dispatch:
            raise ValueError(f"unknown aggregate function: {fn!r}")
        return dispatch[fn]()


def _rebase(expr: ir.Expr, from_node: nd.Node, to_node: nd.Node) -> ir.Expr:
    """Remap ColumnRefs from one node to a schema-identical one."""
    if isinstance(expr, ir.ColumnRef):
        if expr.node is from_node:
            return ir.ColumnRef(expr.type, to_node, expr.index)
        return expr
    ops = [_rebase(o, from_node, to_node) for o in expr.operands()]
    return expr.rebuild(*ops) if ops else expr


def _passthrough_chain(node: nd.Node) -> dict:
    """{ancestor_id: ancestor} for nodes whose schema passes through to
    ``node`` unchanged (Filter/Sort chains).  Lets users write
    ``t.filter(...).proj(x=t["v"] * 2)`` — exprs built against ``t`` bind
    onto the filtered node, exactly the reference's input rewriting
    (QueryBuilder InputRewriter / RelAlgTranslator input binding)."""
    out = {}
    cur = node
    while isinstance(cur, (nd.Filter, nd.Sort)):
        cur = cur.inputs[0]
        out[cur.id] = cur
    return out


def _bind(expr: ir.Expr, input_node: nd.Node) -> ir.Expr:
    """Rewrite refs to pass-through ancestors of ``input_node`` to refer
    to ``input_node`` itself (same column index — schemas identical)."""
    chain = _passthrough_chain(input_node)
    if not chain:
        return expr

    def rw(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.ColumnRef):
            if e.node.id in chain and e.node is not input_node:
                return ir.ColumnRef(e.type, input_node, e.index)
            return e
        ops = [rw(o) for o in e.operands()]
        return e.rebuild(*ops) if ops else e

    return rw(expr)


def _dedup(names: List[str]) -> List[str]:
    seen = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out
