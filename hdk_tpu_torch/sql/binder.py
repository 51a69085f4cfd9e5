"""SQL binder: AST -> hdk_tpu relational IR.

The analog of the reference's Calcite validate/optimize +
RelAlgDagBuilder (QueryEngine/RelAlgDagBuilder.cpp): resolves names
against the schema, classifies select items into group keys vs
aggregates, decomposes JOIN ... ON into equi-key pairs + residual,
rewrites HAVING/ORDER BY over aggregate outputs, and emits the same
Node/Expr IR the builder API produces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from . import ast as A
from .lexer import SqlError
from .parser import parse
from ..exec.codecache import expr_sig
from ..utils.timer import DebugTimer

_AGG_FNS = {
    "count", "sum", "avg", "mean", "min", "max", "stddev", "stddev_samp",
    "variance", "var_samp", "approx_count_distinct", "approx_quantile",
    "quantile", "median", "sample", "single_value", "any_value", "corr",
}

_DT_FNS = {"date_trunc", "date_add", "date_sub", "date_diff", "datediff"}


class Scope:
    """Name resolution over the current node's output positions."""

    def __init__(self, entries: List[Tuple[Optional[str], List[str]]],
                 alt: Optional[Dict[int, str]] = None) -> None:
        # entries: (alias, field names) in output order.  ``alt`` maps a
        # global position to the column's ORIGINAL name when the join
        # output renamed it (dup suffix): ``r.k`` stays resolvable even
        # though the output field is ``k_r`` (standard SQL scoping; the
        # reference gets this from Calcite's per-input namespaces).
        self.entries = entries
        self.alt = alt or {}

    @property
    def all_fields(self) -> List[str]:
        return [f for _, fields in self.entries for f in fields]

    def resolve(self, name: str, table: Optional[str]) -> int:
        pos = 0
        hits = []
        for alias, fields in self.entries:
            for i, f in enumerate(fields):
                if f.lower() == name.lower() and (
                        table is None or (alias or "").lower() == table.lower()):
                    hits.append(pos + i)
            pos += len(fields)
        if not hits and table is not None and self.alt:
            pos = 0
            for alias, fields in self.entries:
                if (alias or "").lower() == table.lower():
                    for i in range(len(fields)):
                        if self.alt.get(pos + i, "").lower() == name.lower():
                            hits.append(pos + i)
                pos += len(fields)
        if not hits:
            where = f" in table {table!r}" if table else ""
            raise SqlError(f"unknown column {name!r}{where}")
        if len(hits) > 1:
            raise SqlError(f"ambiguous column {name!r}")
        return hits[0]

    def table_span(self, table: str) -> Tuple[int, int]:
        pos = 0
        for alias, fields in self.entries:
            if (alias or "").lower() == table.lower():
                return pos, pos + len(fields)
            pos += len(fields)
        raise SqlError(f"unknown table alias {table!r}")


@dataclass
class _BoundPos:
    """Placeholder for a column resolved by POSITION against whatever
    node the enclosing expression finally binds to (decorrelated scalar
    subquery values: left-prefix positions survive later join wraps)."""

    pos: int
    zero_if_null: bool = False  # COUNT over an empty correlated set -> 0


class Binder:
    def __init__(self, session) -> None:
        self.session = session

    # ------------------------------------------------------------------
    def bind(self, sql: str) -> nd.Node:
        with DebugTimer("sql:parse", stage=True):
            q = parse(sql)
        self.ctes: Dict[str, nd.Node] = {}
        for name, sub in getattr(q, "ctes", {}).items():
            self.ctes[name] = self.bind_query(sub)
        return self.bind_query(q)

    def bind_query(self, q: A.Query) -> nd.Node:
        nodes = [self.bind_select(s) for s in q.selects]
        ops = list(getattr(q, "set_ops", []) or
                   ["union_all"] * (len(nodes) - 1))
        # INTERSECT binds tighter than UNION/EXCEPT (SQL precedence)
        while "intersect" in ops:
            i = ops.index("intersect")
            nodes[i] = self._bind_set_op(nodes[i], nodes[i + 1], "intersect")
            del nodes[i + 1], ops[i]
        node = nodes[0]
        run: List[nd.Node] = [node]
        for op, rhs in zip(ops, nodes[1:]):
            if op == "union_all":
                run.append(rhs)
                continue
            node = run[0] if len(run) == 1 else nd.LogicalUnion(run)
            if op == "union":
                u = nd.LogicalUnion([node, rhs])
                keys = [u.ref(i) for i in range(u.size())]
                node = nd.Aggregate(u, keys, [], list(u.fields))
            else:  # except
                node = self._bind_set_op(node, rhs, "except")
            run = [node]
        node = run[0] if len(run) == 1 else nd.LogicalUnion(run)
        if q.order_by or q.limit is not None or q.offset:
            scope = Scope([(None, list(node.fields))])
            node = self._apply_order_limit(node, scope, q.order_by, q.limit,
                                           q.offset)
        return node

    def _bind_set_op(self, lhs: nd.Node, rhs: nd.Node,
                     kind: str) -> nd.Node:
        """EXCEPT/INTERSECT with set semantics via tagged-union grouping
        (NULLs compare equal, as SQL set ops require — GROUP BY gives
        that for free, where a join would need null-safe keys).
        Reference capability: Calcite LogicalMinus/LogicalIntersect."""
        if lhs.size() != rhs.size():
            raise SqlError(
                f"{kind.upper()} operands must have the same column count "
                f"({lhs.size()} vs {rhs.size()})")
        fields = list(lhs.fields)
        tag_t = t.int64(False)

        def tag(node, v):
            exprs = [node.ref(i) for i in range(node.size())]
            exprs.append(ir.Constant(tag_t, v))
            return nd.Project(node, exprs, fields + ["__tag"])

        u = nd.LogicalUnion([tag(lhs, 0), tag(rhs, 1)])
        n = len(fields)
        keys = [u.ref(i) for i in range(n)]
        aggs = [ir.AggExpr(t.int64(False), ir.AggKind.SUM, u.ref(n)),
                ir.AggExpr(t.int64(False), ir.AggKind.COUNT, None)]
        agg = nd.Aggregate(u, keys, aggs, fields + ["__s", "__c"])
        s = agg.ref(n)
        c = agg.ref(n + 1)
        if kind == "except":
            cond = ir.BinOp(t.boolean(False), ir.BinOpKind.EQ, s,
                            ir.Constant(tag_t, 0))
        else:  # intersect: rows from both sides present
            cond = ir.BinOp(t.boolean(False), ir.BinOpKind.LT, s, c)
            cond = ir.BinOp(t.boolean(False), ir.BinOpKind.AND, cond,
                            ir.BinOp(t.boolean(False), ir.BinOpKind.GE, s,
                                     ir.Constant(tag_t, 1)))
        filt = nd.Filter(agg, cond)
        return nd.Project(filt, [filt.ref(i) for i in range(n)], fields)

    # ------------------------------------------------------------------
    def bind_select(self, stmt: A.SelectStmt) -> nd.Node:
        # FROM + JOINs.  FROM-less SELECT evaluates expressions over one
        # synthetic row (reference capability: Calcite VALUES plan)
        if stmt.from_table is None:
            node: nd.Node = nd.LogicalValues(["__one"], [t.int64(False)],
                                             [[1]])
            scope = Scope([(None, ["__one"])])
            if stmt.joins:
                raise SqlError("JOIN requires a FROM table")
        else:
            node, scope = self._bind_table(stmt.from_table)
        pending_cross: List[Tuple[nd.Node, Scope, str]] = []
        pending_unnest: List[A.TableRef] = []
        for join in stmt.joins:
            if join.table.unnest is not None:
                # FROM t, UNNEST(t.xs) AS e — lateral array explode
                # (reference: Calcite UNNEST).  Deferred until every
                # comma/CROSS-joined table is merged so the column
                # resolves against the FULL from-list scope
                if join.kind != "cross":
                    raise SqlError("UNNEST must follow a comma or CROSS JOIN")
                pending_unnest.append(join.table)
                continue
            rnode, rscope = self._bind_table(join.table)
            if join.kind == "cross":
                pending_cross.append((rnode, rscope, join.table.bind_name))
                continue
            node, scope = self._bind_join(node, scope, rnode, rscope,
                                          join.kind, join.on)

        where = stmt.where
        if pending_cross:
            node, scope, where = self._bind_comma_joins(
                node, scope, pending_cross, where)
        for uref in pending_unnest:
            node, scope = self._bind_unnest(node, scope, uref)

        if where is not None:
            node, where = self._rewrite_subquery_predicates(node, scope, where)
        if where is not None:
            node = nd.Filter(node, self._as_bool(
                self.bind_expr(where, node, scope)))

        has_aggs = (stmt.group_by or stmt.having is not None
                    or any(self._contains_agg(i.expr) for i in stmt.items)
                    or any(self._contains_agg(o.expr) for o in stmt.order_by))

        if has_aggs:
            if getattr(stmt, "group_sets", None) and len(stmt.group_sets) > 1:
                node, scope, out_names = self._bind_grouping_sets(
                    stmt, node, scope)
            else:
                node, scope, out_names = self._bind_aggregate(
                    stmt, node, scope)
        else:
            node, scope, out_names = self._bind_projection(stmt, node, scope)

        if stmt.distinct:
            keys = [node.ref(i) for i in range(node.size())]
            node = nd.Aggregate(node, keys, [], list(node.fields))
            scope = Scope([(None, list(node.fields))])

        node = self._apply_order_limit(node, scope, stmt.order_by, stmt.limit,
                                       stmt.offset)
        return node

    # -- correlated subquery decorrelation ------------------------------
    def _try_bind(self, e, node, scope):
        try:
            return self.bind_expr(e, node, scope)
        except SqlError:
            return None

    def _bind_correlated_select(self, q, outer_node, outer_scope,
                                what: str):
        """Decorrelate: bind subquery ``q`` extracting equality conjuncts
        that reference the OUTER scope as correlation key pairs.

        Returns (stmt, inner_node, inner_scope, corr) with corr =
        [(outer_expr, inner_expr)].  Reference analog: the deep-copy
        decorrelation rewrites in RelAlgDagBuilder
        (CorrelatedSubqueryTest.cpp shapes)."""
        if len(q.selects) != 1:
            raise SqlError(f"correlated {what} subquery cannot be a UNION")
        stmt = q.selects[0]
        if (q.order_by or q.limit is not None or q.offset
                or stmt.order_by or stmt.limit is not None):
            raise SqlError(
                f"correlated {what} subquery cannot use ORDER BY/LIMIT")
        if stmt.from_table is None:
            raise SqlError("SELECT without FROM is not supported")
        node, scope = self._bind_table(stmt.from_table)
        for join in stmt.joins:
            if join.kind == "cross":
                raise SqlError(
                    f"correlated {what} subquery cross join unsupported")
            rnode, rscope = self._bind_table(join.table)
            node, scope = self._bind_join(node, scope, rnode, rscope,
                                          join.kind, join.on)
        corr, rest = [], []
        for c in (self._conjuncts(stmt.where)
                  if stmt.where is not None else []):
            pair = None
            if isinstance(c, A.Bin) and c.op == "==":
                for inner_ast, outer_ast in ((c.lhs, c.rhs),
                                             (c.rhs, c.lhs)):
                    # standard scoping: a name resolvable inside the
                    # subquery is NOT an outer reference
                    if self._try_bind(outer_ast, node, scope) is not None:
                        continue
                    inner_ir = self._try_bind(inner_ast, node, scope)
                    outer_ir = self._try_bind(outer_ast, outer_node,
                                              outer_scope)
                    if inner_ir is not None and outer_ir is not None:
                        pair = (outer_ir, inner_ir)
                        break
            if pair is not None:
                corr.append(pair)
            else:
                rest.append(c)
        if not corr:
            raise SqlError(
                f"cannot decorrelate {what} subquery: no equality "
                f"predicate links it to the outer query")
        w = None
        for c in rest:
            w = c if w is None else A.Bin("and", w, c)
        if w is not None:
            # corr exprs bound pre-filter stay positionally valid
            node = nd.Filter(node, self._as_bool(
                self.bind_expr(w, node, scope)))
        return stmt, node, scope, corr

    def _correlated_in_subquery(self, q, outer_node, outer_scope):
        """(sub_node, corr) for a correlated IN: outputs = [value] +
        correlation columns."""
        stmt, inode, iscope, corr = self._bind_correlated_select(
            q, outer_node, outer_scope, "IN")
        if stmt.group_by or any(self._contains_agg(i.expr)
                                for i in stmt.items):
            raise SqlError(
                "correlated IN subquery with aggregation is unsupported")
        items = [i for i in stmt.items if not isinstance(i.expr, A.Star)]
        if len(items) != 1 or len(stmt.items) != 1:
            raise SqlError("IN subquery must select exactly one column")
        val = self.bind_expr(items[0].expr, inode, iscope)
        exprs = [val] + [ie for _, ie in corr]
        sub = nd.Project(inode, exprs,
                         [f"c{i}" for i in range(len(exprs))])
        return sub, corr

    def _rewrite_subquery_predicates(self, node, scope, where):
        """IN (SELECT ...) -> SEMI/ANTI join; uncorrelated EXISTS is
        evaluated eagerly (reference: subqueries execute first,
        RelAlgExecutor.cpp:277-290).  Correlated IN/EXISTS/scalar
        subqueries decorrelate to SEMI/ANTI/LEFT joins on the extracted
        equality keys."""
        rest = []
        for c in self._conjuncts(where):
            neg = False
            inner = c
            while isinstance(inner, A.Un) and inner.op == "not":
                neg = not neg
                inner = inner.operand
            if isinstance(inner, A.InSubquery):
                anti = neg != inner.negated
                try:
                    sub = self.bind_query(inner.query)
                    corr = []
                except SqlError:
                    sub, corr = self._correlated_in_subquery(
                        inner.query, node, scope)
                if sub.size() != 1 + len(corr):
                    raise SqlError("IN subquery must select exactly one column")
                lhs_key = self.bind_expr(inner.operand, node, scope)
                if anti:
                    # three-valued NOT IN: a NULL anywhere in the subquery
                    # result makes every non-matching comparison UNKNOWN
                    # (filtered); a NULL probe key is UNKNOWN too.  Plain
                    # ANTI join is NOT EXISTS semantics — correct only
                    # after excluding both NULL sources.
                    if sub.output_types[0].nullable and not corr:
                        table = self.session._executor.execute(
                            nd.QueryDag(sub)).compact()
                        col = table.columns[0]
                        # one device->host read: is any value NULL?
                        if (table.nrows > 0 and col.mask is not None
                                and not bool(col.mask.all())):
                            rest.append(A.Lit(False))
                            continue
                    if sub.output_types[0].nullable and corr:
                        # per-group 3VL: an outer row whose correlated
                        # value set contains a NULL yields UNKNOWN for
                        # every non-matching probe — drop those rows via
                        # an ANTI join against the null-valued subset
                        sub_null = nd.Filter(sub, ir.UnOp(
                            t.boolean(False), "isnull", sub.ref(0)))
                        node = nd.Join(
                            node, sub_null,
                            [(oe, sub_null.ref(1 + i))
                             for i, (oe, _) in enumerate(corr)],
                            nd.JoinType.ANTI)
                    if lhs_key.type.nullable:
                        # Filter passes columns through positionally, so
                        # the join key refs stay valid unretargeted
                        node = nd.Filter(node, ir.UnOp(
                            t.boolean(False), "isnotnull", lhs_key))
                jt = nd.JoinType.ANTI if anti else nd.JoinType.SEMI
                keys = [(lhs_key, sub.ref(0))] + [
                    (oe, sub.ref(1 + i)) for i, (oe, _) in enumerate(corr)]
                node = nd.Join(node, sub, keys, jt)
                continue
            if isinstance(inner, A.ExistsE):
                want = not (neg != inner.negated)
                try:
                    sub = self.bind_query(inner.query)
                except SqlError:
                    # correlated EXISTS -> SEMI join on the correlation
                    # keys (NOT EXISTS -> ANTI)
                    stmt, inode, iscope, corr = self._bind_correlated_select(
                        inner.query, node, scope, "EXISTS")
                    if stmt.group_by or stmt.having is not None or any(
                            self._contains_agg(i.expr)
                            for i in stmt.items):
                        raise SqlError("correlated EXISTS with aggregation "
                                       "is unsupported")
                    exprs = [ie for _, ie in corr]
                    sub = nd.Project(inode, exprs,
                                     [f"c{i}" for i in range(len(exprs))])
                    node = nd.Join(
                        node, sub,
                        [(oe, sub.ref(i)) for i, (oe, _) in enumerate(corr)],
                        nd.JoinType.SEMI if want else nd.JoinType.ANTI)
                    continue
                table = self.session._executor.execute(nd.QueryDag(sub))
                if (table.live_count() > 0) != want:
                    # always-false predicate: empty result
                    rest.append(A.Lit(False))
                continue
            node, c = self._rewrite_correlated_scalars(node, scope, c)
            rest.append(c)
        out = None
        for c in rest:
            out = c if out is None else A.Bin("and", out, c)
        return node, out

    def _rewrite_correlated_scalars(self, node, scope, conj):
        """Replace correlated scalar subqueries inside a WHERE conjunct
        with LEFT-joined per-key aggregates: ``x > (SELECT agg(y) FROM t2
        WHERE t2.k = t1.k)`` joins the grouped aggregate on k and
        compares against the joined column (reference:
        CorrelatedSubqueryTest.cpp scalar shapes)."""
        import dataclasses as dc

        def transform(e):
            nonlocal node
            if isinstance(e, A.ScalarSub):
                try:
                    self.bind_query(e.query)  # probe only: binds clean?
                    return e  # uncorrelated: evaluated eagerly later
                except SqlError:
                    pass
                stmt, inode, iscope, corr = self._bind_correlated_select(
                    e.query, node, scope, "scalar")
                if stmt.group_by or stmt.having is not None:
                    raise SqlError(
                        "correlated scalar subquery with GROUP BY/HAVING "
                        "is unsupported")
                items = [i for i in stmt.items
                         if not isinstance(i.expr, A.Star)]
                if len(items) != 1 or len(stmt.items) != 1:
                    raise SqlError(
                        "scalar subquery must select exactly one column")
                item = items[0].expr
                if self._contains_agg(item):
                    if not (isinstance(item, A.Fn)
                            and item.name in _AGG_FNS):
                        raise SqlError(
                            "correlated scalar subquery must be a single "
                            "aggregate call")
                    agg = self._bind_agg(item, inode, iscope)
                else:
                    # no aggregate: enforce one-row-per-key via
                    # SINGLE_VALUE (reference: kSINGLE_VALUE wrap)
                    val = self.bind_expr(item, inode, iscope)
                    agg = ir.AggExpr(val.type.with_nullable(True),
                                     ir.AggKind.SINGLE_VALUE, val)
                ikeys = [ie for _, ie in corr]
                sub = nd.Aggregate(
                    inode, ikeys, [agg],
                    [f"k{i}" for i in range(len(ikeys))] + ["v"])
                left_size = len(node.fields)
                node = nd.Join(
                    node, sub,
                    [(oe, sub.ref(i)) for i, (oe, _) in enumerate(corr)],
                    nd.JoinType.LEFT)
                # left-prefix positions stay stable under later SEMI/ANTI/
                # LEFT wraps, so the value column late-binds by position
                # against the FINAL node (see _BoundPos in bind_expr)
                return _BoundPos(
                    left_size + len(ikeys),
                    zero_if_null=agg.kind in (ir.AggKind.COUNT,
                                              ir.AggKind.COUNT_DISTINCT))
            if isinstance(e, (A.Query, A.InSubquery, A.ExistsE)):
                return e  # different scope: never descend
            if isinstance(e, (ir.Expr, _BoundPos)) or not dc.is_dataclass(e):
                return e
            changed = False
            updates = {}
            for f in dc.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (list, tuple)):
                    nv = type(v)(transform(x) for x in v)
                    if any(a is not b for a, b in zip(nv, v)):
                        updates[f.name] = nv
                        changed = True
                else:
                    nv = transform(v)
                    if nv is not v:
                        updates[f.name] = nv
                        changed = True
            if not changed:
                return e
            return dc.replace(e, **updates)

        out = transform(conj)  # may wrap ``node`` in LEFT joins
        return node, out

    def _eval_scalar_subquery(self, q) -> ir.Expr:
        sub = self.bind_query(q)
        if sub.size() != 1:
            raise SqlError("scalar subquery must select exactly one column")
        table = self.session._executor.execute(nd.QueryDag(sub)).compact()
        if table.nrows != 1:
            raise SqlError(
                f"scalar subquery returned {table.nrows} rows, expected 1")
        col = table.columns[0]
        typ = sub.output_types[0]
        # one device->host read: the value, then its validity if nullable
        head = col.data[:1]
        if col.mask is not None:
            head = torch.cat([head, col.mask[:1].to(head.dtype)])
        host = head.cpu().tolist()
        if col.mask is not None and not host[1]:
            return ir.Constant(typ.with_nullable(True), None)
        val = host[0]
        if typ.is_fp():
            val = float(val)
        elif typ.is_boolean():
            val = bool(val)
        else:
            val = int(val)
        return ir.Constant(typ, val)

    # ------------------------------------------------------------------
    def _bind_unnest(self, node: nd.Node, scope: Scope,
                     uref: A.TableRef) -> Tuple[nd.Node, Scope]:
        """FROM ... , UNNEST(col) [AS e]: with an alias the source array
        column stays intact (Calcite/Postgres semantics) — a Project
        duplicates it first and the duplicate explodes; without an alias
        the column is replaced by its elements in place."""
        utbl, ucol = uref.unnest
        idx = scope.resolve(ucol, utbl)
        if not node.output_types[idx].is_array():
            raise SqlError(f"UNNEST argument {ucol!r} is not an array")
        if uref.alias:
            exprs = [node.ref(i) for i in range(node.size())]
            exprs.append(node.ref(idx))
            dup = nd.Project(node, exprs,
                             list(node.fields) + [uref.alias])
            node = nd.Unnest(dup, node.size())
            scope = Scope(scope.entries + [(None, [uref.alias])])
        else:
            node = nd.Unnest(node, idx)
        return node, scope

    def _bind_table(self, ref: A.TableRef) -> Tuple[nd.Node, Scope]:
        if ref.unnest is not None:
            raise SqlError(
                "UNNEST requires a preceding table in FROM "
                "(FROM t, UNNEST(t.col) AS e)")
        if ref.subquery is not None:
            node = self.bind_query(ref.subquery)
        elif ref.name and ref.name.lower() in self.ctes:
            node = self.ctes[ref.name.lower()]
        else:
            node = nd.Scan(self.session._schema.get(ref.name))
        scope = Scope([(ref.bind_name if (ref.alias or ref.name) else None,
                        list(node.fields))])
        return node, scope

    def _bind_join(self, lnode, lscope: Scope, rnode, rscope: Scope,
                   kind: str, on) -> Tuple[nd.Node, Scope]:
        if on is None:
            raise SqlError(f"{kind.upper()} JOIN requires an ON condition")
        pairs, residual = self._split_on(on, lnode, lscope, rnode, rscope)
        if not pairs and kind != "inner":
            raise SqlError(f"{kind.upper()} JOIN ON must contain at least "
                           "one equality between the two sides")
        if kind in ("right", "full"):
            return self._bind_outer_rewrite(lnode, lscope, rnode, rscope,
                                            kind, pairs, residual)
        join = nd.Join(lnode, rnode, pairs, nd.JoinType(kind), residual)
        if kind in ("semi", "anti"):
            scope = Scope(list(lscope.entries), dict(lscope.alt))
        else:
            # output fields are lhs ++ suffixed rhs; keep per-alias spans
            scope = self._join_out_scope(lscope, rscope, list(join.fields))
        return join, scope

    def _join_out_scope(self, lscope: Scope, rscope: Scope,
                        out_fields: List[str]) -> Scope:
        """Per-alias spans over a joined output (lhs spans then rhs);
        suffix-renamed dup columns stay resolvable by their qualified
        original names via the alt map."""
        entries = []
        alt = dict(lscope.alt)
        orig = ([f for _, fs in lscope.entries for f in fs]
                + [f for _, fs in rscope.entries for f in fs])
        nl = sum(len(fs) for _, fs in lscope.entries)
        for p, o in rscope.alt.items():
            alt[nl + p] = o
        pos = 0
        for alias, fields in lscope.entries + rscope.entries:
            entries.append((alias, out_fields[pos:pos + len(fields)]))
            pos += len(fields)
        for i, (o, n) in enumerate(zip(orig, out_fields)):
            if o.lower() != n.lower() and i not in alt:
                alt[i] = o
        return Scope(entries, alt)

    def _bind_outer_rewrite(self, lnode, lscope: Scope, rnode,
                            rscope: Scope, kind: str, pairs, residual
                            ) -> Tuple[nd.Node, Scope]:
        """RIGHT/FULL OUTER JOIN: binder-level canonicalization onto the
        4-type IR (see nd.outer_join_rewrite)."""
        node = nd.outer_join_rewrite(lnode, rnode, pairs, residual, kind)
        return node, self._join_out_scope(lscope, rscope,
                                          list(node.fields))

    def _split_on(self, on, lnode, lscope, rnode, rscope):
        """Decompose ON into equi-key pairs + residual (reference:
        WorkUnitBuilder join-qual split / EquiJoinCondition.cpp)."""
        conjuncts = self._conjuncts(on)
        pairs = []
        residual_parts = []
        for c in conjuncts:
            pair = self._try_equi(c, lnode, lscope, rnode, rscope)
            if pair is not None:
                pairs.append(pair)
            else:
                residual_parts.append(c)
        residual = None
        if residual_parts:
            bound = [
                self._bind_two_sided(c, lnode, lscope, rnode, rscope)
                for c in residual_parts
            ]
            residual = bound[0]
            for b in bound[1:]:
                residual = ir.BinOp(t.boolean(True), ir.BinOpKind.AND,
                                    residual, b)
        return pairs, residual

    def _conjuncts(self, e) -> List:
        if isinstance(e, A.Bin) and e.op == "and":
            return self._conjuncts(e.lhs) + self._conjuncts(e.rhs)
        return [e]

    def _side_of(self, e, lscope: Scope, rscope: Scope) -> Optional[int]:
        """0 = only lhs columns, 1 = only rhs, None = mixed/none.  A
        column resolvable in NEITHER scope (it belongs to a table later
        in the comma-join chain, e.g. TPC-H Q3's l_orderkey while
        binding customer x orders) marks the conjunct unusable here; it
        stays in WHERE for a later join step to consume."""
        sides = set()

        def walk(x):
            if isinstance(x, A.Col):
                try:
                    lscope.resolve(x.name, x.table)
                    sides.add(0)
                    return
                except SqlError:
                    pass
                try:
                    rscope.resolve(x.name, x.table)
                except SqlError:
                    sides.add(2)  # belongs to a not-yet-joined table
                    return
                sides.add(1)
                return
            for f in getattr(x, "__dict__", {}).values():
                if isinstance(f, (A.Bin, A.Un, A.Col, A.Fn, A.Case, A.CastE,
                                  A.ExtractE, A.LikeE, A.InE, A.IsNullE,
                                  A.BetweenE)):
                    walk(f)
                elif isinstance(f, list):
                    for item in f:
                        if isinstance(item, tuple):
                            for sub in item:
                                walk(sub) if not isinstance(sub, (str, int, float, bool, type(None))) else None
                        elif not isinstance(item, (str, int, float, bool, type(None))):
                            walk(item)

        walk(e)
        if sides == {0}:
            return 0
        if sides == {1}:
            return 1
        return None

    def _try_equi(self, c, lnode, lscope, rnode, rscope):
        if not (isinstance(c, A.Bin) and c.op == "=="):
            return None
        sl = self._side_of(c.lhs, lscope, rscope)
        sr = self._side_of(c.rhs, lscope, rscope)
        if sl == 0 and sr == 1:
            le = self.bind_expr(c.lhs, lnode, lscope)
            re_ = self.bind_expr(c.rhs, rnode, rscope)
            return le, re_
        if sl == 1 and sr == 0:
            le = self.bind_expr(c.rhs, lnode, lscope)
            re_ = self.bind_expr(c.lhs, rnode, rscope)
            return le, re_
        return None

    def _bind_two_sided(self, c, lnode, lscope, rnode, rscope) -> ir.Expr:
        """Bind a residual ON conjunct: lhs cols ref lnode, rhs cols ref
        rnode (executor rebinds to the join output)."""
        merged = Scope(list(lscope.entries) + list(rscope.entries))
        nl = sum(len(f) for _, f in lscope.entries)

        binder = self

        class TwoSided:
            def resolve_col(self, name, table):
                pos = merged.resolve(name, table)
                if pos < nl:
                    return lnode.ref(pos)
                return rnode.ref(pos - nl)

        return self.bind_expr(c, None, merged,
                              col_resolver=TwoSided().resolve_col)

    def _bind_comma_joins(self, node, scope, pending, where):
        """Comma-separated FROM: consume WHERE equi conjuncts as join keys
        (the classic implicit-join rewrite Calcite performs)."""
        remaining = self._conjuncts(where) if where is not None else []
        for rnode, rscope, alias in pending:
            pairs = []
            rest = []
            for c in remaining:
                pair = self._try_equi(c, node, scope, rnode, rscope)
                if pair is not None:
                    pairs.append(pair)
                else:
                    rest.append(c)
            remaining = rest
            # no equi conjunct: cartesian -> loop join (the executor
            # enforces join.enable_loop_join + the inner-rows cap);
            # leftover conjuncts stay in WHERE and filter the product
            node, scope = self._bind_join_built(node, scope, rnode, rscope,
                                                pairs)
        new_where = None
        for c in remaining:
            new_where = c if new_where is None else A.Bin("and", new_where, c)
        return node, scope, new_where

    def _bind_join_built(self, lnode, lscope, rnode, rscope, pairs):
        join = nd.Join(lnode, rnode, pairs, nd.JoinType.INNER, None)
        out = list(join.fields)
        entries = []
        pos = 0
        for alias, fields in list(lscope.entries) + list(rscope.entries):
            entries.append((alias, out[pos:pos + len(fields)]))
            pos += len(fields)
        return join, Scope(entries)

    # ------------------------------------------------------------------
    def _expand_items(self, stmt: A.SelectStmt, node, scope: Scope
                      ) -> List[Tuple[object, str]]:
        items = []
        for item in stmt.items:
            if isinstance(item.expr, A.Star):
                if item.expr.table is None:
                    for i, f in enumerate(scope.all_fields):
                        items.append((A.Col(f), f))
                else:
                    lo, hi = scope.table_span(item.expr.table)
                    fields = scope.all_fields
                    for i in range(lo, hi):
                        items.append((A.Col(fields[i],
                                            table=item.expr.table),
                                      fields[i]))
            else:
                name = item.alias or self._default_name(item.expr)
                items.append((item.expr, name))
        return items

    def _default_name(self, e) -> str:
        if isinstance(e, A.Col):
            return e.name
        if isinstance(e, A.Fn):
            return e.name
        if isinstance(e, A.ExtractE):
            return e.field
        return "expr"

    def _bind_projection(self, stmt, node, scope):
        items = self._expand_items(stmt, node, scope)
        exprs = [self.bind_expr(e, node, scope) for e, _ in items]
        names = _dedup([n for _, n in items])
        proj = nd.Project(node, exprs, names)
        return proj, Scope([(None, names)]), names

    # ------------------------------------------------------------------
    def _bind_grouping_sets(self, stmt, node, scope):
        """GROUP BY ROLLUP/CUBE/GROUPING SETS: one aggregation branch per
        grouping set, absent keys projected as typed NULLs, UNION ALL of
        the branches (the Calcite LogicalAggregate expansion; reference
        capability: Calcite grouping-sets rewrite)."""
        import copy

        branches = []
        out_names: List[str] = []
        for gs in stmt.group_sets:
            sub = copy.copy(stmt)
            sub.group_by = list(gs)
            sub.group_sets = None
            gs_sigs = {expr_sig(self.bind_expr(k, node, scope), {})
                       for k in gs}
            null_sigs = {}
            for k in stmt.group_by:
                b = self.bind_expr(k, node, scope)
                sig = expr_sig(b, {})
                if sig not in gs_sigs:
                    null_sigs[sig] = b.type
            n2, _s2, out_names = self._bind_aggregate(
                sub, node, scope, null_sigs=null_sigs)
            branches.append(n2)
        u = nd.LogicalUnion(branches)
        return u, Scope([(None, out_names)]), out_names

    def _bind_aggregate(self, stmt, node, scope, null_sigs=None):
        items = self._expand_items(stmt, node, scope)
        item_names = [n for _, n in items]

        # resolve GROUP BY entries: position | alias | expr
        key_asts = []
        for g in stmt.group_by:
            if isinstance(g, A.Lit) and isinstance(g.value, int):
                idx = g.value - 1
                if not (0 <= idx < len(items)):
                    raise SqlError(f"GROUP BY position {g.value} out of range")
                key_asts.append(items[idx][0])
            elif isinstance(g, A.Col) and g.table is None and \
                    g.name.lower() in [n.lower() for n in item_names] and \
                    not self._resolvable(g, scope):
                idx = [n.lower() for n in item_names].index(g.name.lower())
                key_asts.append(items[idx][0])
            else:
                key_asts.append(g)

        key_exprs = [self.bind_expr(k, node, scope) for k in key_asts]
        key_sigs = {expr_sig(k, {}): i for i, k in enumerate(key_exprs)}

        # collect aggregates from select items, having, order by
        agg_exprs: List[ir.AggExpr] = []
        agg_sigs: Dict[str, int] = {}

        def bind_agg_fn(e: A.Fn) -> int:
            bound = self._bind_agg(e, node, scope)
            sig = expr_sig(bound, {})
            if sig not in agg_sigs:
                agg_sigs[sig] = len(agg_exprs)
                agg_exprs.append(bound)
            return agg_sigs[sig]

        n_keys = len(key_exprs)
        key_names = [f"k{i}" for i in range(n_keys)]

        # first pass: find every aggregate call (so Aggregate node is complete)
        def collect(e):
            if isinstance(e, A.Fn) and e.name in _AGG_FNS:
                bind_agg_fn(e)
                return
            for child in _ast_children(e):
                collect(child)

        for e, _ in items:
            collect(e)
        if stmt.having is not None:
            collect(stmt.having)
        for o in stmt.order_by:
            collect(o.expr)

        agg_names = [f"a{i}" for i in range(len(agg_exprs))]
        agg_node = nd.Aggregate(node, key_exprs, agg_exprs,
                                key_names + agg_names)

        # rewrite an item expr over the aggregate's output
        def rewrite(e) -> ir.Expr:
            if isinstance(e, A.Fn) and e.name in _AGG_FNS:
                idx = bind_agg_fn(e)
                return agg_node.ref(n_keys + idx)
            # whole expr matches a group key (or a key NULLed out by the
            # current grouping set)?
            try:
                bound = self.bind_expr(e, node, scope)
                sig = expr_sig(bound, {})
                if null_sigs and sig in null_sigs:
                    return ir.Constant(null_sigs[sig].with_nullable(True),
                                       None)
                if sig in key_sigs:
                    return agg_node.ref(key_sigs[sig])
            except SqlError:
                pass
            # recurse: rebuild expr with children rewritten, binding
            # against the aggregate output
            return self.bind_expr(e, agg_node, Scope([(None, [])]),
                                  col_resolver=lambda name, table:
                                  self._agg_col_resolver(name, table, node,
                                                         scope, key_sigs,
                                                         agg_node, null_sigs),
                                  agg_rewriter=lambda fe: agg_node.ref(
                                      n_keys + bind_agg_fn(fe)))

        out_exprs = [rewrite(e) for e, _ in items]
        out_names = _dedup(item_names)

        if stmt.having is not None:
            having = self._as_bool(rewrite(stmt.having))
            agg_for_proj = nd.Filter(agg_node, having)
            # refs in out_exprs point at agg_node; Filter passes through
            out_exprs = [_retarget(e, agg_node, agg_for_proj)
                         for e in out_exprs]
        else:
            agg_for_proj = agg_node

        proj = nd.Project(agg_for_proj, out_exprs, out_names)
        return proj, Scope([(None, out_names)]), out_names

    def _agg_col_resolver(self, name, table, node, scope, key_sigs,
                          agg_node, null_sigs=None):
        pos = scope.resolve(name, table)
        bound = node.ref(pos)
        sig = expr_sig(bound, {})
        if null_sigs and sig in null_sigs:
            return ir.Constant(null_sigs[sig].with_nullable(True), None)
        if sig in key_sigs:
            return agg_node.ref(key_sigs[sig])
        raise SqlError(f"column {name!r} must appear in GROUP BY or inside "
                       "an aggregate")

    def _resolvable(self, col: A.Col, scope: Scope) -> bool:
        try:
            scope.resolve(col.name, col.table)
            return True
        except SqlError:
            return False

    # ------------------------------------------------------------------
    def _apply_order_limit(self, node, scope, order_by, limit, offset):
        if not order_by and limit is None and not offset:
            return node
        sort_fields = []
        hidden: List[ir.Expr] = []
        for o in order_by:
            idx = None
            if isinstance(o.expr, A.Lit) and isinstance(o.expr.value, int):
                idx = o.expr.value - 1
                if not (0 <= idx < node.size()):
                    raise SqlError(f"ORDER BY position {o.expr.value} out of range")
            elif isinstance(o.expr, A.Col):
                # output aliases resolve first (SQL ORDER BY scoping); a
                # table-qualified name whose bare name uniquely matches
                # an output column refers to it too (e.g. ORDER BY r.x
                # after GROUP BY r.x — the qualifier namespace is gone
                # post-aggregate but the column survives by name)
                names = [f.lower() for f in node.fields]
                bare = o.expr.name.lower()
                if bare in names and (o.expr.table is None
                                      or names.count(bare) == 1):
                    idx = names.index(bare)
            if idx is None:
                bound = self.bind_expr(o.expr, node,
                                       Scope([(None, list(node.fields))]))
                hidden.append(bound)
                idx = node.size() + len(hidden) - 1
            sort_fields.append(nd.SortField(idx, o.desc, o.nulls_first))
        base = node
        if hidden:
            exprs = [node.ref(i) for i in range(node.size())] + hidden
            names = list(node.fields) + [f"__sort_{i}" for i in range(len(hidden))]
            base = nd.Project(node, exprs, names)
        out = nd.Sort(base, sort_fields, limit, offset)
        if hidden:  # drop hidden sort columns
            exprs = [out.ref(i) for i in range(node.size())]
            out = nd.Project(out, exprs, list(node.fields))
        return out

    # ------------------------------------------------------------------
    # expression binding
    # ------------------------------------------------------------------
    def bind_expr(self, e, node, scope: Scope, col_resolver=None,
                  agg_rewriter=None) -> ir.Expr:
        b = lambda x: self.bind_expr(x, node, scope, col_resolver, agg_rewriter)
        from ..builder import QueryExpr, _to_expr

        if isinstance(e, ir.Expr):
            return e
        if isinstance(e, _BoundPos):
            ref = node.ref(e.pos)
            if e.zero_if_null:
                zt = ref.type.with_nullable(False)
                return ir.CaseExpr(zt, [(ir.UnOp(t.boolean(False), "isnull",
                                                 ref), ir.Constant(zt, 0))],
                                   ref)
            return ref
        if isinstance(e, A.Lit):
            return self._bind_literal(e)
        if isinstance(e, A.Col):
            if col_resolver is not None:
                return col_resolver(e.name, e.table)
            pos = scope.resolve(e.name, e.table)
            return node.ref(pos)
        if isinstance(e, A.Bin):
            if e.op in ("and", "or"):
                kind = ir.BinOpKind.AND if e.op == "and" else ir.BinOpKind.OR
                l, r = b(e.lhs), b(e.rhs)
                return ir.BinOp(t.boolean(l.type.nullable or r.type.nullable),
                                kind, self._as_bool(l), self._as_bool(r))
            if e.op in ("+", "-") and (isinstance(e.lhs, A.IntervalLit)
                                       or isinstance(e.rhs, A.IntervalLit)):
                return self._bind_interval_arith(e, b)
            qe = QueryExpr(b(e.lhs))._bin(ir.BinOpKind(e.op),
                                          QueryExpr(b(e.rhs)))
            return qe.expr
        if isinstance(e, A.Un):
            operand = b(e.operand)
            if e.op == "not":
                return ir.UnOp(t.boolean(operand.type.nullable), "not",
                               self._as_bool(operand))
            return ir.UnOp(operand.type, "neg", operand)
        if isinstance(e, A.IsNullE):
            kind = "isnotnull" if e.negated else "isnull"
            return ir.UnOp(t.boolean(False), kind, b(e.operand))
        if isinstance(e, A.BetweenE):
            operand = b(e.operand)
            lo = QueryExpr(operand)._bin(ir.BinOpKind.GE, QueryExpr(b(e.lo)))
            hi = QueryExpr(operand)._bin(ir.BinOpKind.LE, QueryExpr(b(e.hi)))
            both = (lo & hi).expr
            if e.negated:
                return ir.UnOp(t.boolean(both.type.nullable), "not", both)
            return both
        if isinstance(e, A.InE):
            operand = b(e.operand)
            vals = []
            for v in e.values:
                bv = b(v)
                if not isinstance(bv, ir.Constant):
                    raise SqlError("IN list must contain literals")
                vals.append(self._literal_python(bv))
            out = ir.InValues(operand, vals)
            if e.negated:
                return ir.UnOp(t.boolean(out.type.nullable), "not", out)
            return out
        if isinstance(e, A.LikeE):
            operand = b(e.operand)
            pat = b(e.pattern)
            if not isinstance(pat, ir.Constant) or not isinstance(pat.value, str):
                raise SqlError("LIKE pattern must be a string literal")
            out = ir.LikeExpr(operand, pat.value, e.escape,
                              e.case_insensitive, e.is_regexp)
            if e.negated:
                return ir.UnOp(t.boolean(out.type.nullable), "not", out)
            return out
        if isinstance(e, A.Case):
            return self._bind_case(e, b)
        if isinstance(e, A.CastE):
            return ir.Cast(t.parse_type(e.type_name), b(e.operand))
        if isinstance(e, A.ExtractE):
            field = ir.DateTimeField(_extract_alias(e.field))
            operand = b(e.operand)
            return ir.ExtractExpr(t.int64(operand.type.nullable), field, operand)
        if isinstance(e, A.Fn):
            return self._bind_fn(e, b, agg_rewriter, node, scope)
        if isinstance(e, A.Over):
            return self._bind_over(e, b)
        if isinstance(e, A.ScalarSub):
            return self._eval_scalar_subquery(e.query)
        if isinstance(e, (A.InSubquery, A.ExistsE)):
            raise SqlError("IN/EXISTS subqueries are only supported as "
                           "top-level WHERE conjuncts")
        raise SqlError(f"cannot bind expression {e!r}")

    _WINDOW_KINDS = {
        "row_number": ir.WindowKind.ROW_NUMBER,
        "rank": ir.WindowKind.RANK,
        "dense_rank": ir.WindowKind.DENSE_RANK,
        "percent_rank": ir.WindowKind.PERCENT_RANK,
        "cume_dist": ir.WindowKind.CUME_DIST,
        "ntile": ir.WindowKind.NTILE,
        "lag": ir.WindowKind.LAG,
        "lead": ir.WindowKind.LEAD,
        "first_value": ir.WindowKind.FIRST_VALUE,
        "last_value": ir.WindowKind.LAST_VALUE,
        "nth_value": ir.WindowKind.NTH_VALUE,
        "count": ir.WindowKind.COUNT,
        "sum": ir.WindowKind.SUM,
        "avg": ir.WindowKind.AVG,
        "min": ir.WindowKind.MIN,
        "max": ir.WindowKind.MAX,
    }

    _INTERVAL_FIELDS = {
        "year": ir.DateTimeField.YEAR, "quarter": ir.DateTimeField.QUARTER,
        "month": ir.DateTimeField.MONTH, "week": ir.DateTimeField.WEEK,
        "day": ir.DateTimeField.DAY, "hour": ir.DateTimeField.HOUR,
        "minute": ir.DateTimeField.MINUTE,
        "second": ir.DateTimeField.SECOND,
    }

    def _bind_interval_arith(self, e: A.Bin, b) -> ir.Expr:
        """datetime +/- INTERVAL -> DateAddExpr (reference: Calcite
        lowers interval arithmetic to DATETIME_PLUS/kDATE_ADD; DateAdd.cpp
        calendar semantics for month/year fields)."""
        if isinstance(e.lhs, A.IntervalLit) and isinstance(
                e.rhs, A.IntervalLit):
            raise SqlError("interval +/- interval is not supported")
        if isinstance(e.lhs, A.IntervalLit):
            if e.op == "-":
                raise SqlError("INTERVAL - datetime is not valid SQL")
            iv, other = e.lhs, e.rhs
        else:
            iv, other = e.rhs, e.lhs
        dt = b(other)
        if not dt.type.is_datetime():
            raise SqlError(
                "INTERVAL arithmetic requires a DATE/TIME/TIMESTAMP operand")
        n = iv.value if e.op == "+" else -iv.value
        field = self._INTERVAL_FIELDS[iv.unit]
        out_t = dt.type
        if isinstance(out_t, t.DateType) and iv.unit in (
                "hour", "minute", "second"):
            out_t = t.timestamp(t.TimeUnit.SECOND, out_t.nullable)
        return ir.DateAddExpr(out_t, field,
                              ir.Constant(t.int64(False), n), dt)

    def _bind_over(self, e: A.Over, b) -> ir.Expr:
        kind = self._WINDOW_KINDS.get(e.fn.name)
        if kind is None:
            raise SqlError(f"unknown window function {e.fn.name!r}")
        raw_args = [a for a in e.fn.args if not isinstance(a, A.Star)]
        arg1 = None
        if kind == ir.WindowKind.NTILE:
            lit = raw_args.pop(0)
            if not (isinstance(lit, A.Lit) and isinstance(lit.value, int)):
                raise SqlError("NTILE needs an integer literal")
            arg1 = lit.value
        if kind in (ir.WindowKind.LAG, ir.WindowKind.LEAD) and len(raw_args) > 1:
            lit = raw_args.pop(1)
            if not (isinstance(lit, A.Lit) and isinstance(lit.value, int)):
                raise SqlError("LAG/LEAD offset must be an integer literal")
            arg1 = lit.value
        if kind == ir.WindowKind.NTH_VALUE:
            if len(raw_args) != 2:
                raise SqlError("NTH_VALUE takes (expr, n)")
            lit = raw_args.pop(1)
            if not (isinstance(lit, A.Lit) and isinstance(lit.value, int)
                    and lit.value >= 1):
                raise SqlError("NTH_VALUE n must be a positive integer "
                               "literal")
            arg1 = lit.value
        args = [b(a) for a in raw_args]
        parts = [b(p) for p in e.partition_by]
        orders = [b(o.expr) for o in e.order_by]
        descs = [o.desc for o in e.order_by]
        at = args[0].type if args else None
        if kind in (ir.WindowKind.ROW_NUMBER, ir.WindowKind.RANK,
                    ir.WindowKind.DENSE_RANK, ir.WindowKind.NTILE):
            out_t = t.int64(False)
        elif kind in (ir.WindowKind.PERCENT_RANK, ir.WindowKind.CUME_DIST,
                      ir.WindowKind.AVG):
            out_t = t.fp64(kind == ir.WindowKind.AVG)
        elif kind == ir.WindowKind.COUNT:
            out_t = t.int64(False)
        elif kind == ir.WindowKind.SUM:
            out_t = (t.int64() if at.is_integer() or at.is_boolean()
                     else at.with_nullable(True))
        else:
            out_t = at.with_nullable(True)
        frame = None
        if e.frame is not None:
            _FRAMELESS = (ir.WindowKind.ROW_NUMBER, ir.WindowKind.RANK,
                          ir.WindowKind.DENSE_RANK, ir.WindowKind.NTILE,
                          ir.WindowKind.PERCENT_RANK, ir.WindowKind.CUME_DIST,
                          ir.WindowKind.LAG, ir.WindowKind.LEAD)
            if kind in _FRAMELESS:
                raise SqlError(
                    f"{e.fn.name.upper()} does not accept a frame clause")
            unit, lo, hi = e.frame
            if unit == "range" and any(
                    k in ("preceding", "following") for k, _ in (lo, hi)):
                if len(orders) != 1:
                    raise SqlError("RANGE frame with offsets requires "
                                   "exactly one ORDER BY key")
                if not (orders[0].type.is_integer() or orders[0].type.is_fp()
                        or orders[0].type.is_datetime()):
                    raise SqlError("RANGE frame offsets need a numeric or "
                                   "datetime ORDER BY key")
            if unit == "rows" and not orders and kind not in (
                    ir.WindowKind.FIRST_VALUE, ir.WindowKind.LAST_VALUE,
                    ir.WindowKind.NTH_VALUE):
                pass  # ROWS without ORDER BY: order is arbitrary but legal
            frame = ir.WindowFrame(unit, lo, hi)
            # frames over a nullable result: value may be absent
            out_t = out_t.with_nullable(True)
            if kind == ir.WindowKind.COUNT:
                out_t = t.int64(False)
        return ir.WindowFunction(out_t, kind, args, parts, orders, descs,
                                 arg1, frame)

    def _bind_case(self, e: A.Case, b) -> ir.Expr:
        branches = []
        if e.operand is not None:
            operand = b(e.operand)
            from ..builder import QueryExpr

            for cond, val in e.branches:
                c = QueryExpr(operand)._bin(ir.BinOpKind.EQ,
                                            QueryExpr(b(cond))).expr
                branches.append((c, b(val)))
        else:
            branches = [(self._as_bool(b(c)), b(v)) for c, v in e.branches]
        else_e = b(e.else_value) if e.else_value is not None else None
        vals = [v for _, v in branches] + ([else_e] if else_e is not None else [])
        out_t = vals[0].type
        for v in vals[1:]:
            out_t = t.common_type(out_t, v.type)
        if out_t.is_string():
            # string-valued CASE: values must share one dictionary's code
            # space (reference: transient string-dict proxy ids)
            out_t, vals2 = self._unify_string_values(vals, out_t.nullable)
            branches = [(c, v) for (c, _), v in zip(branches, vals2[:len(branches)])]
            else_e = vals2[len(branches)] if else_e is not None else None
        if else_e is None:
            else_e = ir.Constant(out_t.with_nullable(True), None)
            out_t = out_t.with_nullable(True)
        branches = [(c, _coerce(v, out_t)) for c, v in branches]
        return ir.CaseExpr(out_t, branches, _coerce(else_e, out_t))

    def _unify_string_values(self, vals: List[ir.Expr], nullable: bool):
        """Bring string-valued exprs into one dictionary code space."""
        target = None
        for v in vals:
            if v.type.is_dict_encoded_string():
                target = v.type  # type: ignore[assignment]
                break
        if target is None:
            d = self.session._dicts.create()
            target = t.dict_text(d.dict_id, nullable)
        dct = self.session._dicts.get(target.dict_id)  # type: ignore[attr-defined]
        out = []
        for v in vals:
            if isinstance(v, ir.Constant) and v.type.is_string():
                if v.value is not None:
                    dct.get_or_add(str(v.value))
                out.append(ir.Constant(target.with_nullable(v.value is None),
                                       v.value))
            elif v.type.is_dict_encoded_string():
                out.append(v if v.type.dict_id == target.dict_id  # type: ignore[attr-defined]
                           else ir.Cast(target, v))
            else:
                raise SqlError("cannot mix strings with non-strings in CASE")
        return target.with_nullable(nullable), out

    def _bind_fn(self, e: A.Fn, b, agg_rewriter, node, scope) -> ir.Expr:
        name = e.name
        if name in _AGG_FNS:
            if agg_rewriter is not None:
                return agg_rewriter(e)
            raise SqlError(f"aggregate {name}() not allowed here")
        if name == "coalesce":
            args = [b(a) for a in e.args]
            out_t = args[0].type
            for a in args[1:]:
                out_t = t.common_type(out_t, a.type)
            result = _coerce(args[-1], out_t)
            for a in reversed(args[:-1]):
                cond = ir.UnOp(t.boolean(False), "isnotnull", a)
                result = ir.CaseExpr(out_t, [(cond, _coerce(a, out_t))], result)
            return result
        if name == "nullif":
            a, c = b(e.args[0]), b(e.args[1])
            from ..builder import QueryExpr

            eq = QueryExpr(a)._bin(ir.BinOpKind.EQ, QueryExpr(c)).expr
            null_c = ir.Constant(a.type.with_nullable(True), None)
            return ir.CaseExpr(a.type.with_nullable(True), [(eq, null_c)], a)
        if name in ("date_trunc", "datetrunc"):
            fld = self._field_arg(e.args[0])
            operand = b(e.args[1])
            return ir.DateTruncExpr(operand.type, fld, operand)
        if name in ("date_add", "timestampadd", "dateadd"):
            fld = self._field_arg(e.args[0])
            n = b(e.args[1])
            d = b(e.args[2])
            return ir.DateAddExpr(d.type, fld, n, d)
        if name in ("date_diff", "datediff", "timestampdiff"):
            fld = self._field_arg(e.args[0])
            a = b(e.args[1])
            c = b(e.args[2])
            return ir.DateDiffExpr(
                t.int64(a.type.nullable or c.type.nullable), fld, a, c)
        if name == "key_for_string":
            return ir.KeyForString(b(e.args[0]))
        if name == "sample_ratio":
            # Deterministic Knuth-hash row sampling predicate
            # (reference: IR/Expr.h:571 SampleRatioExpr,
            # IRCodegen.cpp:202 codegen, RuntimeFunctions.cpp:1472 —
            # hashes the row offset, here the hidden rowid column).
            if len(e.args) != 1:
                raise SqlError("SAMPLE_RATIO takes one argument")
            p = _coerce(b(e.args[0]), t.fp64(False))
            n = node
            while isinstance(n, nd.Filter):
                n = n.inputs[0]
            if not isinstance(n, nd.Scan):
                raise SqlError(
                    "SAMPLE_RATIO requires a physical table scan")
            idx = n.ensure_rowid()
            rowid = node.ref(idx)
            return ir.FunctionCall(t.boolean(p.type.nullable),
                                   "sample_ratio", [p, rowid])
        if name in ("length", "char_length"):
            a = b(e.args[0])
            if not a.type.is_dict_encoded_string():
                raise SqlError(f"{name.upper()} requires a string column")
            return ir.FunctionCall(t.int32(a.type.nullable), "char_length",
                                   [a])
        # registered UDF (udf.py; reference: UdfCompiler.h)
        udfs = getattr(self.session, "_udfs", None)
        udf = udfs.get(name) if udfs is not None else None
        if udf is not None:
            args = [b(a) for a in e.args]
            if len(args) != len(udf.arg_types):
                raise SqlError(
                    f"{name}() takes {len(udf.arg_types)} arguments, "
                    f"got {len(args)}")
            nullable = any(a.type.nullable for a in args)
            out_t = udf.ret_type.with_nullable(
                udf.ret_type.nullable or (udf.null_propagation and nullable))
            return ir.FunctionCall(out_t, name, args)
        # generic scalar builtin
        args = [b(a) for a in e.args]
        out_t = self._fn_type(name, args)
        return ir.FunctionCall(out_t, name, args)

    def _fn_type(self, name: str, args: List[ir.Expr]) -> t.Type:
        nullable = any(a.type.nullable for a in args)
        if name in ("lower", "upper"):
            if not args[0].type.is_dict_encoded_string():
                raise SqlError(f"{name.upper()} requires a string column")
            return args[0].type
        if name == "cardinality":
            if not args[0].type.is_array():
                raise SqlError("CARDINALITY requires an array column")
            return t.int32(args[0].type.nullable)
        if name in ("sign",):
            return t.int32(nullable)
        if name in ("abs", "greatest", "least"):
            return args[0].type
        if name in ("ceil", "ceiling", "floor", "round", "truncate"):
            return args[0].type if args[0].type.is_fp() else t.fp64(nullable)
        if name in ("width_bucket",):
            return t.int32(nullable)
        return t.fp64(nullable)

    def _field_arg(self, a) -> ir.DateTimeField:
        if isinstance(a, A.Lit) and isinstance(a.value, str):
            return ir.DateTimeField(_extract_alias(a.value.lower()))
        if isinstance(a, A.Col):
            return ir.DateTimeField(_extract_alias(a.name.lower()))
        raise SqlError("datetime field must be a name or string literal")

    # ------------------------------------------------------------------
    def _bind_literal(self, e: A.Lit) -> ir.Expr:
        if e.kind == "date":
            days = int(np.datetime64(e.value, "D").astype(np.int64))
            return ir.Constant(t.date32(False), days)
        if e.kind == "timestamp":
            us = int(np.datetime64(e.value).astype("datetime64[us]")
                     .astype(np.int64))
            return ir.Constant(t.timestamp(t.TimeUnit.MICRO, False), us)
        if e.kind == "time":
            h, m, *rest = str(e.value).split(":")
            s = int(rest[0]) if rest else 0
            return ir.Constant(t.time64(t.TimeUnit.SECOND, False),
                               int(h) * 3600 + int(m) * 60 + s)
        if isinstance(e.value, str):
            # string literals live in a session-wide transient dictionary
            # so they can be PROJECTED as dict codes (reference:
            # StringDictionaryProxy transient ids); comparisons against
            # dict columns translate across dictionaries in the scalar
            # compiler
            d = getattr(self.session, "_literal_dict", None)
            if d is None:
                d = self.session._dicts.create()
                self.session._literal_dict = d
            d.get_or_add(e.value)
            return ir.Constant(t.dict_text(d.dict_id, False), e.value)
        from ..builder import _to_expr

        return _to_expr(e.value)

    def _literal_python(self, c: ir.Constant):
        return c.value

    def _as_bool(self, e: ir.Expr) -> ir.Expr:
        if e.type.is_boolean():
            return e
        raise SqlError(f"expected boolean expression, got {e.type}")

    def _contains_agg(self, e) -> bool:
        if isinstance(e, A.Fn) and e.name in _AGG_FNS:
            return True
        return any(self._contains_agg(c) for c in _ast_children(e))

    def _bind_agg(self, e: A.Fn, node, scope: Scope) -> ir.AggExpr:
        from ..builder import QueryExpr

        name = e.name
        if name == "count" and (not e.args or isinstance(e.args[0], A.Star)):
            if e.distinct:
                raise SqlError("COUNT(DISTINCT *) is not valid")
            return ir.AggExpr(t.int64(False), ir.AggKind.COUNT, None)
        args = [self.bind_expr(a, node, scope) for a in e.args
                if not isinstance(a, A.Star)]
        col = QueryExpr(args[0])
        if name == "corr":
            out = col.corr(QueryExpr(args[1])).expr
            assert isinstance(out, ir.AggExpr)
            return out
        extra = None
        if len(args) > 1:
            c = args[1]
            if not isinstance(c, ir.Constant):
                raise SqlError(f"{name} parameter must be a literal")
            extra = float(c.value)
        # DISTINCT is honored for count/sum/avg; it is a no-op for
        # min/max; anything else raises (reference: Calcite validates the
        # DISTINCT qualifier per aggregate)
        if e.distinct and name not in ("count", "sum", "avg", "mean",
                                       "min", "max"):
            raise SqlError(f"DISTINCT is not supported in {name.upper()}()")
        dispatch = {
            "count": lambda: col.count(distinct=e.distinct),
            "sum": lambda: col.sum(distinct=e.distinct),
            "avg": lambda: col.avg(distinct=e.distinct),
            "mean": lambda: col.avg(distinct=e.distinct),
            "min": lambda: col.min(),
            "max": lambda: col.max(),
            "stddev": lambda: col.stddev(),
            "stddev_samp": lambda: col.stddev(),
            "variance": lambda: col.var(),
            "var_samp": lambda: col.var(),
            "approx_count_distinct": lambda: col.approx_count_distinct(),
            "approx_quantile": lambda: col.approx_quantile(
                extra if extra is not None else 0.5),
            "quantile": lambda: col.quantile(extra if extra is not None else 0.5),
            "median": lambda: col.quantile(0.5),
            "sample": lambda: col.sample(),
            "any_value": lambda: col.sample(),
            "single_value": lambda: col.single_value(),
        }
        out = dispatch[name]().expr
        assert isinstance(out, ir.AggExpr)
        return out


def _coerce(e: ir.Expr, typ: t.Type) -> ir.Expr:
    if e.type.with_nullable(typ.nullable) == typ or e.type == typ:
        return e
    return ir.Cast(typ, e)


def _retarget(e: ir.Expr, from_node, to_node) -> ir.Expr:
    if isinstance(e, ir.ColumnRef):
        if e.node is from_node:
            return ir.ColumnRef(e.type, to_node, e.index)
        return e
    ops = [_retarget(o, from_node, to_node) for o in e.operands()]
    return e.rebuild(*ops) if ops else e


def _ast_children(e):
    if isinstance(e, A.Bin):
        return [e.lhs, e.rhs]
    if isinstance(e, A.Un):
        return [e.operand]
    if isinstance(e, A.Fn):
        return [a for a in e.args if not isinstance(a, A.Star)]
    if isinstance(e, A.Case):
        out = []
        if e.operand is not None:
            out.append(e.operand)
        for c, v in e.branches:
            out += [c, v]
        if e.else_value is not None:
            out.append(e.else_value)
        return out
    if isinstance(e, A.CastE):
        return [e.operand]
    if isinstance(e, A.ExtractE):
        return [e.operand]
    if isinstance(e, A.LikeE):
        return [e.operand]
    if isinstance(e, A.InE):
        return [e.operand] + list(e.values)
    if isinstance(e, A.IsNullE):
        return [e.operand]
    if isinstance(e, A.BetweenE):
        return [e.operand, e.lo, e.hi]
    if isinstance(e, A.InSubquery):
        return [e.operand]
    return []


_EXTRACT_ALIASES = {
    "dayofweek": "dow", "dayofyear": "doy", "weekday": "dow",
    "yr": "year", "mon": "month", "d": "day", "h": "hour",
    "min": "minute", "sec": "second", "milliseconds": "millisecond",
    "microseconds": "microsecond", "nanoseconds": "nanosecond",
    "years": "year", "months": "month", "days": "day", "hours": "hour",
    "minutes": "minute", "seconds": "second", "weeks": "week",
    "quarters": "quarter",
}


def _extract_alias(f: str) -> str:
    return _EXTRACT_ALIASES.get(f.lower(), f.lower())


def _dedup(names: List[str]) -> List[str]:
    seen: Dict[str, int] = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out
