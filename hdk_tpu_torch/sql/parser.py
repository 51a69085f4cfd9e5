"""Recursive-descent SQL parser -> sql.ast.

Grammar: the working subset of the reference's Calcite surface
exercised by its tests/benchmarks (SELECT/DISTINCT, FROM with aliases
and subqueries, INNER/LEFT/SEMI/ANTI JOIN ... ON, WHERE, GROUP BY
(exprs, positions, aliases), HAVING, ORDER BY (+ NULLS FIRST/LAST),
LIMIT/OFFSET, UNION ALL, CASE (searched+simple), CAST, EXTRACT,
[NOT] LIKE/ILIKE/REGEXP, [NOT] IN (list), BETWEEN, IS [NOT] NULL,
date/time/timestamp literals, WITH common table expressions).
"""

from __future__ import annotations

from typing import List, Optional

from . import ast as A
from .lexer import SqlError, Token, tokenize


class Parser:
    def __init__(self, sql: str) -> None:
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def accept_kw(self, *kws: str) -> Optional[Token]:
        if self.cur.is_kw(*kws):
            return self.advance()
        return None

    def accept_op(self, *ops: str) -> Optional[Token]:
        if self.cur.is_op(*ops):
            return self.advance()
        return None

    def expect_kw(self, *kws: str) -> Token:
        tok = self.accept_kw(*kws)
        if tok is None:
            raise SqlError(f"expected {'/'.join(kws).upper()}, got "
                           f"{self.cur.value!r}", self.sql, self.cur.pos)
        return tok

    def expect_op(self, op: str) -> Token:
        tok = self.accept_op(op)
        if tok is None:
            raise SqlError(f"expected {op!r}, got {self.cur.value!r}",
                           self.sql, self.cur.pos)
        return tok

    def expect_ident(self) -> str:
        if self.cur.kind == "ident":
            return self.advance().value
        # unreserved keywords usable as identifiers
        if self.cur.kind == "kw" and self.cur.value in (
                "date", "time", "timestamp", "count", "first", "last"):
            return self.advance().value
        raise SqlError(f"expected identifier, got {self.cur.value!r}",
                       self.sql, self.cur.pos)

    # -- entry --------------------------------------------------------------
    def parse(self) -> A.Query:
        self.ctes = {}
        if self.accept_kw("with"):
            while True:
                name = self.expect_ident()
                self.expect_kw("as")
                self.expect_op("(")
                self.ctes[name.lower()] = self.parse_query()
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        q = self.parse_query()
        self.accept_op(";")
        if self.cur.kind != "eof":
            raise SqlError(f"unexpected trailing input {self.cur.value!r}",
                           self.sql, self.cur.pos)
        return q

    def parse_query(self) -> A.Query:
        selects = [self.parse_select()]
        set_ops: List[str] = []
        while True:
            if self.cur.is_kw("union"):
                self.advance()
                set_ops.append("union_all" if self.accept_kw("all")
                               else "union")
            elif self.cur.is_kw("except", "intersect"):
                op = self.advance().value.lower()
                if self.accept_kw("all"):
                    raise SqlError(f"{op.upper()} ALL is not supported "
                                   "(set semantics only)", self.sql,
                                   self.cur.pos)
                set_ops.append(op)
            else:
                break
            selects.append(self.parse_select())
        q = A.Query(selects, set_ops=set_ops)
        # trailing ORDER BY/LIMIT after a union applies to the whole union
        if len(selects) > 1:
            last = selects[-1]
            q.order_by, last.order_by = last.order_by, []
            q.limit, last.limit = last.limit, None
            q.offset, last.offset = last.offset, 0
        return q

    # -- select -------------------------------------------------------------
    def parse_select(self) -> A.SelectStmt:
        self.expect_kw("select")
        stmt = A.SelectStmt(items=[])
        stmt.distinct = bool(self.accept_kw("distinct"))
        self.accept_kw("all")
        while True:
            stmt.items.append(self.parse_select_item())
            if not self.accept_op(","):
                break
        if self.accept_kw("from"):
            stmt.from_table = self.parse_table_ref()
            while True:
                join = self.parse_join_opt()
                if join is None:
                    break
                stmt.joins.append(join)
        if self.accept_kw("where"):
            stmt.where = self.parse_expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            low = (self.cur.value.lower()
                   if self.cur.kind == "ident" else None)
            if low in ("rollup", "cube"):
                self.advance()
                self.expect_op("(")
                keys = [self.parse_expr()]
                while self.accept_op(","):
                    keys.append(self.parse_expr())
                self.expect_op(")")
                stmt.group_by = list(keys)
                if low == "rollup":
                    # (a,b,c) -> [(a,b,c), (a,b), (a), ()]
                    stmt.group_sets = [keys[:i]
                                       for i in range(len(keys), -1, -1)]
                else:  # cube: every subset
                    stmt.group_sets = [
                        [k for j, k in enumerate(keys) if (m >> j) & 1]
                        for m in range((1 << len(keys)) - 1, -1, -1)]
            elif low == "grouping" and \
                    self.toks[self.i + 1].value.lower() == "sets":
                self.advance()
                self.advance()
                self.expect_op("(")
                sets = []
                while True:
                    self.expect_op("(")
                    gs = []
                    if not self.accept_op(")"):
                        gs.append(self.parse_expr())
                        while self.accept_op(","):
                            gs.append(self.parse_expr())
                        self.expect_op(")")
                    sets.append(gs)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                seen = []
                for gs in sets:  # keys union, first-seen order
                    for k in gs:
                        if repr(k) not in [repr(s) for s in seen]:
                            seen.append(k)
                stmt.group_by = seen
                stmt.group_sets = sets
            else:
                while True:
                    stmt.group_by.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
        if self.accept_kw("having"):
            stmt.having = self.parse_expr()
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                item = A.OrderItem(self.parse_expr())
                if self.accept_kw("asc"):
                    pass
                elif self.accept_kw("desc"):
                    item.desc = True
                if self.accept_kw("nulls"):
                    item.nulls_first = bool(self.expect_kw("first", "last").value == "first")
                stmt.order_by.append(item)
                if not self.accept_op(","):
                    break
        if self.accept_kw("limit"):
            stmt.limit = int(self.advance().value)
        if self.accept_kw("offset"):
            stmt.offset = int(self.advance().value)
        return stmt

    def parse_select_item(self) -> A.SelectItem:
        if self.cur.is_op("*"):
            self.advance()
            return A.SelectItem(A.Star())
        # qualified star: t.*
        if (self.cur.kind == "ident" and self.toks[self.i + 1].is_op(".")
                and self.toks[self.i + 2].is_op("*")):
            table = self.advance().value
            self.advance()
            self.advance()
            return A.SelectItem(A.Star(table))
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.cur.kind == "ident":
            alias = self.advance().value
        return A.SelectItem(expr, alias)

    def parse_table_ref(self) -> A.TableRef:
        if self.accept_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_ident()
            elif self.cur.kind == "ident":
                alias = self.advance().value
            return A.TableRef(alias=alias, subquery=sub)
        name = self.expect_ident()
        if name.lower() == "unnest" and self.accept_op("("):
            first = self.expect_ident()
            tbl, col = None, first
            if self.accept_op("."):
                tbl, col = first, self.expect_ident()
            self.expect_op(")")
            ref = A.TableRef(unnest=(tbl, col))
            if self.accept_kw("as"):
                ref.alias = self.expect_ident()
            elif self.cur.kind == "ident":
                ref.alias = self.advance().value
            return ref
        ref = A.TableRef(name=name)
        if self.accept_kw("as"):
            ref.alias = self.expect_ident()
        elif self.cur.kind == "ident":
            ref.alias = self.advance().value
        return ref

    def parse_join_opt(self) -> Optional[A.JoinClause]:
        kind = None
        save = self.i
        if self.accept_kw("join"):
            kind = "inner"
        elif self.accept_kw("inner"):
            self.expect_kw("join")
            kind = "inner"
        elif self.accept_kw("left"):
            self.accept_kw("outer")
            self.expect_kw("join")
            kind = "left"
        elif self.accept_kw("right"):
            self.accept_kw("outer")
            self.expect_kw("join")
            kind = "right"
        elif self.accept_kw("full"):
            self.accept_kw("outer")
            self.expect_kw("join")
            kind = "full"
        elif self.accept_kw("semi"):
            self.expect_kw("join")
            kind = "semi"
        elif self.accept_kw("anti"):
            self.expect_kw("join")
            kind = "anti"
        elif self.accept_kw("cross"):
            self.expect_kw("join")
            ref = self.parse_table_ref()
            return A.JoinClause("cross", ref, None)
        elif self.accept_op(","):  # implicit cross join via comma + WHERE
            ref = self.parse_table_ref()
            return A.JoinClause("cross", ref, None)
        if kind is None:
            self.i = save
            return None
        ref = self.parse_table_ref()
        on = None
        if self.accept_kw("on"):
            on = self.parse_expr()
        return A.JoinClause(kind, ref, on)

    # -- expressions (precedence climbing) ----------------------------------
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        lhs = self.parse_and()
        while self.accept_kw("or"):
            lhs = A.Bin("or", lhs, self.parse_and())
        return lhs

    def parse_and(self):
        lhs = self.parse_not()
        while self.accept_kw("and"):
            lhs = A.Bin("and", lhs, self.parse_not())
        return lhs

    def parse_not(self):
        if self.accept_kw("not"):
            return A.Un("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self):
        lhs = self.parse_additive()
        while True:
            negated = False
            save = self.i
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("like"):
                pat = self.parse_additive()
                esc = None
                if self.cur.kind == "ident" and self.cur.value.lower() == "escape":
                    self.advance()
                    esc = self.advance().value
                lhs = A.LikeE(lhs, pat, esc, False, False, negated)
                continue
            if self.accept_kw("ilike"):
                lhs = A.LikeE(lhs, self.parse_additive(), None, True, False, negated)
                continue
            if self.accept_kw("regexp"):
                lhs = A.LikeE(lhs, self.parse_additive(), None, False, True, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.cur.is_kw("select", "with"):
                    sub = self.parse_query()
                    self.expect_op(")")
                    lhs = A.InSubquery(lhs, sub, negated)
                    continue
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                lhs = A.InE(lhs, vals, negated)
                continue
            if self.accept_kw("between"):
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                lhs = A.BetweenE(lhs, lo, hi, negated)
                continue
            if negated:
                self.i = save
                break
            if self.accept_kw("is"):
                neg2 = bool(self.accept_kw("not"))
                self.expect_kw("null")
                lhs = A.IsNullE(lhs, neg2)
                continue
            op = None
            for cand in ("=", "<>", "!=", "<=", ">=", "<", ">"):
                if self.accept_op(cand):
                    op = cand
                    break
            if op is None:
                break
            rhs = self.parse_additive()
            lhs = A.Bin({"=": "==", "<>": "!=", "!=": "!="}.get(op, op), lhs, rhs)
        return lhs

    def parse_additive(self):
        lhs = self.parse_multiplicative()
        while True:
            if self.accept_op("+"):
                lhs = A.Bin("+", lhs, self.parse_multiplicative())
            elif self.accept_op("-"):
                lhs = A.Bin("-", lhs, self.parse_multiplicative())
            elif self.accept_op("||"):
                lhs = A.Fn("concat", [lhs, self.parse_multiplicative()])
            else:
                return lhs

    def parse_multiplicative(self):
        lhs = self.parse_unary()
        while True:
            if self.accept_op("*"):
                lhs = A.Bin("*", lhs, self.parse_unary())
            elif self.accept_op("/"):
                lhs = A.Bin("/", lhs, self.parse_unary())
            elif self.accept_op("%"):
                lhs = A.Bin("%", lhs, self.parse_unary())
            else:
                return lhs

    def parse_unary(self):
        if self.accept_op("-"):
            operand = self.parse_unary()
            if isinstance(operand, A.Lit) and isinstance(operand.value, (int, float)):
                return A.Lit(-operand.value)
            return A.Un("neg", operand)
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        tok = self.cur
        if tok.kind == "number":
            self.advance()
            text = tok.value
            if "." in text or "e" in text or "E" in text:
                return A.Lit(float(text))
            return A.Lit(int(text))
        if tok.kind == "string":
            self.advance()
            return A.Lit(tok.value)
        if tok.is_kw("true"):
            self.advance()
            return A.Lit(True)
        if tok.is_kw("false"):
            self.advance()
            return A.Lit(False)
        if tok.is_kw("null"):
            self.advance()
            return A.Lit(None)
        if tok.is_kw("date", "time", "timestamp") and \
                self.toks[self.i + 1].kind == "string":
            self.advance()
            lit = self.advance()
            return A.Lit(lit.value, kind=tok.value)
        if tok.is_kw("interval"):
            self.advance()
            vt = self.advance()
            if vt.kind in ("string", "number"):
                try:
                    val = int(str(vt.value))
                except ValueError:
                    raise SqlError("INTERVAL value must be an integer",
                                   self.sql, vt.pos)
            else:
                raise SqlError("expected INTERVAL '<n>' <unit>",
                               self.sql, vt.pos)
            ut = self.advance()
            unit = str(ut.value).lower().rstrip("s")  # DAYS -> day
            if unit not in ("year", "quarter", "month", "week", "day",
                            "hour", "minute", "second"):
                raise SqlError(f"unknown INTERVAL unit {ut.value!r}",
                               self.sql, ut.pos)
            return A.IntervalLit(val, unit)
        if tok.is_kw("exists"):
            self.advance()
            self.expect_op("(")
            sub = self.parse_query()
            self.expect_op(")")
            return A.ExistsE(sub)
        if tok.is_kw("case"):
            return self.parse_case()
        if tok.is_kw("cast"):
            self.advance()
            self.expect_op("(")
            operand = self.parse_expr()
            self.expect_kw("as")
            parts = [self.expect_ident()]
            # type may have args: decimal(10, 2)
            if self.accept_op("("):
                args = [self.advance().value]
                while self.accept_op(","):
                    args.append(self.advance().value)
                self.expect_op(")")
                parts.append("(" + ",".join(args) + ")")
            self.expect_op(")")
            return A.CastE(operand, "".join(parts))
        if tok.is_kw("extract"):
            self.advance()
            self.expect_op("(")
            fld = self.expect_ident() if self.cur.kind == "ident" else self.advance().value
            self.expect_kw("from")
            operand = self.parse_expr()
            self.expect_op(")")
            return A.ExtractE(fld.lower(), operand)
        if tok.is_kw("count") or tok.kind == "ident":
            # function call or column reference
            name = self.advance().value
            if self.accept_op("("):
                distinct = bool(self.accept_kw("distinct"))
                args: List[object] = []
                if self.cur.is_op("*"):
                    self.advance()
                    args.append(A.Star())
                elif not self.cur.is_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                fn = A.Fn(name.lower(), args, distinct)
                if self.cur.kind == "ident" and self.cur.value.lower() == "over":
                    self.advance()
                    return self.parse_over(fn)
                return fn
            if self.accept_op("."):
                col = self.expect_ident()
                return A.Col(col, table=name)
            return A.Col(name)
        if tok.is_op("("):
            self.advance()
            if self.cur.is_kw("select", "with"):
                sub = self.parse_query()
                self.expect_op(")")
                return A.ScalarSub(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        raise SqlError(f"unexpected token {tok.value!r}", self.sql, tok.pos)

    def parse_over(self, fn: A.Fn) -> A.Over:
        self.expect_op("(")
        partition = []
        order: List[A.OrderItem] = []
        if self.cur.kind == "ident" and self.cur.value.lower() == "partition":
            self.advance()
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                item = A.OrderItem(self.parse_expr())
                if self.accept_kw("desc"):
                    item.desc = True
                else:
                    self.accept_kw("asc")
                if self.accept_kw("nulls"):
                    item.nulls_first = self.expect_kw("first", "last").value == "first"
                order.append(item)
                if not self.accept_op(","):
                    break
        frame = None
        unit = None
        if self.cur.kind == "ident" and self.cur.value.lower() in ("rows",
                                                                   "range"):
            unit = self.advance().value.lower()
        if unit is not None:
            def bound():
                if self.cur.kind == "ident" and \
                        self.cur.value.lower() == "unbounded":
                    self.advance()
                    word = self.advance().value.lower()
                    if word not in ("preceding", "following"):
                        raise SqlError("expected PRECEDING/FOLLOWING",
                                       self.sql, self.cur.pos)
                    return (f"unbounded_{word}", None)
                if self.cur.is_kw("current") or (
                        self.cur.kind == "ident"
                        and self.cur.value.lower() == "current"):
                    self.advance()
                    row = self.advance().value.lower()
                    if row != "row":
                        raise SqlError("expected CURRENT ROW",
                                       self.sql, self.cur.pos)
                    return ("current_row", None)
                v = self.parse_expr()
                if not isinstance(v, A.Lit):
                    raise SqlError("frame offset must be a literal",
                                   self.sql, self.cur.pos)
                word = self.advance().value.lower()
                if word not in ("preceding", "following"):
                    raise SqlError("expected PRECEDING/FOLLOWING",
                                   self.sql, self.cur.pos)
                return (word, v.value)

            if self.accept_kw("between"):
                lo = bound()
                self.expect_kw("and")
                hi = bound()
            else:
                lo = bound()
                hi = ("current_row", None)
            frame = (unit, lo, hi)
        self.expect_op(")")
        return A.Over(fn, partition, order, frame)

    def parse_case(self):
        self.expect_kw("case")
        operand = None
        if not self.cur.is_kw("when"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            branches.append((cond, val))
        else_value = None
        if self.accept_kw("else"):
            else_value = self.parse_expr()
        self.expect_kw("end")
        return A.Case(branches, else_value, operand)


def parse(sql: str) -> A.Query:
    p = Parser(sql)
    q = p.parse()
    q.ctes = getattr(p, "ctes", {})  # type: ignore[attr-defined]
    return q
