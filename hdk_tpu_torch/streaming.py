"""Streaming aggregation: an incremental GROUP BY over pushed batches.

Reference: Executor::prepareStreamingExecution (Execute.cpp:1800-1850)
compiles a work unit once; runOnBatch (:1852) runs one kernel per
arriving fragment; finishStreamExecution reduces the partials.

Here each pushed batch is imported as a table and aggregated into
*decomposed* partial slots (count/sum/sumsq/min/max, the mergeable form
of every algebraic aggregate, SURVEY.md A.2/A.4); the partials fold into
the running partial table by a UNION ALL and a second aggregation, and
``finish()`` applies the finalizing projection (AVG = sum/count, STDDEV
= sqrt((q - n*mean^2)/(n-1)), and so on).  The module is host code over
the session's builder calls; the aggregations run on the session's
device.  The slots and formulas are the JAX package's, so that both
compute the same thing.

Holistic aggregates (COUNT DISTINCT, QUANTILE) are rejected: they are
not mergeable without retaining raw values.  APPROX_COUNT_DISTINCT is
streamable: partials keep the distinct (keys, value) pairs (the operand
column joins the partial grouping grain, so the running state is bounded
by NDV, not row count) and ``finish()`` estimates with the HLL sketch.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from . import types as t
from .builder import QueryExpr, QueryNode
from .ir import expr as ir

_MERGEABLE = {
    ir.AggKind.COUNT, ir.AggKind.SUM, ir.AggKind.MIN, ir.AggKind.MAX,
    ir.AggKind.AVG, ir.AggKind.STDDEV_SAMP, ir.AggKind.VAR_SAMP,
    ir.AggKind.SAMPLE, ir.AggKind.SINGLE_VALUE,
    ir.AggKind.APPROX_COUNT_DISTINCT,
}

_stream_ids = itertools.count(1)


class StreamingAggregation:
    """Incremental GROUP BY over arriving batches."""

    def __init__(self, session, schema: Dict[str, t.Type], keys: List[str],
                 aggs: List[str]) -> None:
        self._sid = next(_stream_ids)
        self._session = session
        self._schema = {
            k: (t.parse_type(v) if isinstance(v, str) else v)
            for k, v in schema.items()
        }
        self._keys = list(keys)
        self._agg_specs = list(aggs)
        self._running = None  # QueryResult of decomposed partials
        self._batch_no = 0
        # validate + capture decomposition using a probe table
        probe = session.create_table(self._tmp("probe"), self._schema)
        parsed = [probe._parse_agg(a) for a in self._agg_specs]
        for qe in parsed:
            assert isinstance(qe.expr, ir.AggExpr)
            if qe.expr.kind not in _MERGEABLE:
                raise ValueError(
                    f"aggregate {qe.expr.kind.value} is not streamable")
        self._agg_names = [qe.out_name or qe.expr.kind.value for qe in parsed]
        self._agg_kinds = [qe.expr.kind for qe in parsed]
        # APPROX_COUNT_DISTINCT state = the distinct (keys, operand)
        # pairs: its operand column joins the partial grouping grain
        self._pair_cols: List[str] = []
        self._acd_args: List[Optional[str]] = []
        for kind, spec in zip(self._agg_kinds, self._agg_specs):
            if kind == ir.AggKind.APPROX_COUNT_DISTINCT:
                arg = spec[spec.index("(") + 1:-1].strip()
                self._acd_args.append(arg)
                if arg not in self._pair_cols and arg not in self._keys:
                    self._pair_cols.append(arg)
            else:
                self._acd_args.append(None)
        session.drop_table(self._tmp("probe"))

    def _tmp(self, suffix: str) -> str:
        return f"__stream_{self._sid}_{suffix}"

    # ------------------------------------------------------------------
    def _decomposed(self, ht: QueryNode, first_level: bool) -> QueryNode:
        """Partial aggregation with mergeable slots.

        first_level: operands are raw columns; otherwise operands are the
        decomposed slot columns being re-merged.
        """
        parts: List[QueryExpr] = []
        for name, kind, spec in zip(self._agg_names, self._agg_kinds,
                                    self._agg_specs):
            col = None
            if first_level:
                arg = spec[spec.index("(") + 1:-1].strip() if "(" in spec else None
                col = ht[arg] if arg else None
            k = kind
            if k == ir.AggKind.COUNT:
                if first_level:
                    e = (col.count() if col is not None
                         else QueryExpr(ir.AggExpr(t.int64(False),
                                                   ir.AggKind.COUNT, None)))
                else:
                    e = ht[f"{name}__c"].sum()
                parts.append(e.name(f"{name}__c"))
            elif k in (ir.AggKind.SUM, ir.AggKind.AVG):
                if first_level:
                    parts.append(col.sum().name(f"{name}__s"))
                    parts.append(col.count().name(f"{name}__n"))
                else:
                    parts.append(ht[f"{name}__s"].sum().name(f"{name}__s"))
                    parts.append(ht[f"{name}__n"].sum().name(f"{name}__n"))
            elif k in (ir.AggKind.STDDEV_SAMP, ir.AggKind.VAR_SAMP):
                if first_level:
                    parts.append(col.sum().name(f"{name}__s"))
                    parts.append((col * col).sum().name(f"{name}__q"))
                    parts.append(col.count().name(f"{name}__n"))
                else:
                    parts.append(ht[f"{name}__s"].sum().name(f"{name}__s"))
                    parts.append(ht[f"{name}__q"].sum().name(f"{name}__q"))
                    parts.append(ht[f"{name}__n"].sum().name(f"{name}__n"))
            elif k in (ir.AggKind.MIN, ir.AggKind.SAMPLE,
                       ir.AggKind.SINGLE_VALUE):
                src = col if first_level else ht[f"{name}__m"]
                parts.append(src.min().name(f"{name}__m"))
            elif k == ir.AggKind.MAX:
                src = col if first_level else ht[f"{name}__m"]
                parts.append(src.max().name(f"{name}__m"))
            # APPROX_COUNT_DISTINCT emits no slot: its operand is part of
            # the partial grouping grain (self._pair_cols)
        return ht.agg(self._keys + self._pair_cols, *parts)

    # ------------------------------------------------------------------
    def push(self, batch: Dict) -> None:
        """Aggregate one arriving batch into the running partials
        (reference: runOnBatch)."""
        s = self._session
        self._batch_no += 1
        bname = self._tmp(f"b{self._batch_no}")
        ht = s.import_pydict(batch, name=bname, schema=self._schema)
        partial = self._decomposed(ht, first_level=True).run()
        if self._running is None:
            self._running = partial
        else:
            old = self._running
            merged = old.scan.union_all(partial.scan)
            self._running = self._decomposed(merged, first_level=False).run()
            for res in (old, partial):  # their scans served this merge
                s.drop_table(res._registered.name)
        s.drop_table(bname)

    # ------------------------------------------------------------------
    def finish(self):
        """Finalize (reference: finishStreamExecution)."""
        if self._running is None:
            raise ValueError("no batches pushed")
        ht = self._running.scan
        if any(k == ir.AggKind.APPROX_COUNT_DISTINCT
               for k in self._agg_kinds):
            # collapse the pair grain to the real keys: algebraic slots
            # re-merge; ACD estimates over the retained distinct pairs
            # with the HLL sketch (ops/sketches.py)
            parts: List[QueryExpr] = []
            for name, kind, arg in zip(self._agg_names, self._agg_kinds,
                                       self._acd_args):
                if kind == ir.AggKind.COUNT:
                    parts.append(ht[f"{name}__c"].sum().name(f"{name}__c"))
                elif kind in (ir.AggKind.SUM, ir.AggKind.AVG):
                    parts.append(ht[f"{name}__s"].sum().name(f"{name}__s"))
                    parts.append(ht[f"{name}__n"].sum().name(f"{name}__n"))
                elif kind in (ir.AggKind.STDDEV_SAMP, ir.AggKind.VAR_SAMP):
                    parts.append(ht[f"{name}__s"].sum().name(f"{name}__s"))
                    parts.append(ht[f"{name}__q"].sum().name(f"{name}__q"))
                    parts.append(ht[f"{name}__n"].sum().name(f"{name}__n"))
                elif kind in (ir.AggKind.MIN, ir.AggKind.SAMPLE,
                              ir.AggKind.SINGLE_VALUE):
                    parts.append(ht[f"{name}__m"].min().name(f"{name}__m"))
                elif kind == ir.AggKind.MAX:
                    parts.append(ht[f"{name}__m"].max().name(f"{name}__m"))
                else:
                    parts.append(ht[arg].approx_count_distinct()
                                 .name(f"{name}__d"))
            ht = ht.agg(self._keys, *parts).run().scan
        outs: List[QueryExpr] = []
        for name, kind in zip(self._agg_names, self._agg_kinds):
            if kind == ir.AggKind.APPROX_COUNT_DISTINCT:
                outs.append(ht[f"{name}__d"].name(name))
            elif kind == ir.AggKind.COUNT:
                outs.append(ht[f"{name}__c"].name(name))
            elif kind == ir.AggKind.SUM:
                # NULL iff no non-null inputs
                e = self._session.if_then_else(
                    ht[f"{name}__n"] > 0, ht[f"{name}__s"],
                    self._session.cst(None, "int64").cast(ht[f"{name}__s"].type))
                outs.append(e.name(name))
            elif kind == ir.AggKind.AVG:
                e = self._session.if_then_else(
                    ht[f"{name}__n"] > 0,
                    ht[f"{name}__s"].cast("fp64") / ht[f"{name}__n"].cast("fp64"),
                    self._session.cst(None, "fp64"))
                outs.append(e.name(name))
            elif kind in (ir.AggKind.STDDEV_SAMP, ir.AggKind.VAR_SAMP):
                n = ht[f"{name}__n"].cast("fp64")
                s_ = ht[f"{name}__s"].cast("fp64")
                q = ht[f"{name}__q"].cast("fp64")
                mean = s_ / n
                var = (q - n * mean * mean) / (n - 1.0)
                if kind == ir.AggKind.STDDEV_SAMP:
                    var = QueryExpr(ir.FunctionCall(t.fp64(), "sqrt", [var.expr]))
                outs.append(self._session.if_then_else(
                    ht[f"{name}__n"] > 1, var,
                    self._session.cst(None, "fp64")).name(name))
            else:  # MIN/MAX/SAMPLE/SINGLE_VALUE
                outs.append(ht[f"{name}__m"].name(name))
        return ht.proj(*self._keys, *outs).run()
