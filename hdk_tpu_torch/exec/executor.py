"""Relational executor on torch tensors (counterpart of the single-device
routes of hdk_tpu/exec/executor.py).

A step is a maximal Scan -> Project/Filter chain capped by a terminal
(Aggregate, Sort or the materialized root).  Filters do not compact: they
build a row mask that the terminal consumes (dead rows go to a discard
segment of the group-by, or sort last).  An Aggregate consumed only by a
Sort runs with it as one step.  Steps are cached by structural plan key
(the shared ``codecache``); the cached artifact is the step's Python
closure, since PyTorch runs eagerly and has no ``jit`` to wrap.

Joins, windows, UNION, VALUES and UNNEST are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as t
from ..config import Config
from ..ir import expr as ir
from ..ir import node as nd
from ..utils.logger import get_channel
from . import sort as srt
from .agg_exec import AggExecMixin, _window
from .codecache import CodeCache, chain_key
from .common import (ExecTable, _CHAIN_NODES, _LazyScanColumns, _broadcast,
                     _schema_sig)
from .masked import MaskedCol
from .scalar import ExecError, ScalarCompiler

_LOG = get_channel("exec")

_NOT_PORTED = {
    nd.Join: "joins (ROADMAP A2)",
    nd.LogicalUnion: "UNION (ROADMAP A3)",
    nd.LogicalValues: "VALUES (ROADMAP A3)",
    nd.Unnest: "UNNEST (ROADMAP A3)",
}


class Executor(AggExecMixin):
    """Per-session engine on one torch device."""

    def __init__(self, schema, dicts, config: Config,
                 device: torch.device) -> None:
        self.schema = schema
        self.dicts = dicts
        self.config = config
        self.device = device
        self.scalar = ScalarCompiler(dicts, device)
        self.code_cache = CodeCache()
        # probed perfect layouts keyed by plan, valid while the probed
        # input tensors are alive
        self._probe_cache: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    def execute(self, dag: nd.QueryDag) -> ExecTable:
        from ..utils import logger as hlog

        with hlog.query_context():
            return self._execute_logged(dag)

    def _execute_logged(self, dag: nd.QueryDag) -> ExecTable:
        results: Dict[int, ExecTable] = {}
        order = dag.topo_order()
        t_query = _time.monotonic()
        # agg->sort fusion: a Sort that alone consumes a keyed Aggregate
        # runs with it as one step (no compaction, no group-count sync)
        uses: Dict[int, int] = {}
        for n in order:
            for i in n.inputs:
                uses[i.id] = uses.get(i.id, 0) + 1
        fused_aggs = {
            n.inputs[0].id for n in order
            if (isinstance(n, nd.Sort) and n.sort_fields
                and isinstance(n.inputs[0], nd.Aggregate)
                and uses.get(n.inputs[0].id, 0) == 1
                and n.inputs[0] is not dag.root and n.inputs[0].keys)}
        wd = self.config.exec.watchdog
        deadline = (_time.monotonic() + wd.time_limit_ms / 1e3
                    if wd.enable and wd.time_limit_ms else None)
        for node in order:
            if node.id in fused_aggs and node.id not in results:
                continue  # runs with the consuming Sort
            if isinstance(node, _CHAIN_NODES) and node is not dag.root:
                continue  # fused into the consuming terminal
            if wd.enable:
                for inp in node.inputs:
                    got = results.get(inp.id)
                    if got is not None and got.nrows > wd.max_rows_per_step:
                        raise ExecError(
                            f"watchdog: step input of {got.nrows} rows "
                            f"exceeds budget {wd.max_rows_per_step}")
                if deadline is not None and _time.monotonic() > deadline:
                    raise ExecError("watchdog: query time budget exceeded")
            t0 = _time.monotonic()
            if (isinstance(node, nd.Sort)
                    and node.inputs[0].id in fused_aggs
                    and node.inputs[0].id not in results):
                out = self._exec_fused_agg_sort(node, node.inputs[0], results)
                if out is None:  # empty input: run the parts
                    results[node.inputs[0].id] = self._exec_aggregate(
                        node.inputs[0], results)
                    out = self._exec_step(node, results)
            else:
                out = self._exec_step(node, results)
            results[node.id] = out
            _LOG.debug1("step %s#%d: %d rows, %.1f ms", type(node).__name__,
                        node.id, out.nrows, (_time.monotonic() - t0) * 1e3)
        _LOG.info("query done: %.1f ms, %d rows",
                  (_time.monotonic() - t_query) * 1e3,
                  results[dag.root.id].nrows)
        return results[dag.root.id]

    # ------------------------------------------------------------------
    def _resolve_chain(self, node: nd.Node, results
                       ) -> Tuple[ExecTable, List[nd.Node], nd.Node]:
        """Walk back through Project/Filter to the materialized source.
        Returns (source_table, chain_in_exec_order, source_node)."""
        chain: List[nd.Node] = []
        cur = node
        while isinstance(cur, _CHAIN_NODES) and cur.id not in results:
            chain.append(cur)
            cur = cur.inputs[0]
        chain.reverse()
        return self._source_table(cur, results), chain, cur

    def _source_table(self, node: nd.Node, results) -> ExecTable:
        got = results.get(node.id)
        if got is not None:
            return got
        if isinstance(node, nd.Scan):
            tbl = self._exec_scan(node)
            results[node.id] = tbl
            return tbl
        raise ExecError(f"source node {node!r} has no result")

    def _dict_generation_sig(self, chain: List[nd.Node],
                             terminal: Optional[nd.Node]) -> str:
        """Dictionary sizes of the dictionaries a step reads: host-built
        code tables depend on them, so a grown dictionary keys a new
        step."""
        ids = set()

        def scan_expr(e: ir.Expr):
            if e.type.is_dict_encoded_string():
                ids.add(e.type.dict_id)  # type: ignore[attr-defined]
            for o in e.operands():
                scan_expr(o)

        for n in list(chain) + ([terminal] if terminal is not None else []):
            if isinstance(n, nd.Project):
                exprs = list(n.exprs)
            elif isinstance(n, nd.Filter):
                exprs = [n.condition]
            elif isinstance(n, nd.Aggregate):
                exprs = list(n.keys) + list(n.aggs)
            else:
                exprs = []
            for e in exprs:
                scan_expr(e)
        return ";".join(f"d{i}:{len(self.dicts.get(i))}"
                        for i in sorted(ids))

    def _used_columns(self, src_node: nd.Node, chain: List[nd.Node],
                      terminal_exprs: List[ir.Expr]) -> List[int]:
        """Source column indices the step references, directly or
        through Filter pass-through aliases."""
        aliases = {src_node.id}
        used = set()

        def collect(e: ir.Expr):
            if isinstance(e, ir.ColumnRef) and e.node.id in aliases:
                used.add(e.index)
            for o in e.operands():
                collect(o)

        for n in chain:
            if isinstance(n, nd.Project):
                for e in n.exprs:
                    collect(e)
                aliases.clear()  # a projection rebinds the namespace
                aliases.add(-1)
            else:
                collect(n.condition)
                aliases.add(n.id)
        for e in terminal_exprs:
            collect(e)
        return sorted(used)

    @staticmethod
    def _expand_cols(sub_cols, used: List[int], size: int):
        full = [None] * size
        for pos, i in enumerate(used):
            full[i] = sub_cols[pos]
        return full

    def _chain_env(self, source_node: nd.Node, source_cols,
                   chain: List[nd.Node], row_mask,
                   nrows: Optional[int] = None):
        """Evaluate the Project/Filter chain; returns (env, final_node,
        row_mask)."""
        env: Dict[int, List[MaskedCol]] = {source_node.id: list(source_cols)}
        if nrows is None:
            first = next((c for c in source_cols if c is not None), None)
            nrows = first.data.shape[0] if first is not None else 0
        for n in chain:
            def resolve(ref: ir.ColumnRef) -> MaskedCol:
                cols = env.get(ref.node.id)
                if cols is None:
                    raise ExecError(
                        f"expression references node {ref.node!r} which is "
                        f"not an input of this step")
                return cols[ref.index]

            if isinstance(n, nd.Project):
                env[n.id] = [_broadcast(self.scalar.evaluate(e, resolve),
                                        nrows) for e in n.exprs]
            else:  # Filter
                cond = self.scalar.evaluate(n.condition, resolve)
                m = cond.data.to(torch.bool)
                if cond.mask is not None:
                    m = m & cond.mask
                m = m.expand(nrows)
                row_mask = m if row_mask is None else (row_mask & m)
                env[n.id] = env[n.inputs[0].id]
        return env, (chain[-1] if chain else source_node), row_mask

    # ------------------------------------------------------------------
    def _exec_step(self, node: nd.Node, results) -> ExecTable:
        if isinstance(node, nd.Scan):
            return self._source_table(node, results)
        if isinstance(node, _CHAIN_NODES):
            return self._exec_chain_root(node, results)
        if isinstance(node, nd.Aggregate):
            return self._exec_aggregate(node, results)
        if isinstance(node, nd.Sort):
            return self._exec_sort(node, results)
        for kind, item in _NOT_PORTED.items():
            if isinstance(node, kind):
                raise NotImplementedError(f"{item} is not ported yet")
        raise ExecError(f"cannot execute node {node!r}")

    def _exec_scan(self, node: nd.Scan) -> ExecTable:
        cols = _LazyScanColumns(node.table, list(node.fields), self.device)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         node.table.nrows)

    def _exec_chain_root(self, node: nd.Node, results) -> ExecTable:
        """A bare Project/Filter chain at the root: evaluate it."""
        source, chain, src_node = self._resolve_chain(node, results)
        if source.nrows == 0:
            return ExecTable.empty(node.fields, node.output_types,
                                   self.device)
        has_proj = any(isinstance(n, nd.Project) for n in chain)
        used = (list(range(len(source.fields))) if not has_proj
                else self._used_columns(src_node, chain, []))
        key = chain_key(_schema_sig(source), chain, None,
                        self._dict_generation_sig(chain, None)
                        + f"u{used}/n{source.nrows}")
        nrows = source.nrows
        size = len(source.fields)

        def build():
            def fn(sub_cols, row_mask):
                source_cols = self._expand_cols(sub_cols, used, size)
                env, final, rm = self._chain_env(src_node, source_cols,
                                                 chain, row_mask, nrows=nrows)
                return env[final.id], rm

            return fn

        fn = self.code_cache.get_or_build(key, build)
        cols, rm = fn([source.columns[i] for i in used], source.row_mask)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         source.nrows, rm)

    def _exec_sort(self, node: nd.Sort, results) -> ExecTable:
        source, chain, src_node = self._resolve_chain(node.inputs[0], results)
        if source.nrows == 0 or not node.sort_fields:
            inp = (self._exec_chain_root(node.inputs[0], results)
                   if chain else source).compact()
            if node.limit is not None or node.offset:
                idx = torch.arange(inp.nrows, dtype=torch.int64,
                                   device=self.device)
                return inp.gather(srt.apply_limit(idx, node.limit,
                                                  node.offset))
            return inp
        sort_types = [node.inputs[0].output_types[f.field_index]
                      for f in node.sort_fields]
        has_proj = any(isinstance(n, nd.Project) for n in chain)
        used = (list(range(len(source.fields))) if not has_proj
                else self._used_columns(src_node, chain, []))
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"u{used}/n{source.nrows}")
        nrows0 = source.nrows
        size = len(source.fields)
        limit, offset = node.limit, node.offset
        topn = (offset + limit
                if limit is not None and 0 < offset + limit < nrows0
                else nrows0)

        def build():
            def fn(sub_cols, row_mask):
                source_cols = self._expand_cols(sub_cols, used, size)
                env, final, rm = self._chain_env(src_node, source_cols,
                                                 chain, row_mask,
                                                 nrows=nrows0)
                cols = env[final.id]
                scols = [self._sortable(cols[f.field_index], ty)
                         for f, ty in zip(node.sort_fields, sort_types)]
                skeys = srt.sort_keys_int64(
                    scols, [f.desc for f in node.sort_fields],
                    [f.nulls_first for f in node.sort_fields])
                perm = srt.lex_topn(skeys, topn, rm)
                out = [MaskedCol(c.data[perm],
                                 c.mask[perm] if c.mask is not None else None)
                       for c in cols]
                live = (torch.tensor(nrows0, dtype=torch.int64,
                                     device=self.device)
                        if rm is None else rm.sum())
                return out, _window(live, topn, limit, offset)

            return fn

        fn = self.code_cache.get_or_build(key, build)
        cols, window = fn([source.columns[i] for i in used], source.row_mask)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         topn, window)

    def _sortable(self, col: MaskedCol, typ: t.Type) -> MaskedCol:
        """Dictionary strings order by string, not by code: codes map to
        lexicographic ranks through a host-built table."""
        if not typ.is_dict_encoded_string():
            return col
        strings = self.dicts.get(typ.dict_id).all_strings()  # type: ignore[attr-defined]
        if not strings:
            return col
        order = np.argsort(np.asarray(strings, dtype=object))
        ranks = np.empty(len(strings), np.int32)
        ranks[order] = np.arange(len(strings), dtype=np.int32)
        table = torch.from_numpy(ranks).to(self.device)
        return MaskedCol(
            table[torch.clamp(col.data.to(torch.int64), 0, len(strings) - 1)],
            col.mask)
