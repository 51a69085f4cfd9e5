"""Relational executor on torch tensors (counterpart of the single-device
routes of hdk_tpu/exec/executor.py).

A step is a maximal Scan -> Project/Filter chain capped by a terminal
(Aggregate, Sort, Join, UNION ALL or the materialized root).  Filters do
not compact: they build a row mask that the terminal consumes (dead rows
go to a discard segment of the group-by, sort last, become NULL join
keys, ride the union's row mask, or sort past the live rows of a window
function, which reads the row mask of the Filters before its Project).
An Aggregate consumed only by a Sort runs with it as one step.  Steps are
cached by structural plan key (the shared ``codecache``); the cached
artifact is the step's Python closure, since PyTorch runs eagerly and has
no ``jit`` to wrap.  Joins run in ``join_exec.py``, window functions in
``window.py``.

Array columns are 2-D (rows x width) with a same-shaped element mask;
they ride sorts, joins and unions as rows of their tensors, and UNNEST
turns them into rows x width element rows, the absent ones dead.

Controls around a step, as in the JAX package: fragment skipping (a
chain's Filters bound scan columns whose fragment stats exclude
fragments; only the survivors reach the device), fragment-streamed
aggregation (``agg_exec.py``), the watchdog's row budget and deadline,
measured route feedback (``feedback.py``), EXPLAIN ANALYZE
(``_analyze``: every step ends in a device synchronize and records its
time and rows in ``_step_times``), and the skip of a join's build
subtree whose build tables are recycled (``_plan_recycle_skips``).  Each
query first computes every node's demanded output columns
(``common._column_demand``), which the spread join reads.
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
from ..utils.timer import DebugTimer
from . import sort as srt
from .agg_exec import AggExecMixin, _window
from .codecache import CodeCache, chain_key
from .dist_exec import DistExecMixin
from .common import (ExecTable, _CHAIN_NODES, _IdentityKeyedCache,
                     _LazyScanColumns,
                     _PlanArtifactCache, _PrunedScanColumns, _broadcast,
                     _column_demand, _consumer_kinds, _schema_sig)
from .explain import _node_line
from .feedback import PlanChoiceFeedback, RouteFeedback, synchronize
from .join_exec import JoinExecMixin
from .masked import MaskedCol, from_numpy, torch_dtype
from .scalar import ExecError, ScalarCompiler

_LOG = get_channel("exec")


class Executor(AggExecMixin, JoinExecMixin, DistExecMixin):
    """Per-session engine on one torch device, or on a mesh of shards
    (``dist.enable``: ``dist_exec.py``)."""

    def __init__(self, schema, dicts, config: Config,
                 device: torch.device, udfs=None) -> None:
        self.schema = schema
        self.dicts = dicts
        self.config = config
        self.device = device
        self.udfs = udfs  # UdfRegistry (udf.py) or None
        self.scalar = ScalarCompiler(dicts, device, udfs=udfs)
        self.code_cache = CodeCache()
        # probed perfect layouts keyed by plan, valid while the probed
        # input tensors are alive
        self._probe_cache: Dict[str, tuple] = {}
        # the last group-by's NDV estimate, attempts (widen-retry) and
        # final sort-route buffer cap
        self._ndv_estimate: Optional[int] = None
        self._groupby_attempts = 0
        self._groupby_cap = 0
        # join build tables keyed by (plan, build key tensors), then by the
        # build subtree's data-plan signature
        self._hashtable_cache = _IdentityKeyedCache(
            256, byte_budget=config.cache.hashtable_cache_size,
            enabled=config.cache.enable_hashtable_cache)
        self._ht_plan_cache = _PlanArtifactCache(
            256, byte_budget=config.cache.hashtable_cache_size,
            enabled=config.cache.enable_hashtable_cache)
        self._join_route: Optional[str] = None  # the last equi-join's route
        self._join_builds = 0  # join build and value tables made
        # per query: each join whose build subtree is skipped (its
        # recycled build-side metadata by join id), and the skipped nodes
        self._join_skip_rhs: Dict[int, tuple] = {}
        self._recycled_nodes: set = set()
        # per query: each node's demanded output columns (None: all), its
        # consumer kinds and its direct consumers
        self._demand: Optional[Dict[int, Optional[set]]] = None
        self._consumers: Optional[Dict[int, List[str]]] = None
        self._direct_consumers: Optional[Dict[int, list]] = None
        # EXPLAIN ANALYZE: force and time every step; a step's (ms, rows)
        # by node id, and each node that ran inside a step (its step's
        # kind, ms, live rows) by node id; during a step, the live rows
        # of those nodes by plan line
        self._analyze = False
        self._step_times: Dict[int, Tuple[float, int]] = {}
        self._fused_rows: Dict[str, object] = {}
        self._fused_times: Dict[int, Tuple[str, float, int]] = {}
        # host seconds spent in sampling estimators (the NDV sample)
        self._ndv_sample_seconds = 0.0
        # measured route tuning and the plan-variant A/B (feedback.py)
        self._feedback = RouteFeedback(
            enabled=config.exec.enable_route_feedback)
        self._plan_feedback = PlanChoiceFeedback(self._feedback)
        # the last query's fragment skipping {selected, total} and
        # fragment-stream chunk count (None: it did not prune / stream)
        self._frag_prune_stats: Optional[Dict[str, int]] = None
        self._frag_stream_chunks: Optional[int] = None
        self._deadline: Optional[float] = None  # the watchdog's
        # dist sessions: the mesh (None: one device), and the last
        # distributed GROUP BY, window, join and sort routes and the
        # retries of the last shuffling GROUP BY or sort
        self._dist_agg_route: Optional[str] = None
        self._dist_window_route: Optional[str] = None
        self._dist_join_route: Optional[str] = None
        self._dist_sort_route: Optional[str] = None
        # the last ORDER BY's route: "streaming" (sort.lex_topn) or "full"
        self._topn_route: Optional[str] = None
        self._dist_retries = 0
        self._mesh = None
        if config.dist.enable:
            from ..parallel import mesh as pmesh

            if config.dist.multi_host:
                # join the multi-controller job first, so the mesh spans
                # every rank (parallel/mesh.py)
                pmesh.init_distributed(
                    coordinator_address=config.dist.coordinator_address
                    or None,
                    num_processes=config.dist.num_processes or None,
                    process_id=(config.dist.process_id
                                if config.dist.process_id >= 0 else None),
                    device=device, timeout_s=config.dist.timeout_s)
            n = config.dist.num_devices or pmesh.default_shards(device)
            if n > 1:
                self._mesh = pmesh.make_mesh(n, device)

    # ------------------------------------------------------------------
    def execute(self, dag: nd.QueryDag) -> ExecTable:
        from ..utils import logger as hlog

        with hlog.query_context():
            return self._execute_logged(dag)

    def _execute_logged(self, dag: nd.QueryDag) -> ExecTable:
        results: Dict[int, ExecTable] = {}
        order = dag.topo_order()
        self._demand = _column_demand(order, dag.root)
        self._consumers = _consumer_kinds(order, dag.root)
        self._frag_prune_stats = None
        self._frag_stream_chunks = None
        self._direct_consumers = {}
        for n_ in order:
            for pos_, i_ in enumerate(n_.inputs):
                self._direct_consumers.setdefault(i_.id, []).append(
                    (n_, pos_))
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
        self._deadline = deadline
        skip_nodes = self._plan_recycle_skips(order)
        for node in order:
            if node.id in skip_nodes:
                continue  # a build subtree the recycled artifacts cover
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
            with DebugTimer(f"step:{type(node).__name__}#{node.id}"):
                t0 = _time.monotonic()
                self._fused_rows = {}
                if (isinstance(node, nd.Sort)
                        and node.inputs[0].id in fused_aggs
                        and node.inputs[0].id not in results):
                    out = self._exec_fused_agg_sort(node, node.inputs[0],
                                                    results)
                    if out is None:  # empty or streamed input: the parts
                        agg = node.inputs[0]
                        results[agg.id] = self._exec_aggregate(agg, results)
                        if self._analyze:
                            self._record_step(agg, results[agg.id], t0)
                            t0 = _time.monotonic()
                        out = self._exec_step(node, results)
                else:
                    out = self._exec_step(node, results)
                results[node.id] = out
                if self._analyze:
                    self._record_step(node, out, t0)
            _LOG.debug1("step %s#%d: %d rows, %.1f ms%s%s",
                        type(node).__name__, node.id, out.nrows,
                        (_time.monotonic() - t0) * 1e3,
                        f" route={self._dist_agg_route}"
                        if self._dist_agg_route
                        and isinstance(node, nd.Aggregate) else "",
                        " frags={selected}/{total}".format(
                            **self._frag_prune_stats)
                        if self._frag_prune_stats else "")
        _LOG.info("query done: %.1f ms, %d rows",
                  (_time.monotonic() - t_query) * 1e3,
                  results[dag.root.id].nrows)
        return results[dag.root.id]

    def _plan_recycle_skips(self, order) -> set:
        """The nodes of build subtrees that need not run: for each
        equi-join (no residual) whose plan-keyed artifacts cover its build
        side (``_join_plan_ready``), the nodes consumed only by its build
        input or by nodes already taken, scans left out (a scan moves no
        data itself).  The join then reads a stub of its build side
        (``_join_skip_rhs``).  A build side that is a bare scan skips
        nothing."""
        self._join_skip_rhs = {}
        skip: set = set()
        self._recycled_nodes = skip
        if self._mesh is not None:
            return skip
        for n in order:
            if (not isinstance(n, nd.Join) or not n.key_pairs
                    or n.residual is not None):
                continue
            bp = self._join_build_plan_sig(n)
            if bp is None or not self._join_plan_ready(n, bp):
                continue
            included: set = set()

            def take(m: nd.Node) -> None:
                if m.id in included or isinstance(m, nd.Scan):
                    return
                cons = self._direct_consumers.get(m.id, [])
                if cons and all((c is n and pos == 1) or c.id in included
                                for c, pos in cons):
                    included.add(m.id)
                    for i in m.inputs:
                        take(i)

            take(n.inputs[1])
            if not included:
                continue
            self._join_skip_rhs[n.id] = self._ht_plan_cache.get((bp, "meta"))
            skip |= included
            _LOG.debug1("join #%d: recycled build artifacts, %d build-side "
                        "node(s) skipped", n.id, len(included))
        self._recycled_nodes = skip
        return skip

    def _record_step(self, node: nd.Node, out: ExecTable,
                     t0: float) -> None:
        """EXPLAIN ANALYZE: force the step's output (the lazy join
        columns its consumers demand, queued device work), then record its
        time and rows, and those of the Project/Filter nodes fused into
        it."""
        self._force_table_demanded(out, (self._demand or {}).get(node.id))
        ms = (_time.monotonic() - t0) * 1e3
        self._step_times[node.id] = (ms, out.nrows)
        # the nodes below this step down to the steps it read; a cached
        # step closure holds the nodes of the query that built it, so its
        # rows are keyed by plan line, not by node
        stack = list(node.inputs)
        while stack:
            n = stack.pop()
            if n.id in self._step_times:
                continue
            rows = self._fused_rows.get(_node_line(n))
            if rows is not None:
                self._fused_times[n.id] = (type(node).__name__, ms,
                                           int(rows))
            stack.extend(n.inputs)
        self._fused_rows = {}

    def _force_table(self, table: ExecTable) -> None:
        """Compute every lazy column of a table and wait for the device.
        Scan columns not read yet stay on the host: a scan moves no data
        itself, its consumers copy what they read."""
        self._force_table_demanded(table, None)

    # ------------------------------------------------------------------
    def _resolve_chain(self, node: nd.Node, results
                       ) -> Tuple[ExecTable, List[nd.Node], nd.Node]:
        """Walk back through Project/Filter to the materialized source.
        Returns (source_table, chain_in_exec_order, source_node); a scan
        source is cut to the fragments the chain's Filters can match."""
        chain: List[nd.Node] = []
        cur = node
        while isinstance(cur, _CHAIN_NODES) and cur.id not in results:
            chain.append(cur)
            cur = cur.inputs[0]
        chain.reverse()
        source = self._source_table(cur, results)
        pruned = self._maybe_prune_scan(cur, chain, results)
        return (pruned if pruned is not None else source), chain, cur

    def _maybe_prune_scan(self, src_node: nd.Node, chain: List[nd.Node],
                          results) -> Optional[ExecTable]:
        """Fragment skipping: when the chain's Filters bound scan columns
        whose fragment min/max stats exclude fragments, the source is the
        surviving fragments' rows.  None when no pruning applies."""
        from . import prune

        if (not self.config.exec.enable_fragment_skipping
                or not isinstance(src_node, nd.Scan)
                or getattr(src_node.table, "process_local", False)):
            return None
        got = results.get(src_node.id)
        if got is not None and not isinstance(got.columns, _LazyScanColumns):
            return None
        table = src_node.table
        if table.nrows == 0 or len(table.fragments) < 2:
            return None
        if not any(isinstance(n, nd.Filter) for n in chain):
            return None
        bounds = prune.column_bounds(chain, src_node)
        if not bounds:
            return None
        sel = prune.select_fragments(table, list(src_node.fields), bounds)
        if sel is None or len(sel) == len(table.fragments):
            return None
        self._frag_prune_stats = {"selected": len(sel),
                                  "total": len(table.fragments)}
        fields = list(src_node.fields)
        types = list(src_node.output_types)
        nsel = sum(e - s for s, e in sel)
        if nsel == 0:
            return ExecTable.empty(fields, types, self.device)
        return ExecTable(fields, types,
                         _PrunedScanColumns(table, fields, sel, self.device),
                         nsel)

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
        step.  A step that calls a UDF also keys on the registry's
        generation, so re-registering a name builds a new step around the
        new body; other steps keep theirs."""
        ids = set()
        uses_udf = False

        def scan_expr(e: ir.Expr):
            nonlocal uses_udf
            if e.type.is_dict_encoded_string():
                ids.add(e.type.dict_id)  # type: ignore[attr-defined]
            if (isinstance(e, ir.FunctionCall) and self.udfs is not None
                    and self.udfs.get(e.name) is not None):
                uses_udf = True
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
        udf_sig = f"/u{self.udfs.generation}" if uses_udf else ""
        return ";".join(f"d{i}:{len(self.dicts.get(i))}"
                        for i in sorted(ids)) + udf_sig

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
                   nrows: Optional[int] = None, window_override=None):
        """Evaluate the Project/Filter chain; returns (env, final_node,
        row_mask).  ``window_override``: window values computed by the
        distributed route, by ``id`` of their WindowFunction."""
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
                env[n.id] = [_broadcast(self.scalar.evaluate(
                    e, resolve, row_mask, window_override=window_override),
                    nrows) for e in n.exprs]
            else:  # Filter
                cond = self.scalar.evaluate(n.condition, resolve)
                m = cond.data.to(torch.bool)
                if cond.mask is not None:
                    m = m & cond.mask
                m = m.expand(nrows)
                row_mask = m if row_mask is None else (row_mask & m)
                env[n.id] = env[n.inputs[0].id]
            if self._analyze:  # the node's live rows (the last run wins)
                self._fused_rows[_node_line(n)] = (
                    nrows if row_mask is None else row_mask.sum())
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
        if isinstance(node, nd.Join):
            return self._exec_join(node, results)
        if isinstance(node, nd.LogicalUnion):
            return self._exec_union(node, results)
        if isinstance(node, nd.LogicalValues):
            return self._exec_values(node)
        if isinstance(node, nd.Unnest):
            return self._exec_unnest(node, results)
        raise ExecError(f"cannot execute node {node!r}")

    def _exec_values(self, node: nd.LogicalValues) -> ExecTable:
        """Inline literal rows, made on the host and moved to the
        device."""
        cols = []
        for ci, ty in enumerate(node.output_types):
            vals = [row[ci] for row in node.rows]
            validity = np.asarray([v is not None for v in vals])
            data = np.asarray([0 if v is None else v for v in vals],
                              dtype=ty.physical_dtype())
            cols.append(from_numpy(data, None if validity.all()
                                   else validity, self.device))
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         len(node.rows))

    def _exec_unnest(self, node: nd.Unnest, results) -> ExecTable:
        """Explode an array column: rows x width output rows (row-major:
        the parent row, then its elements); absent elements and dead
        parent rows are dead in the row mask, so nothing syncs."""
        src = self._input_table_masked(node.inputs[0], results)
        fi = node.field_index
        arr = src.columns[fi]
        if arr.data.dim() != 2:
            raise ExecError("UNNEST input is not an array column")
        n, width = arr.data.shape
        cols = []
        for i, c in enumerate(src.columns):
            if i == fi:
                cols.append(MaskedCol(arr.data.reshape(n * width)))
            else:
                c = _broadcast(c, n)
                cols.append(MaskedCol(
                    torch.repeat_interleave(c.data, width, dim=0),
                    torch.repeat_interleave(c.mask, width, dim=0)
                    if c.mask is not None else None))
        live = (arr.mask.reshape(n * width) if arr.mask is not None
                else torch.ones((n * width,), dtype=torch.bool,
                                device=self.device))
        if src.row_mask is not None:
            live = live & torch.repeat_interleave(src.row_mask, width)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         n * width, live)

    def _exec_scan(self, node: nd.Scan) -> ExecTable:
        if self._mesh is not None:
            return self._exec_scan_sharded(node)
        cols = _LazyScanColumns(node.table, list(node.fields), self.device)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         node.table.nrows)

    def _exec_chain_root(self, node: nd.Node, results) -> ExecTable:
        """A bare Project/Filter chain at the root: evaluate it."""
        source, chain, src_node = self._resolve_chain(node, results)
        if source.nrows == 0:
            return ExecTable.empty(node.fields, node.output_types,
                                   self.device)
        if self._mesh is not None and self._chain_has_window(chain):
            out = self._exec_chain_dist_window(node, source, chain, src_node)
            if out is not None:
                return out
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
        source, chain, src_node = self._resolve_chain_windowed(
            node.inputs[0], results)
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
        streaming = srt.streaming_topn(topn, nrows0,
                                       self.config.exec.streaming_topn_max)
        self._topn_route = "streaming" if streaming else "full"
        if self._mesh is not None and not streaming:
            # no small LIMIT: the range-partitioned sort over the shards
            out = self._exec_sort_dist(node, results,
                                       (source, chain, src_node))
            if out is not None:
                return out
        key += f"/{self._topn_route}"

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
                perm = (srt.lex_topn if streaming
                        else srt.full_topn)(skeys, topn, rm)
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
        table = torch.from_numpy(ranks).to(col.data.device)
        return MaskedCol(
            table[torch.clamp(col.data.to(torch.int64), 0, len(strings) - 1)],
            col.mask)

    # ------------------------------------------------------------------
    def _materialize_input(self, node: nd.Node, results) -> ExecTable:
        """Dense table of a loop-join input (compacted)."""
        return self._input_table_masked(node, results).compact()

    def _input_table_masked(self, node: nd.Node, results) -> ExecTable:
        """A join or union input without compaction: it keeps its row
        mask."""
        source, chain, _src = self._resolve_chain(node, results)
        if not chain:
            return source
        return self._exec_chain_root(node, results)

    def _exec_union(self, node: nd.LogicalUnion, results) -> ExecTable:
        """UNION ALL: the inputs' columns concatenated, each cast to the
        union's type; a filtered input adds its row mask to the union's
        instead of compacting."""
        parts = [self._input_table_masked(i, results) for i in node.inputs]
        live = [p for p in parts if p.nrows > 0]
        if not live:
            return ExecTable.empty(list(node.fields), list(node.output_types),
                                   self.device)

        def ones(shape):
            return torch.ones(shape, dtype=torch.bool, device=self.device)

        row_mask = None
        if any(p.row_mask is not None for p in live):
            row_mask = torch.cat([p.row_mask if p.row_mask is not None
                                  else ones(p.nrows) for p in live])
        cols: List[MaskedCol] = []
        for ci, ty in enumerate(node.output_types):
            dt = torch_dtype(ty.physical_dtype())
            parts_c = [_broadcast(p.columns[ci], p.nrows) for p in live]
            if ty.is_array():  # widths pad to the widest; pads are absent
                parts_c = [_as_array(c) for c in parts_c]
                width = max(c.data.shape[1] for c in parts_c)
                parts_c = [_pad_width(c, width) for c in parts_c]
            data = torch.cat([c.data.to(dt) for c in parts_c])
            mask = None
            if any(c.mask is not None for c in parts_c):
                mask = torch.cat([c.mask if c.mask is not None
                                  else ones(c.data.shape)
                                  for c in parts_c])
            cols.append(MaskedCol(data, mask))
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         sum(p.nrows for p in live), row_mask)


def _as_array(col: MaskedCol) -> MaskedCol:
    """An array-typed union input as 2-D: a 1-D column there is a NULL
    constant (the padding of an outer join's unmatched side), whose rows
    hold no element."""
    if col.data.dim() == 2:
        return col
    n = col.data.shape[0]
    return MaskedCol(torch.zeros((n, 1), dtype=col.data.dtype,
                                 device=col.data.device),
                     torch.zeros((n, 1), dtype=torch.bool,
                                 device=col.data.device))


def _pad_width(col: MaskedCol, width: int) -> MaskedCol:
    """An array column widened to ``width`` elements, the added ones
    absent."""
    n, k = col.data.shape
    if k == width:
        return col
    data = torch.zeros((n, width), dtype=col.data.dtype,
                       device=col.data.device)
    data[:, :k] = col.data
    mask = torch.zeros((n, width), dtype=torch.bool, device=col.data.device)
    mask[:, :k] = True if col.mask is None else col.mask
    return MaskedCol(data, mask)
