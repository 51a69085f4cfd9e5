"""hdk_tpu_torch — the PyTorch/CUDA port of hdk_tpu's query engine.

The port runs scan -> Project/Filter chain (with window functions) ->
joins (INNER, LEFT, SEMI, ANTI on the perfect route's value tables, its
delta-spread variant or the sorted-hash route, chosen by a measured A/B
over large probes; loop joins; RIGHT/FULL OUTER and the
IN/EXISTS/correlated subqueries that bind to them; a warm run skips a
build subtree whose tables are recycled) -> GROUP BY (dense perfect-hash or sort-based, every
aggregate) or scalar aggregate -> ORDER BY / LIMIT -> result, with UNION
ALL, VALUES, and array columns (TOP_K/BOTTOM_K, CARDINALITY, subscript,
UNNEST), on an explicit torch device.  The histograms of the group-by
run hand-written CUDA kernels (``csrc/hist.cu``, ``csrc/int_hist.cu``) on
a CUDA device and their plain PyTorch versions on the CPU.  The host
side (types, config, builder, IR, SQL parser and binder, host storage,
planner) is the port's own copy of hdk_tpu's backend-neutral modules;
nothing of hdk_tpu is imported.

    import hdk_tpu_torch
    hdk = hdk_tpu_torch.HDK(device="cuda")
    ht = hdk.import_pydict({"a": [1, 2, 1], "b": [10., 20., 30.]}, name="t")
    res = ht.agg("a", "sum(b)").run()
    res.to_numpy()

A scan whose used columns exceed the scan budget streams through an
aggregate chunk by chunk, and a chain's Filters skip the fragments their
stats rule out.  ``hdk.explain(q)`` (or ``EXPLAIN SELECT ...``) gives
the plan text; ``hdk.explain(q, analyze=True)`` runs the query and adds
each step's time and rows.

Routes not ported yet (multi-device sessions, UDFs) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import types
from .builder import QueryExpr, QueryNode, if_then_else
from .config import Config, build_config
from .ir import expr as _ir_expr
from .ir import node as _ir_node
from .exec.common import ExecTable
from .exec.executor import Executor
from .exec import materialize as _mat
from .storage.dictionary import DictionaryRegistry
from .storage import importers as _imp
from .storage.schema import (
    DATA_SCHEMA_ID,
    RESULT_SCHEMA_ID,
    SchemaRegistry,
)

__version__ = "0.1.0"


class QueryResult:
    """Executed query result; also a queryable temp table (``res.scan``)."""

    def __init__(self, session: "HDK", table: ExecTable) -> None:
        self._session = session
        self._table = table  # may carry a lazy row_mask; compacted on use
        self._registered = None

    def _dense(self) -> ExecTable:
        if self._table.row_mask is not None:
            self._table = self._table.compact()
        return self._table

    @property
    def row_count(self) -> int:
        return self._table.live_count()

    @property
    def schema(self):
        return list(zip(self._table.fields, self._table.types))

    def block(self) -> "QueryResult":
        """Wait for the device work behind this result."""
        if self._session.device.type == "cuda":
            torch.cuda.synchronize(self._session.device)
        return self

    def to_arrow(self):
        return _mat.to_arrow(self._dense(), self._session._dicts)

    def to_pandas(self):
        return _mat.to_pandas(self._dense(), self._session._dicts)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Column name -> numpy array (a masked array where the column has
        NULLs); needs neither pyarrow nor pandas."""
        return _mat.to_numpy(self._dense(), self._session._dicts)

    @property
    def scan(self) -> QueryNode:
        """This result as the input of another query."""
        if self._registered is None:
            s = self._session
            tid = s._schema.next_table_id(RESULT_SCHEMA_ID)
            table = _mat.to_storage_table(
                self._dense(), tid, f"__result_{tid & 0xFFFFFF}",
                s._config.storage.fragment_size)
            s._schema.register(table)
            self._registered = table
        return self._session.scan(self._registered.name)

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(f"{n}: {ty}" for n, ty in self.schema)
        return f"QueryResult({self.row_count} rows; {cols})"


class HDK:
    """Session: Config -> storage -> executor -> builder, on one torch
    device.  ``device="cuda"`` raises where CUDA is not available; it
    never carries on on the CPU."""

    def __init__(self, device="cuda", **config_kwargs) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "HDK(device='cuda'): CUDA is not available "
                    "(pass device='cpu' to run on the CPU)")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {device!r}")
        self._config = (config_kwargs.pop("config")
                        if "config" in config_kwargs
                        else build_config(**config_kwargs))
        if self._config.dist.enable:
            raise NotImplementedError(
                "multi-device sessions (dist.enable) are not ported yet "
                "(ROADMAP A9)")
        self._schema = SchemaRegistry()
        self._dicts = DictionaryRegistry()
        from .utils import logger as _logger

        _logger.configure(self._config.debug.log_severity,
                          log_to_file=self._config.debug.log_to_file,
                          log_dir=self._config.debug.log_dir)
        from .storage.memory import device_cache_manager

        device_cache_manager().set_budget(
            self._config.storage.device_cache_budget_bytes)
        self._executor = Executor(self._schema, self._dicts, self._config,
                                  self.device)
        self._tmp_counter = 0
        self._lock = threading.Lock()

    @property
    def config(self) -> Config:
        return self._config

    def register_udf(self, name: str, fn, arg_types, ret_type,
                     null_propagation: bool = True):
        raise NotImplementedError(
            "UDFs with torch bodies are not ported yet (ROADMAP A6)")

    # -- ingest ------------------------------------------------------------
    def _table_name(self, name: Optional[str]) -> str:
        if name:
            return name
        with self._lock:
            self._tmp_counter += 1
            return f"table_{self._tmp_counter}"

    def _register(self, name, cols) -> QueryNode:
        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        table = _imp.build_table(tid, name, cols,
                                 self._config.storage.fragment_size)
        self._schema.register(table)
        return self.scan(name)

    def import_pydict(self, data: Dict[str, Sequence],
                      name: Optional[str] = None,
                      schema: Optional[Dict[str, types.Type]] = None
                      ) -> QueryNode:
        """Columns from lists or numpy arrays; a ``numpy.ma.MaskedArray``
        carries NULLs where it is masked (no pyarrow needed), and a 2-D
        one (rows x width) is an array column whose masked elements are
        absent, which gives lists of any length up to the width."""
        name = self._table_name(name)
        cols = []
        for cname, values in data.items():
            if isinstance(values, np.ma.MaskedArray) and values.ndim == 2:
                elem = types.from_numpy_dtype(values.dtype)
                cols.append((cname, types.array(elem, nullable=True),
                             np.ma.getdata(values),
                             ~np.ma.getmaskarray(values)))
            elif isinstance(values, np.ma.MaskedArray):
                declared = (schema or {}).get(cname)
                typ, phys, validity = _imp._from_numpy(
                    cname, np.ma.getdata(values), self._dicts, declared,
                    ~np.ma.getmaskarray(values))
                cols.append((cname, typ.with_nullable(True), phys, validity))
            else:
                cols.extend(_imp.columns_from_pydict(
                    {cname: values}, self._dicts, schema))
        return self._register(name, cols)

    def import_arrow(self, at, name: Optional[str] = None,
                     schema=None) -> QueryNode:
        name = self._table_name(name)
        return self._register(
            name, _imp.columns_from_arrow(at, self._dicts, schema))

    def import_pandas(self, df, name: Optional[str] = None) -> QueryNode:
        import pyarrow as pa

        return self.import_arrow(
            pa.Table.from_pandas(df, preserve_index=False), name)

    def import_parquet(self, path, name: Optional[str] = None) -> QueryNode:
        import pyarrow.parquet as pq

        return self.import_arrow(pq.read_table(path), name)

    def drop_table(self, name: str) -> None:
        self._schema.drop(name)

    def append_pydict(self, name: str, data: Dict[str, Sequence]) -> None:
        """Append rows to a table, each column read as the table's type
        (array columns pad to the wider width)."""
        from .storage.table import Column

        table = self._schema.get(name)
        own = [c for c in table.columns if not c.info.is_rowid]
        cols = _imp.columns_from_pydict(
            data, self._dicts, {c.info.name: c.type for c in own})
        by_name = {n: (d, v) for n, _ty, d, v in cols}
        table.append([Column(c.info, *by_name[c.info.name]) for c in own])

    # -- query construction -------------------------------------------------
    def scan(self, name: str) -> QueryNode:
        return QueryNode(_ir_node.Scan(self._schema.get(name)), self)

    def table_names(self):
        return self._schema.table_names()

    def cst(self, value, type_str: Optional[str] = None) -> QueryExpr:
        """Literal."""
        if type_str is not None:
            return QueryExpr(_ir_expr.Constant(types.parse_type(type_str),
                                               value))
        from .builder import _to_expr

        return QueryExpr(_to_expr(value))

    def date(self, value: str) -> QueryExpr:
        days = np.datetime64(value, "D").astype(np.int64)
        return QueryExpr(_ir_expr.Constant(types.date32(False), int(days)))

    def timestamp(self, value: str, unit: str = "us") -> QueryExpr:
        tu = types.TimeUnit(unit)
        v = np.datetime64(value).astype(f"datetime64[{unit}]").astype(np.int64)
        return QueryExpr(_ir_expr.Constant(types.timestamp(tu, False), int(v)))

    if_then_else = staticmethod(if_then_else)

    # -- window functions: shells that ``over``/``order_by`` complete -------
    def _window(self, kind: "_ir_expr.WindowKind", typ, arg1=None,
                name: str = "") -> QueryExpr:
        wf = _ir_expr.WindowFunction(typ, kind, [], [], [], (), arg1)
        return QueryExpr(wf, name or kind.value)

    def row_number(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.ROW_NUMBER, types.int64(False))

    def rank(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.RANK, types.int64(False))

    def dense_rank(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.DENSE_RANK, types.int64(False))

    def percent_rank(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.PERCENT_RANK,
                            types.fp64(False))

    def cume_dist(self) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.CUME_DIST, types.fp64(False))

    def ntile(self, tile_count: int) -> QueryExpr:
        return self._window(_ir_expr.WindowKind.NTILE, types.int64(False),
                            arg1=tile_count)

    # -- SQL ----------------------------------------------------------------
    def sql(self, query: str, **options) -> "QueryResult":
        """Execute a SQL query through the port's parser and binder.
        ``EXPLAIN SELECT ...`` returns the plan text."""
        from .sql.binder import Binder

        stripped = query.lstrip()
        if stripped[:8].lower() == "explain ":
            options = dict(options, just_explain=True)
            query = stripped[8:]
        return self._run(Binder(self).bind(query), **options)

    # -- execution ----------------------------------------------------------
    def explain(self, node_or_sql, analyze: bool = False) -> str:
        """The plan text, one node a line, root first.  ``analyze=True``
        runs the query with every step ending in a device synchronize and
        adds each step's [ms, rows] to its line; a Project or Filter that
        ran inside a step shows that step's time and its own live rows; a
        node of a join's build subtree that recycled build tables made
        unnecessary says so ("recycled: not run").
        Trailer lines give the NDV sample's host time and the step builds
        of the run."""
        from .exec.explain import explain_dag
        from .exec.optimizer import optimize_dag

        if isinstance(node_or_sql, str):
            from .sql.binder import Binder

            node = Binder(self).bind(node_or_sql)
        elif isinstance(node_or_sql, QueryNode):
            node = node_or_sql.node
        else:
            node = node_or_sql
        dag = optimize_dag(_ir_node.QueryDag(node), self._config)
        if not analyze:
            return explain_dag(dag.root)
        ex = self._executor
        ex._analyze = True
        ex._step_times = {}
        ex._fused_times = {}
        samp0 = ex._ndv_sample_seconds
        builds0 = ex.code_cache.misses
        try:
            ex.execute(dag)
        finally:
            ex._analyze = False
        notes = {nid: f"{ms:.1f} ms, {rows} rows"
                 for nid, (ms, rows) in ex._step_times.items()}
        for nid in ex._recycled_nodes:  # a build subtree that did not run
            notes[nid] = "recycled: not run"
        for nid, (step, ms, rows) in ex._fused_times.items():
            notes.setdefault(nid, f"in the {step} step: {ms:.1f} ms, "
                                  f"{rows} rows")
        out = explain_dag(dag.root, notes)
        samp = ex._ndv_sample_seconds - samp0
        if samp > 0:
            out += (f"\n-- sampling estimators (NDV): "
                    f"{samp * 1000:.1f} ms of host readback\n")
        # a step build is one step closure made (the JAX package's jit
        # builds): what a cold run pays on the host
        out += (f"\n-- step builds this run: "
                f"{ex.code_cache.misses - builds0}\n")
        return out

    def _run(self, node, **options) -> QueryResult:
        """Execute with per-query options (the JAX package's option set;
        device_type and the like are accepted and ignored)."""
        from .exec.optimizer import optimize_dag

        known = {"just_explain", "device_type", "enable_watchdog",
                 "watchdog_time_limit_ms", "enable_lazy_fetch",
                 "enable_columnar_output", "enable_dynamic_watchdog",
                 "forced_gpu_proportion"}
        unknown = set(options) - known
        if unknown:
            raise TypeError(f"unknown query options: {sorted(unknown)}")
        dag = optimize_dag(_ir_node.QueryDag(node), self._config)
        if options.get("just_explain"):
            from .exec.explain import explain_dag

            return explain_dag(dag.root)  # type: ignore[return-value]
        dag, plan_fb = self._choose_plan_variant(node, dag)
        wd = self._config.exec.watchdog
        saved = (wd.enable, wd.time_limit_ms)
        if "enable_watchdog" in options:
            wd.enable = bool(options["enable_watchdog"])
        if "watchdog_time_limit_ms" in options:
            wd.time_limit_ms = int(options["watchdog_time_limit_ms"])
            wd.enable = True
        try:
            if plan_fb is not None:  # the timed run of a plan variant
                import time as _time

                sig, variant = plan_fb
                t0 = _time.perf_counter()
                table = self._executor.execute(dag)
                self._executor._force_table(table)
                self._executor._plan_feedback.record(
                    sig, variant, _time.perf_counter() - t0)
            else:
                table = self._executor.execute(dag)
        finally:
            wd.enable, wd.time_limit_ms = saved
        return QueryResult(self, table)

    def _choose_plan_variant(self, node, rewritten):
        """The eager-aggregation A/B: when the rewrite changed the plan,
        the first runs of the plan shape run each variant once cold and
        once timed, then the session keeps the faster (a rewrite that
        measures slower turns itself off).  Returns (dag, None), or (dag,
        (signature, variant)) when this run is the timed one."""
        ecfg = self._config.exec
        if (not ecfg.enable_eager_aggregation
                or not ecfg.enable_route_feedback):
            return rewritten, None
        order = rewritten.topo_order()
        if not (any(isinstance(n, _ir_node.Aggregate) for n in order)
                and any(isinstance(n, _ir_node.Join) for n in order)):
            return rewritten, None
        import copy

        from .exec import optimizer as _opt
        from .exec.explain import explain_dag

        cfg_off = copy.deepcopy(self._config)
        cfg_off.exec.enable_eager_aggregation = False
        alt = _opt.optimize_dag(_ir_node.QueryDag(node), cfg_off)
        alt_txt = explain_dag(alt.root)
        if explain_dag(rewritten.root) == alt_txt:
            return rewritten, None  # the rewrite did not fire
        sig = "eagerplan|" + alt_txt
        variant, mode = self._executor._plan_feedback.choose(
            sig, ["rewrite", "original"])
        chosen = rewritten if variant == "rewrite" else alt
        return chosen, ((sig, variant) if mode == "timed" else None)


_global: Optional[HDK] = None
_global_lock = threading.Lock()


def init(**kwargs) -> HDK:
    """Global session: repeat calls return the existing instance and
    ignore their arguments."""
    global _global
    with _global_lock:
        if _global is None:
            _global = HDK(**kwargs)
        return _global
