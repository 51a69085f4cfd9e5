"""hdk_tpu_torch — the PyTorch/CUDA port of hdk_tpu's query engine.

The port runs the single-table aggregate query: scan -> Project/Filter
chain -> GROUP BY (dense perfect-hash or sort-based, every aggregate but
TOP_K/BOTTOM_K) or scalar aggregate -> ORDER BY / LIMIT -> result, on an
explicit torch device.  The histograms of the group-by run hand-written
CUDA kernels (``csrc/hist.cu``) on a CUDA device and their plain PyTorch
versions on the CPU.  The host side (types, config, builder, IR, SQL
parser and binder, host storage, planner) is the port's own copy of
hdk_tpu's backend-neutral modules; nothing of hdk_tpu is imported.

    import hdk_tpu_torch
    hdk = hdk_tpu_torch.HDK(device="cuda")
    ht = hdk.import_pydict({"a": [1, 2, 1], "b": [10., 20., 30.]}, name="t")
    res = ht.agg("a", "sum(b)").run()
    res.to_numpy()

Routes not ported yet (joins, windows, UNION, VALUES, UNNEST, TOP_K and
BOTTOM_K, fragment-streamed aggregation, multi-device sessions, UDFs)
raise ``NotImplementedError`` naming their ROADMAP item.
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
        carries NULLs where it is masked (no pyarrow needed)."""
        name = self._table_name(name)
        cols = []
        for cname, values in data.items():
            if isinstance(values, np.ma.MaskedArray):
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

    def drop_table(self, name: str) -> None:
        self._schema.drop(name)

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

    # -- SQL ----------------------------------------------------------------
    def sql(self, query: str, **options) -> "QueryResult":
        """Execute a SQL query through the port's parser and binder."""
        from .sql.binder import Binder

        return self._run(Binder(self).bind(query), **options)

    # -- execution ----------------------------------------------------------
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
        if options.get("just_explain"):
            raise NotImplementedError(
                "EXPLAIN is not ported yet (ROADMAP A5)")
        dag = optimize_dag(_ir_node.QueryDag(node), self._config)
        wd = self._config.exec.watchdog
        saved = (wd.enable, wd.time_limit_ms)
        if "enable_watchdog" in options:
            wd.enable = bool(options["enable_watchdog"])
        if "watchdog_time_limit_ms" in options:
            wd.time_limit_ms = int(options["watchdog_time_limit_ms"])
            wd.enable = True
        try:
            table = self._executor.execute(dag)
        finally:
            wd.enable, wd.time_limit_ms = saved
        return QueryResult(self, table)


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
