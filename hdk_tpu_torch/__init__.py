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

The rest of the facade: scalar UDFs with torch bodies
(``register_udf``, ``call``), streaming aggregation over pushed batches
(``create_stream``), results that spill to host memory under the device
budget (``QueryResult.offload``) and reload on use, SQLite as the
fallback of SQL the engine refuses (``exec.enable_interop``), CSV and
JSON ingest, and ``import_arrow``'s device prefetch, which copies each
column while the next one decodes.

``HDK(device=..., **{"dist.enable": True, "dist.num_devices": n})``
is a session over a mesh of n shards, and ``dist.multi_host`` joins a
job of processes through ``torch.distributed``.
``enable_debug_timer(True)`` times each step of a query on the host
clock, and the front end's stages (``sql:bind``, ``sql:parse``,
``plan:optimize``, ``exec:prepare``) under the open span's ``stages``,
and counts the host syncs in each span; ``timer_report()`` returns the
last step's tree.
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
from .storage.dictionary import NULL_CODE, DictionaryRegistry
from .storage import importers as _imp
from .storage.schema import (
    DATA_SCHEMA_ID,
    RESULT_SCHEMA_ID,
    SchemaRegistry,
)
from .utils.timer import enable_debug_timer, timer_report

__version__ = "0.1.0"


class _ResultSpillHandle:
    """A result's entry in the device cache manager: evicting it offloads
    the result to host memory.  It holds the result weakly; a result that
    is collected leaves the manager."""

    def __init__(self, result: "QueryResult") -> None:
        import weakref

        from .storage.memory import device_cache_manager

        self._ref = weakref.ref(result)
        weakref.finalize(result, device_cache_manager().note_drop, self)

    def drop_device_cache(self, _from_manager: bool = False) -> None:
        r = self._ref()
        if r is not None:
            r.offload()


def _table_bytes(t: ExecTable) -> int:
    tensors = [x for c in t.columns for x in (c.data, c.mask)] + [t.row_mask]
    return sum(x.nbytes for x in tensors if x is not None)


def _host_copy(x: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    from .storage.table import to_host

    return None if x is None else to_host(x)


class QueryResult:
    """Executed query result; also a queryable temp table (``res.scan``).

    Its device tensors count against the device cache budget
    (``storage/memory.py``): when the budget evicts it, or on
    ``offload()``, they move to host memory and come back on the next
    use.  A result whose columns are still lazy (a scan's columns, a
    join's gathers) is counted once it materializes.  The eviction may
    run on the ingest worker's thread, so a lock guards the swap; a
    reader keeps the table it was handed, which stays valid after an
    offload."""

    def __init__(self, session: "HDK", table: ExecTable) -> None:
        self._session = session
        self._table = table  # may carry a lazy row_mask; compacted on use
        self._registered = None
        self._host_spill = None  # (fields, types, rows, columns, row mask)
        self._lock = threading.RLock()
        self._spill_handle = _ResultSpillHandle(self)
        self._note_resident(table)

    # -- spill to host under the device budget ------------------------------
    # The lock guards the swap between the device table and the host copy;
    # the manager is told outside it (its eviction takes other results'
    # locks), so its entry may lag a concurrent offload or reload: it only
    # decides what to evict next.
    def _nbytes(self) -> int:
        return _table_bytes(self._table)

    def _note_resident(self, t: ExecTable) -> None:
        from .storage.memory import device_cache_manager

        if type(t.columns) is not list:
            return  # lazy columns: sizing them would force them
        device_cache_manager().note_use(self._spill_handle, _table_bytes(t))

    def offload(self) -> "QueryResult":
        """Copy this result's data, masks and row mask to host memory and
        drop its device tensors; the next use copies them back."""
        from .storage.memory import device_cache_manager

        with self._lock:
            t = self._table
            if t is not None:
                self._host_spill = (
                    list(t.fields), list(t.types), t.nrows,
                    [(_host_copy(c.data), _host_copy(c.mask))
                     for c in t.columns],
                    _host_copy(t.row_mask))
                self._table = None
        device_cache_manager().note_drop(self._spill_handle)
        return self

    def _ensure_device(self) -> ExecTable:
        """The result's table on the session's device, copied back from
        host memory if it was offloaded.  The caller uses the table
        returned: the budget may offload the result again at once."""
        from .exec.masked import MaskedCol
        from .storage.table import to_device

        with self._lock:
            t = self._table
            if t is not None:
                return t
            fields, types_, nrows, cols_h, rm_h = self._host_spill
            dev = self._session.device

            def back(x):
                return None if x is None else to_device(x, dev)

            t = ExecTable(fields, types_,
                          [MaskedCol(back(d), back(m)) for d, m in cols_h],
                          nrows, back(rm_h))
            self._table = t
            self._host_spill = None
        self._note_resident(t)
        return t

    def _dense(self) -> ExecTable:
        t = self._ensure_device()
        if t.row_mask is None:
            return t
        t = t.compact()
        with self._lock:
            kept = self._table is not None  # else offloaded meanwhile
            if kept:
                self._table = t
        if kept:
            self._note_resident(t)
        return t

    @property
    def row_count(self) -> int:
        with self._lock:
            if self._table is None:
                rm = self._host_spill[4]
                return self._host_spill[2] if rm is None else int(rm.sum())
            return self._table.live_count()

    @property
    def schema(self):
        with self._lock:
            if self._table is None:
                return list(zip(self._host_spill[0], self._host_spill[1]))
            return list(zip(self._table.fields, self._table.types))

    def block(self) -> "QueryResult":
        """Wait for the device work behind this result (an offloaded
        result has none left)."""
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

    def head(self, n: int = 10):
        """The first ``n`` rows as an Arrow table."""
        return self.to_arrow().slice(0, n)

    def tail(self, n: int = 10):
        """The last ``n`` rows as an Arrow table."""
        arr = self.to_arrow()
        return arr.slice(max(0, arr.num_rows - n), n)

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
        self._schema = SchemaRegistry()
        self._dicts = DictionaryRegistry()
        from .utils import logger as _logger

        _logger.configure(self._config.debug.log_severity,
                          log_to_file=self._config.debug.log_to_file,
                          log_dir=self._config.debug.log_dir)
        from .storage.memory import device_cache_manager

        device_cache_manager().set_budget(
            self._config.storage.device_cache_budget_bytes)
        from .udf import UdfRegistry

        self._udfs = UdfRegistry()
        self._executor = Executor(self._schema, self._dicts, self._config,
                                  self.device, udfs=self._udfs)
        self._tmp_counter = 0
        self._lock = threading.Lock()

    @property
    def config(self) -> Config:
        return self._config

    # -- UDFs ---------------------------------------------------------------
    def register_udf(self, name: str, fn, arg_types, ret_type,
                     null_propagation: bool = True):
        """Register a scalar UDF with a torch body, callable from SQL and
        from the builder (``call``); see udf.py for the contract.
        Registering a name again replaces its body."""
        return self._udfs.register(name, fn, arg_types, ret_type,
                                   null_propagation=null_propagation)

    def call(self, name: str, *args) -> QueryExpr:
        """Builder-side call of a registered UDF or a scalar builtin;
        Python numbers and bools become typed constants."""
        from .ir.expr import Constant, Expr, FunctionCall

        def as_expr(a):
            if isinstance(a, QueryExpr):
                return a.expr
            if isinstance(a, Expr):
                return a
            if isinstance(a, bool):
                return Constant(types.boolean(False), a)
            if isinstance(a, int):
                return Constant(types.int64(False), a)
            if isinstance(a, float):
                return Constant(types.fp64(False), a)
            raise TypeError(f"cannot pass {type(a).__name__} to call(); "
                            "wrap strings and dates with hdk.cst()")

        exprs = [as_expr(a) for a in args]
        udf = self._udfs.get(name)
        if udf is not None:
            nullable = any(e.type.nullable for e in exprs)
            out_t = udf.ret_type.with_nullable(
                udf.ret_type.nullable or (udf.null_propagation and nullable))
            return QueryExpr(FunctionCall(out_t, name.lower(), exprs))
        # a builtin is typed as the SQL binder types it
        from .sql.binder import Binder

        out_t = Binder(self)._fn_type(name.lower(), exprs)
        return QueryExpr(FunctionCall(out_t, name.lower(), exprs))

    # -- ingest ------------------------------------------------------------
    def _table_name(self, name: Optional[str]) -> str:
        if name:
            return name
        with self._lock:
            self._tmp_counter += 1
            return f"table_{self._tmp_counter}"

    def _register(self, name, cols, process_local: bool = False
                  ) -> QueryNode:
        from .parallel import mesh as pmesh

        if process_local:
            cols = pmesh.align_process_local(name, cols, self._executor._mesh)
        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        table = _imp.build_table(tid, name, cols,
                                 self._config.storage.fragment_size,
                                 process_local=process_local)
        if process_local:
            pmesh.share_process_layout(table)
        self._schema.register(table)
        return self.scan(name)

    def import_pydict(self, data: Dict[str, Sequence],
                      name: Optional[str] = None,
                      schema: Optional[Dict[str, types.Type]] = None,
                      process_local: bool = False) -> QueryNode:
        """Columns from lists or numpy arrays; a ``numpy.ma.MaskedArray``
        carries NULLs where it is masked (no pyarrow needed), and a 2-D
        one (rows x width) is an array column whose masked elements are
        absent, which gives lists of any length up to the width.

        ``process_local=True`` (a multi-host session): ``data`` holds only
        this rank's rows, and scans assemble the global row-sharded table
        across the ranks; every rank must import the same table name with
        its own rows, at the same point of the same program.  String
        columns are unified at ingest: every rank's dictionary joins one
        canonical code space, the rank-ordered union, and the local codes
        are rewritten."""
        name = self._table_name(name)
        pre_dicts = set(self._dicts._dicts) if process_local else set()
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
        if process_local:
            cols = self._unify_process_local_dicts(cols, pre_dicts)
        return self._register(name, cols, process_local=process_local)

    def _unify_process_local_dicts(self, cols, pre_dicts):
        """Rewrite freshly dict-encoded process-local columns into the
        cross-process canonical code space (parallel/mesh.py).  A column
        on a dictionary that existed before this import is refused: its
        unification would rewrite the codes of tables already
        ingested."""
        from .parallel.mesh import process_count, unify_process_dictionary
        from .storage.dictionary import NULL_CODE

        if process_count() == 1:
            return cols
        out = []
        for (cname, typ, phys, validity) in cols:
            if typ.is_dict_encoded_string():
                did = typ.dict_id  # type: ignore[attr-defined]
                if did in pre_dicts:
                    raise ValueError(
                        f"process_local column {cname!r} declares a shared "
                        "dictionary; cross-process unification would "
                        "rewrite codes of previously ingested tables — "
                        "import it with a fresh dictionary instead")
                trans = unify_process_dictionary(self._dicts.get(did))
                codes = np.asarray(phys)
                phys = np.where(codes >= 0, trans[np.maximum(codes, 0)],
                                NULL_CODE).astype(np.int32)
            out.append((cname, typ, phys, validity))
        return out

    def import_arrow(self, at, name: Optional[str] = None,
                     schema=None) -> QueryNode:
        """An Arrow table.  With ``storage.prefetch_device`` (None: on),
        each column's copy to the device goes to the ingest worker as
        soon as its host decode ends, so it overlaps the next column's
        decode, and the fragment stats are computed in the background."""
        from .storage.table import Column, ColumnInfo, Table

        name = self._table_name(name)
        pf = self._config.storage.prefetch_device
        prefetch = pf is None or bool(pf)
        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        built = []

        def pipeline(col):
            cname, typ, data, validity = col
            c = Column(ColumnInfo(tid, len(built), cname, typ), data,
                       validity)
            built.append(c)
            if prefetch:
                c.prefetch_device(self.device)

        _imp.columns_from_arrow(at, self._dicts, schema, pipeline=pipeline)
        table = Table(tid, name, built, self._config.storage.fragment_size)
        if prefetch:
            table.prefetch_stats_async()
        self._schema.register(table)
        return self.scan(name)

    def import_pandas(self, df, name: Optional[str] = None) -> QueryNode:
        import pyarrow as pa

        return self.import_arrow(
            pa.Table.from_pandas(df, preserve_index=False), name)

    def import_parquet(self, path, name: Optional[str] = None) -> QueryNode:
        import pyarrow.parquet as pq

        return self.import_arrow(pq.read_table(path), name)

    def import_csv(self, path, name: Optional[str] = None,
                   **read_options) -> QueryNode:
        """One CSV file, or a list of them concatenated, through Arrow's
        reader (``read_options`` go to ``pyarrow.csv.read_csv``)."""
        import pyarrow.csv as pacsv

        return self._import_files(pacsv.read_csv, path, name, read_options)

    def import_json(self, path, name: Optional[str] = None,
                    **read_options) -> QueryNode:
        """Line-delimited JSON files through Arrow's reader."""
        import pyarrow.json as pajson

        return self._import_files(pajson.read_json, path, name,
                                  read_options)

    def _import_files(self, read, path, name, read_options) -> QueryNode:
        import pyarrow as pa

        paths = path if isinstance(path, (list, tuple)) else [path]
        tables = [read(p, **read_options) for p in paths]
        at = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        return self.import_arrow(at, name)

    def create_table(self, name: str, schema: Dict[str, object]) -> QueryNode:
        """An empty table from {column: type string or Type}; a text
        column gets a dictionary of its own."""
        cols = []
        for cname, typ in schema.items():
            if isinstance(typ, str):
                typ = types.parse_type(typ)
            if typ.is_string():
                typ = types.dict_text(self._dicts.create().dict_id)
            cols.append((cname, typ, np.zeros(0, typ.physical_dtype()),
                         None))
        return self._register(name, cols)

    def clear_device_mem(self) -> None:
        """Drop the device copies of every table's columns; the next
        query copies what it reads again."""
        for tname in self._schema.table_names():
            for col in self._schema.get(tname).columns:
                col.drop_device_cache()

    def refragmented_view(self, name: str, new_name: str,
                          fragment_size: int) -> QueryNode:
        """A table of the same columns (shared, not copied) under another
        fragment size."""
        from .storage.table import Table

        src = self._schema.get(name)
        tid = self._schema.next_table_id(DATA_SCHEMA_ID)
        cols = [c for c in src.columns if not c.info.is_rowid]
        self._schema.register(Table(tid, new_name, cols, fragment_size))
        return self.scan(new_name)

    def drop_table(self, name: str) -> None:
        """Unregister a table and drop its columns' device copies."""
        table = self._schema.get(name)
        self._schema.drop(name)
        for col in table.columns:
            col.drop_device_cache()

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

    def time(self, value: str) -> QueryExpr:
        """A TIME literal from "HH[:MM[:SS]]", in seconds."""
        h, m, s = (list(map(int, value.split(":"))) + [0, 0])[:3]
        return QueryExpr(_ir_expr.Constant(
            types.time64(types.TimeUnit.SECOND, False), h * 3600 + m * 60 + s))

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

    # -- streaming ----------------------------------------------------------
    def create_stream(self, schema: Dict[str, object], keys, aggs):
        """Incremental GROUP BY over batches pushed one at a time
        (streaming.py)."""
        from .streaming import StreamingAggregation

        return StreamingAggregation(self, schema, list(keys), list(aggs))

    # -- SQL ----------------------------------------------------------------
    def sql(self, query: str, **options) -> "QueryResult":
        """Execute a SQL query through the port's parser and binder.
        ``EXPLAIN SELECT ...`` returns the plan text.  With
        ``exec.enable_interop``, a query the engine refuses (a
        ``SqlError`` or ``ExecError``) runs in SQLite instead."""
        from .exec.scalar import ExecError
        from .sql.binder import Binder
        from .sql.lexer import SqlError
        from .utils.timer import DebugTimer

        stripped = query.lstrip()
        if stripped[:8].lower() == "explain ":
            options = dict(options, just_explain=True)
            query = stripped[8:]
        try:
            with DebugTimer("sql:bind", stage=True):
                node = Binder(self).bind(query)
            return self._run(node, **options)
        except (SqlError, ExecError) as err:
            if not self._config.exec.enable_interop:
                raise
            return self._sql_interop(query, err)

    def _sql_interop(self, query: str, err: Exception) -> "QueryResult":
        """Run ``query`` in an in-memory SQLite database over the
        session's tables that it names (each exported through the
        engine's own scan, dictionary strings decoded), and import the
        answer as a result on the session's device.  Uses ``sqlite3``
        and numpy only.  When SQLite fails too, the engine's error is
        raised.  An escape hatch, not a fast path."""
        import re
        import sqlite3

        from .exec.masked import MaskedCol
        from .storage.table import to_device
        from .utils.logger import get_channel

        names = [n for n in self._schema.table_names()
                 if re.search(rf"\b{re.escape(n)}\b", query, re.I)]
        if not names:
            raise err
        conn = sqlite3.connect(":memory:")
        try:
            for n in names:
                res = self.scan(n).run()
                _sqlite_export(conn, n, res.schema, res.to_numpy())
            cur = conn.execute(query)
            out_names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        except (sqlite3.Error, TypeError, ValueError):
            raise err from None  # the engine's error, not SQLite's
        finally:
            conn.close()
        typs, cols = [], []
        for i, cname in enumerate(out_names):
            typ, data, validity = _sqlite_column(
                cname, [r[i] for r in rows], self._dicts)
            typs.append(typ)
            cols.append(MaskedCol(
                to_device(data, self.device),
                None if validity is None else to_device(validity,
                                                        self.device)))
        table = ExecTable(out_names, typs, cols, len(rows))
        get_channel("sql").info(
            "interop fallback ran %d-table query through SQLite "
            "(engine said: %s)", len(names), str(err)[:120])
        return QueryResult(self, table)

    # -- execution ----------------------------------------------------------
    def explain(self, node_or_sql, analyze: bool = False) -> str:
        """The plan text, one node a line, root first.  ``analyze=True``
        runs the query with every step ending in a device synchronize and
        adds each step's [ms, rows] to its line; a Project or Filter that
        ran inside a step shows that step's time and its own live rows; a
        node of a join's build subtree that recycled build tables made
        unnecessary says so ("recycled: not run").
        A trailer line gives the NDV sample's host time, when one ran."""
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
        return out

    def _run(self, node, **options) -> QueryResult:
        """Execute with per-query options (the JAX package's option set;
        device_type and the like are accepted and ignored)."""
        from .exec.optimizer import optimize_dag
        from .utils.timer import DebugTimer

        known = {"just_explain", "device_type", "enable_watchdog",
                 "watchdog_time_limit_ms", "enable_lazy_fetch",
                 "enable_columnar_output", "enable_dynamic_watchdog",
                 "forced_gpu_proportion"}
        unknown = set(options) - known
        if unknown:
            raise TypeError(f"unknown query options: {sorted(unknown)}")
        with DebugTimer("plan:optimize", stage=True):
            dag = optimize_dag(_ir_node.QueryDag(node), self._config)
            if not options.get("just_explain"):
                dag, plan_fb = self._choose_plan_variant(node, dag)
        if options.get("just_explain"):
            from .exec.explain import explain_dag

            return explain_dag(dag.root)  # type: ignore[return-value]
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
        mesh = self._executor._mesh
        # ranks time on their own clocks and could choose apart: a
        # multi-host session keeps the rewrite, untimed
        if (not ecfg.enable_eager_aggregation
                or not ecfg.enable_route_feedback
                or (mesh is not None and mesh.world > 1)):
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


def _sqlite_export(conn, name: str, typed, cols: Dict[str, np.ndarray]
                   ) -> None:
    """Write a table into SQLite as pandas' ``to_sql`` writes a frame:
    numbers as numbers (bools as 0/1), strings as text, dates and
    timestamps as ISO text, NULL and NaN as NULL."""
    def sql_values(typ, col):
        data = np.ma.getdata(col)
        valid = ~np.ma.getmaskarray(col)
        if data.ndim != 1:
            raise TypeError(f"column of type {typ} has no SQLite form")
        if typ.is_date() or typ.is_datetime():
            unit = "D" if typ.unit == types.TimeUnit.DAY else typ.unit.value
            stamps = data.astype(f"datetime64[{unit}]").astype(
                "datetime64[us]").astype(object)
            vals = [str(v.date()) if typ.is_date() else str(v)
                    for v in stamps]
        else:
            vals = data.tolist()
            if data.dtype.kind == "f":
                valid = valid & ~np.isnan(data)
        return [v if ok else None for v, ok in zip(vals, valid.tolist())]

    names = list(cols)
    rows = list(zip(*[sql_values(typ, cols[n])
                      for n, (_n, typ) in zip(names, typed)]))
    quoted = ", ".join('"' + n.replace('"', '""') + '"' for n in names)
    conn.execute(f'CREATE TABLE "{name}" ({quoted})')
    conn.executemany(f'INSERT INTO "{name}" VALUES '
                     f'({", ".join("?" * len(names))})', rows)


def _sqlite_column(name: str, values: list, dicts):
    """(type, data, validity or None) of a column SQLite returned, typed
    as pandas' ``read_sql_query`` types it in the JAX package: integers
    as int64, or float64 when a row is NULL or a float; text as a
    dictionary column of its own.  A column with no value but NULLs, or
    mixing text with numbers, has no type (the JAX package's importer
    refuses it too)."""
    present = [v for v in values if v is not None]
    kinds = {type(v) for v in present}
    if not present or not (kinds <= {int, float} or kinds == {str}):
        raise TypeError(f"unsupported SQLite result type for column "
                        f"{name!r}: {sorted(k.__name__ for k in kinds)}")
    if kinds == {str}:
        d = dicts.create()
        codes = d.bulk_get_or_add(values)  # None -> NULL_CODE
        validity = codes != NULL_CODE
        if validity.all():
            validity = None
        return (types.dict_text(d.dict_id, nullable=validity is not None),
                codes, validity)
    validity = (None if len(present) == len(values)
                else np.asarray([v is not None for v in values]))
    if kinds == {int} and validity is None:
        return types.int64(False), np.asarray(values, dtype=np.int64), None
    data = np.asarray([np.nan if v is None else v for v in values],
                      dtype=np.float64)
    return types.fp64(validity is not None), data, validity


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
