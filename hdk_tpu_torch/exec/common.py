"""Executor data structures and small helpers (counterpart of
hdk_tpu/exec/common.py: ExecTable, the lazy scan, pruned scan and
join-output columns, the identity- and plan-keyed caches of join build
tables, the demanded-columns and consumer analyses, broadcasting, the
schema signature of compiled-step keys and the rebinding of a join's
residual onto its output)."""

from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from .masked import MaskedCol, nonzero_indices, torch_dtype
from .scalar import ExecError


@dataclass
class ExecTable:
    """Device-side step result.

    ``nrows`` is the buffer capacity; ``row_mask`` (optional) marks live
    rows, so filters and dense group buffers need no compaction until a
    consumer wants dense rows.  ``_live`` caches the host-synced live
    count.  ``unique_sets``: uniqueness certificates, each a frozenset of
    column indices whose value tuple (NULL compared as a value) is
    distinct across live rows; a group-by output certifies its keys.
    """

    fields: List[str]
    types: List[t.Type]
    columns: List[MaskedCol]
    nrows: int
    row_mask: Optional[torch.Tensor] = None
    _live: Optional[int] = None
    unique_sets: tuple = ()

    def live_count(self) -> int:
        if self.row_mask is None:
            return self.nrows
        if self._live is None:
            self._live = int(self.row_mask.sum())  # host sync
        return self._live

    def compact(self) -> "ExecTable":
        """Dense copy with dead rows removed (one sync + gather)."""
        if self.row_mask is None:
            return self
        out = self.gather(nonzero_indices(self.row_mask, self.live_count()))
        out.unique_sets = self.unique_sets  # a row subset stays distinct
        return out

    def gather(self, idx: torch.Tensor) -> "ExecTable":
        cols = [MaskedCol(c.data[idx],
                          c.mask[idx] if c.mask is not None else None)
                for c in self.columns]
        return ExecTable(self.fields, self.types, cols, int(idx.shape[0]))

    @staticmethod
    def empty(fields: List[str], types: List[t.Type],
              device: torch.device) -> "ExecTable":
        # an array column is (0, 1) with an element mask, as in the JAX
        # package: zero rows carry no width
        cols = [
            MaskedCol(torch.zeros((0, 1) if ty.is_array() else (0,),
                                  dtype=torch_dtype(ty.physical_dtype()),
                                  device=device),
                      torch.zeros((0, 1) if ty.is_array() else (0,),
                                  dtype=torch.bool, device=device)
                      if ty.nullable or ty.is_array() else None)
            for ty in types
        ]
        return ExecTable(list(fields), list(types), cols, 0)


class _LazyScanColumns(list):
    """Scan columns moved to the device on first access: unused columns
    never transfer."""

    def __init__(self, table, fields, device: torch.device):
        super().__init__([None] * len(fields))
        self._table = table
        self._fields = fields
        self._device = device

    def __getitem__(self, i):
        got = super().__getitem__(i)
        if got is None and isinstance(i, int):
            data, mask = self._table.column(self._fields[i]).device_arrays(
                self._device)
            got = MaskedCol(data, mask)
            self[i] = got
        return got

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class _PrunedScanColumns(list):
    """Scan columns restricted to the fragments that survive fragment
    skipping, moved to the device on first access
    (``Column.device_rows``: sliced on the device when the whole column
    is there, else only the survivors copied from the host).  The rows
    are the survivors' and nothing else: no padding."""

    def __init__(self, table, fields, ranges, device: torch.device):
        super().__init__([None] * len(fields))
        self._table = table
        self._fields = fields
        merged: List[list] = []
        for s, e in ranges:  # adjacent fragments make one range
            if merged and merged[-1][1] == s:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        self._ranges = tuple((s, e) for s, e in merged)
        self._device = device

    def __getitem__(self, i):
        got = super().__getitem__(i)
        if got is None and isinstance(i, int):
            data, mask = self._table.column(self._fields[i]).device_rows(
                self._device, self._ranges)
            got = MaskedCol(data, mask)
            self[i] = got
        return got

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class _LazyThunkColumns(list):
    """Columns computed on first access: a join output's column is
    gathered only when a consumer reads it."""

    def __init__(self, thunks):
        super().__init__([None] * len(thunks))
        self._thunks = thunks

    def __getitem__(self, i):
        got = super().__getitem__(i)
        if got is None and isinstance(i, int):
            got = self._thunks[i]()
            self[i] = got
        return got

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _tensor_bytes(value) -> int:
    """Bytes of the tensors in a cached value (tensors, dataclasses,
    tuples and lists of them)."""
    if isinstance(value, torch.Tensor):
        return value.nbytes
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return sum(_tensor_bytes(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    if isinstance(value, (tuple, list)):
        return sum(_tensor_bytes(v) for v in value)
    return 0


class _IdentityKeyedCache:
    """Cache keyed by (plan signature, identity of device tensors).

    ``id()`` alone is unsafe: CPython reuses an address after a tensor is
    freed, so a later query could hit an entry built from other data.
    Entries hold weakrefs to the keyed tensors; a lookup checks each with
    ``is`` and misses on any mismatch."""

    def __init__(self, limit: int, byte_budget: Optional[int] = None,
                 enabled: bool = True) -> None:
        self._limit = limit
        self._byte_budget = byte_budget
        self._enabled = enabled
        self._bytes = 0
        self._d: Dict = {}

    @staticmethod
    def _key(sig, objs):
        return (sig, tuple(id(o) for o in objs))

    def get(self, sig, objs):
        if not self._enabled:
            return None
        ent = self._d.get(self._key(sig, objs))
        if ent is None:
            return None
        refs, value, _nb = ent
        for r, o in zip(refs, objs):
            if (r() if r is not None else None) is not o:
                return None  # the address now holds another tensor
        return value

    def put(self, sig, objs, value) -> None:
        if not self._enabled:
            return
        nb = _tensor_bytes(value)
        if len(self._d) > self._limit or (
                self._byte_budget is not None
                and self._bytes + nb > self._byte_budget):
            self._d.clear()
            self._bytes = 0
        refs = tuple(None if o is None else weakref.ref(o) for o in objs)
        self._d[self._key(sig, objs)] = (refs, value, nb)
        self._bytes += nb


class _PlanArtifactCache:
    """LRU of join build tables keyed by (data-plan signature of the build
    subtree, tag).  A build side derived from a filter or another join
    gets fresh tensors every run (its row mask at least), so the identity
    cache misses there; the data-plan signature names the scanned tables,
    so it is the same across runs over the same data
    (``codecache.data_plan_sig``)."""

    def __init__(self, limit: int = 256,
                 byte_budget: Optional[int] = None,
                 enabled: bool = True) -> None:
        self._limit = limit
        self._byte_budget = byte_budget
        self._enabled = enabled
        self._bytes = 0
        self._d: "OrderedDict" = OrderedDict()

    def get(self, key):
        if not self._enabled:
            return None
        ent = self._d.get(key)
        if ent is None:
            return None
        self._d.move_to_end(key)
        return ent[0]

    def put(self, key, value) -> None:
        if not self._enabled:
            return
        nb = _tensor_bytes(value)
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= old[1]
        self._d[key] = (value, nb)
        self._bytes += nb
        while self._d and (
                len(self._d) > self._limit
                or (self._byte_budget is not None
                    and self._bytes > self._byte_budget)):
            _, (_, b) = self._d.popitem(last=False)
            self._bytes -= b


# nodes that fuse into their consumer's step rather than execute alone
_CHAIN_NODES = (nd.Project, nd.Filter)


def _column_demand(order, root) -> Dict[int, Optional[set]]:
    """Per node, the output columns its consumers may read (None: all),
    from one backward pass over the topological order.  The spread join
    reads it to serve only build columns, and raises where a consumer
    pulls another, so each rule over-approximates what this package's
    executor reads of its input:

    * Project: ``Executor._chain_env`` evaluates every expression, even
      one no consumer reads, so every expression's references count;
    * Filter: passes its consumers' demand through (same columns), plus
      its condition's references;
    * Aggregate: ``_agg_used`` reads the keys' and the aggregates'
      operands (both operands), the fused aggregate -> ORDER BY step, the
      identity pass, the range probe and the NDV sample read subsets;
    * Sort: ``_exec_sort`` with no Project in its chain (and its empty
      input path, which compacts) reads every column;
    * Unnest and UNION ALL read every column of each input;
    * Join: a join passes its inputs' columns through on demand, but
      SEMI/ANTI gather every probe column, a residual compacts its
      output and loop joins compact both inputs: every column of both,
      plus the key and residual references;
    * the root is materialized whole; Scan and Values read no input."""
    demand: Dict[int, Optional[set]] = {root.id: None}

    def want(n: nd.Node, cols: Optional[set]) -> None:
        cur = demand.get(n.id, set())
        if cur is None:
            return
        demand[n.id] = None if cols is None else (cur | cols)

    def want_refs(exprs) -> None:
        for e in exprs:
            if e is not None:
                for ref in ir.collect_column_refs(e):
                    want(ref.node, {ref.index})

    for node in reversed(order):
        d = demand.get(node.id, set())
        if isinstance(node, nd.Project):
            want_refs(node.exprs)
        elif isinstance(node, nd.Filter):
            want(node.inputs[0], d)
            want_refs([node.condition])
        elif isinstance(node, nd.Aggregate):
            want_refs(node.keys)
            want_refs(node.aggs)
        elif isinstance(node, nd.Join):
            for i in node.inputs:
                want(i, None)
            want_refs([e for pair in node.key_pairs for e in pair])
            want_refs([node.residual])
        else:  # Sort, Unnest, UNION ALL, and any other kind
            for i in node.inputs:
                want(i, None)
    return demand


def _consumer_kinds(order, root) -> Dict[int, List[str]]:
    """Per node, the kinds of its terminal consumers, seen through
    Project/Filter chains (which fuse into their consumer and carry row
    masks for free): ``join_build``, ``join_probe``, ``agg``, ``sort``,
    ``root``, or the node class name in lower case.  A join whose output
    feeds only other joins can stay masked: key evaluation folds the row
    mask into NULL keys at no cost."""
    direct: Dict[int, List] = {}
    for n in order:
        for pos, i in enumerate(n.inputs):
            direct.setdefault(i.id, []).append((n, pos))
    memo: Dict[int, List[str]] = {}

    def kinds_of(nid: int) -> List[str]:
        if nid in memo:
            return memo[nid]
        memo[nid] = res = []
        if nid == root.id:
            res.append("root")
        for c, pos in direct.get(nid, []):
            if isinstance(c, _CHAIN_NODES):
                res.extend(kinds_of(c.id))
            elif isinstance(c, nd.Join):
                res.append("join_build" if pos == 1 else "join_probe")
            elif isinstance(c, nd.Aggregate):
                res.append("agg")
            elif isinstance(c, nd.Sort):
                res.append("sort")
            else:
                res.append(type(c).__name__.lower())
        return res

    return {n.id: kinds_of(n.id) for n in order}


def _broadcast(col: MaskedCol, nrows: int) -> MaskedCol:
    if col.data.dim() == 0:
        return MaskedCol(col.data.expand(nrows),
                         col.mask.expand(nrows) if col.mask is not None
                         else None)
    return col


def _schema_sig(table: ExecTable) -> str:
    return ",".join(f"{ty}" for ty in table.types) + (
        "|masked" if table.row_mask is not None else "")


def _raise_ref(ref):
    raise ExecError(f"unresolvable column ref {ref!r}")


def _rebind_to_join_output(expr: ir.Expr, join: nd.Join) -> ir.Expr:
    """Rewrite ColumnRefs into the join's (lhs, rhs) inputs as refs into
    its output column order (lhs fields ++ rhs fields)."""
    lhs, rhs = join.inputs

    def rw(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.ColumnRef):
            if e.node is lhs:
                return ir.ColumnRef(e.type, join, e.index)
            if e.node is rhs:
                return ir.ColumnRef(e.type, join, lhs.size() + e.index)
            return e
        ops = [rw(o) for o in e.operands()]
        return e.rebuild(*ops) if ops else e

    return rw(expr)
