"""Plan hashing + compiled-step cache.

Reference: the LRU code cache keyed on serialized LLVM IR /
plan-DAG hashes (NativeCodegen.cpp:189-205, CodeCacheAccessor.h:25,
QueryPlanDagCache.h:61; RelAlgExecutionUnit.h:64-88 hashes).

Here the compiled artifact is a jitted Python callable: caching the
*same callable object* per structural plan hash lets jax.jit's own
trace cache hit across repeated queries of the same shape, so a
repeated query costs zero retracing.  Table identity is part of the
key only through array shapes/dtypes (jit avals), matching the
reference's plan-hash (not data-hash) behavior.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..ir import expr as ir
from ..ir import node as nd


def _h(parts) -> str:
    m = hashlib.blake2b(digest_size=16)
    for p in parts:
        m.update(str(p).encode())
        m.update(b"\x00")
    return m.hexdigest()


def expr_sig(e: ir.Expr, node_ids: dict) -> str:
    """Structural signature; input nodes identified by stable position."""
    kind = type(e).__name__
    if isinstance(e, ir.ColumnRef):
        return f"ref[{node_ids.get(e.node.id, e.node.id)}:{e.index}:{e.type}]"
    extra = []
    for attr in ("kind", "value", "field", "pattern", "escape",
                 "case_insensitive", "is_regexp", "values", "distinct",
                 "arg1", "interpolation", "order_desc", "frame"):
        if hasattr(e, attr):
            extra.append(f"{attr}={getattr(e, attr)}")
    ops = ",".join(expr_sig(o, node_ids) for o in e.operands())
    return f"{kind}:{e.type}({';'.join(extra)})({ops})"


def node_sig(node: nd.Node, node_ids: dict) -> str:
    """Signature of one node given positional ids for its inputs."""
    kind = type(node).__name__
    if isinstance(node, nd.Scan):
        # schema-only: same-shaped scans of different tables share code
        return f"Scan({','.join(map(str, node.output_types))})"
    if isinstance(node, nd.Project):
        return f"Proj({','.join(expr_sig(e, node_ids) for e in node.exprs)})"
    if isinstance(node, nd.Filter):
        return f"Filter({expr_sig(node.condition, node_ids)})"
    if isinstance(node, nd.Aggregate):
        keys = ",".join(expr_sig(e, node_ids) for e in node.keys)
        aggs = ",".join(expr_sig(e, node_ids) for e in node.aggs)
        return f"Agg([{keys}][{aggs}])"
    if isinstance(node, nd.Join):
        pairs = ",".join(f"{expr_sig(l, node_ids)}={expr_sig(r, node_ids)}"
                         for l, r in node.key_pairs)
        res = expr_sig(node.residual, node_ids) if node.residual else ""
        return f"Join:{node.join_type.value}({pairs})({res})"
    if isinstance(node, nd.Sort):
        sf = ",".join(f"{f.field_index}:{f.desc}:{f.nulls_first}"
                      for f in node.sort_fields)
        return f"Sort({sf},{node.limit},{node.offset})"
    return kind


def data_plan_sig(node: nd.Node) -> str:
    """DATA-level structural signature of a whole subtree.

    Unlike the code-cache signatures (schema-only scans: same compiled
    program for same shapes), this identifies the VALUES a subtree
    produces: scans carry table identity, row count and data
    generation, so the signature is a sound recycling key for derived
    artifacts — join hash tables, value tables — across executions
    (reference: HashtableRecycler keyed by plan hash + table
    generations, DataRecycler/HashtableRecycler.h:32 and
    QueryPlanDagCache.h:61)."""
    memo: dict = {}

    def rec(n: nd.Node) -> str:
        got = memo.get(n.id)
        if got is not None:
            return got
        ids = {i.id: f"I{k}" for k, i in enumerate(n.inputs)}
        if isinstance(n, nd.Scan):
            t = n.table
            s = (f"DScan({getattr(t, 'table_id', id(t))}:{t.name}:"
                 f"{t.nrows}:g{getattr(t, 'generation', 0)})")
        elif isinstance(n, nd.LogicalValues):
            s = "DValues(" + _h([repr(n.rows), repr(n.output_types)]) + ")"
        elif isinstance(n, nd.Unnest):
            s = f"DUnnest({n.field_index})"
        elif isinstance(n, nd.LogicalUnion):
            s = f"DUnion({n.all})"
        else:
            s = node_sig(n, ids)
        kids = ",".join(rec(i) for i in n.inputs)
        out = _h([s, kids])
        memo[n.id] = out
        return out

    return rec(node)


class CodeCache:
    """LRU of compiled step callables keyed by plan signature
    (reference: CodeCacheAccessor, cache.code_cache_size)."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = capacity
        self._cache: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: str, build: Callable[[], Any]) -> Any:
        got = self._cache.get(key)
        if got is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return got
        self.misses += 1
        fn = build()
        self._cache[key] = fn
        if len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return fn


def chain_key(source_sig: str, chain: list, terminal: Optional[nd.Node],
              extra: str = "") -> str:
    """Cache key for a fused step: source schema + chain node sigs +
    terminal sig (positional node ids make it instance-independent)."""
    node_ids = {}
    counter = 0
    parts = [source_sig]
    all_nodes = list(chain) + ([terminal] if terminal is not None else [])
    # assign positions: source inputs referenced inside exprs
    for n in all_nodes:
        for inp in n.inputs:
            if inp.id not in node_ids:
                node_ids[inp.id] = f"n{counter}"
                counter += 1
        parts.append(node_sig(n, node_ids))
        node_ids[n.id] = f"n{counter}"
        counter += 1
    parts.append(extra)
    return _h(parts)
