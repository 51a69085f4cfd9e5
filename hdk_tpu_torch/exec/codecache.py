"""Plan signatures: structural hashes of plans and of the data they read.

Reference: the plan-DAG hashes of QueryPlanDagCache.h:61 and
RelAlgExecutionUnit.h:64-88.  They key work worth keeping across
queries: recycled join build tables (``data_plan_sig``), the key-range
probe, the NDV sample and measured route feedback (``chain_key``).
PyTorch runs eagerly, so no compiled step is cached: a step runs its
body for the query in hand.  The module keeps the JAX package's name,
``exec/codecache.py``, where its signatures also key ``jax.jit``'s
step cache.
"""

from __future__ import annotations

import hashlib
from typing import Optional

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

    Unlike ``chain_key`` (schema-only scans: same-shaped scans of
    different tables share a key), this identifies the VALUES a subtree
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


def chain_key(source_sig: str, chain: list, terminal: Optional[nd.Node],
              extra: str = "") -> str:
    """Key of a fused step's plan: source schema + chain node sigs +
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
