"""Plan text for EXPLAIN and EXPLAIN ANALYZE (counterpart of
hdk_tpu/exec/explain.py's ``explain_dag``).

``explain_dag`` renders the relational plan tree, root first, one node a
line; EXPLAIN ANALYZE appends each node's measurements in brackets.  The
JAX package's ``explain_lowered`` (the XLA HLO of a step) has no
counterpart: a step here is a Python closure over eager torch calls, not
a compiled program.
"""

from __future__ import annotations

from typing import List

from ..ir import node as nd


def _node_line(node: nd.Node) -> str:
    if isinstance(node, nd.Scan):
        return f"Scan({node.table.name}, rows={node.table.nrows})"
    if isinstance(node, nd.Project):
        exprs = ", ".join(
            f"{f}={e.to_str()}" for f, e in zip(node.fields, node.exprs))
        return f"Project({exprs})"
    if isinstance(node, nd.Filter):
        return f"Filter({node.condition.to_str()})"
    if isinstance(node, nd.Aggregate):
        keys = ", ".join(k.to_str() for k in node.keys)
        aggs = ", ".join(a.to_str() for a in node.aggs)
        return f"Aggregate(keys=[{keys}], aggs=[{aggs}])"
    if isinstance(node, nd.Join):
        pairs = ", ".join(f"{l.to_str()}={r.to_str()}"
                          for l, r in node.key_pairs)
        res = (f", residual={node.residual.to_str()}"
               if node.residual is not None else "")
        return f"Join[{node.join_type.value}]({pairs}{res})"
    if isinstance(node, nd.Sort):
        sf = ", ".join(
            f"{node.inputs[0].fields[f.field_index]}"
            f"{' desc' if f.desc else ''}" for f in node.sort_fields)
        lim = f", limit={node.limit}" if node.limit is not None else ""
        off = f", offset={node.offset}" if node.offset else ""
        return f"Sort({sf}{lim}{off})"
    if isinstance(node, nd.Unnest):
        return f"Unnest({node.fields[node.field_index]})"
    if isinstance(node, nd.LogicalUnion):
        return "UnionAll"
    if isinstance(node, nd.LogicalValues):
        return f"Values({len(node.rows)} rows)"
    return type(node).__name__


def explain_dag(root: nd.Node, annotations=None) -> str:
    """Indented plan tree, root first.  ``annotations``: {node.id: text}
    appended to a node's line in brackets (EXPLAIN ANALYZE's
    measurements)."""
    lines: List[str] = []

    def visit(node: nd.Node, depth: int) -> None:
        extra = ""
        if annotations and node.id in annotations:
            extra = f"  [{annotations[node.id]}]"
        lines.append("  " * depth + _node_line(node) + extra)
        for inp in node.inputs:
            visit(inp, depth + 1)

    visit(root, 0)
    return "\n".join(lines)
