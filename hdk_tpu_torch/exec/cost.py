"""Analytic cost model: cardinality estimation + physical strategy
choices.

Reference analogs:
  * omniscidb/QueryEngine/CostModel/CostModel.h:45 — per-device cost
    model fed by DWAA measurements; here an analytic model is the right
    shape (XLA owns microarchitectural scheduling, so the decisions
    that remain are *plan-level*: join input order, distributed join
    strategy, shuffle sizing).
  * omniscidb/QueryEngine/CardinalityEstimation.cpp — NDV estimation;
    here fragment min/max stats bound integer-key NDV and filters decay
    cardinality per conjunct.
  * omniscidb/QueryEngine/FromTableReordering.cpp — join ordering by
    estimated cardinality; consumed by
    exec/optimizer.reorder_join_inputs.
"""

from __future__ import annotations

from typing import Optional

from ..ir import expr as ir
from ..ir import node as nd

# selectivity decay per ANDed conjunct (the reference's
# FilterSelectivity heuristics use 0.1-0.5 by predicate shape)
FILTER_SELECTIVITY = 0.33
SEMI_SELECTIVITY = 0.5


def _count_conjuncts(e: ir.Expr) -> int:
    if isinstance(e, ir.BinOp) and e.kind == ir.BinOpKind.AND:
        return _count_conjuncts(e.lhs) + _count_conjuncts(e.rhs)
    return 1


def estimate_rows(node: nd.Node) -> float:
    """Estimated output rows; coarse but monotone, which is all the
    plan-level choices need (swap or not, broadcast or shuffle)."""
    if isinstance(node, nd.Scan):
        return float(node.table.global_nrows)
    if isinstance(node, nd.LogicalValues):
        return float(len(node.rows))
    if isinstance(node, nd.Project):
        return estimate_rows(node.inputs[0])
    if isinstance(node, nd.Filter):
        child = estimate_rows(node.inputs[0])
        sel = FILTER_SELECTIVITY ** _count_conjuncts(node.condition)
        return max(child * sel, 1.0)
    if isinstance(node, nd.Aggregate):
        child = estimate_rows(node.inputs[0])
        if not node.keys:
            return 1.0
        ndv = _ndv_bound(node)
        if ndv is not None:
            return float(min(child, ndv))
        # unknown-range keys: sublinear group growth (Execute.cpp's
        # baseline estimator defaults in the same spirit)
        return max(child ** 0.75, 1.0)
    if isinstance(node, nd.Join):
        l = estimate_rows(node.inputs[0])
        r = estimate_rows(node.inputs[1])
        if node.join_type == nd.JoinType.INNER:
            if not node.key_pairs:  # cartesian loop join
                return l * r
            return max(l, r)  # FK-join assumption
        if node.join_type == nd.JoinType.LEFT:
            return l
        return max(l * SEMI_SELECTIVITY, 1.0)  # SEMI/ANTI
    if isinstance(node, nd.Sort):
        child = estimate_rows(node.inputs[0])
        if node.limit is not None:
            return float(min(child, node.limit))
        return child
    if isinstance(node, nd.LogicalUnion):
        return sum(estimate_rows(i) for i in node.inputs)
    return 1.0


def _ndv_bound(agg: nd.Aggregate) -> Optional[float]:
    """Upper bound on distinct groups from key-range products (range
    stats bound integer NDV: |[lo, hi]| values at most)."""
    from . import ranges as rng

    prod = 1.0
    for k in agg.keys:
        if k.type.is_dict_encoded_string():
            # dictionary size bounds string NDV exactly
            from ..ir.expr import ColumnRef

            if isinstance(k, ColumnRef):
                prod *= max(_dict_size_bound(k), 1)
                continue
        r = rng.infer_range(k)
        if r is None:
            return None
        lo, hi, has_nulls = r
        prod *= (hi - lo + 1) + (1 if has_nulls else 0)
        if prod > 1e18:
            return prod
    return prod


def _dict_size_bound(ref) -> int:
    """Code-range upper bound for a dict-encoded key (codes are dense,
    so max_code + 1 >= NDV; falls back to a large constant)."""
    r = None
    try:
        from . import ranges as rng

        r = rng.infer_range(ref)
    except Exception:
        pass
    if r is not None:
        lo, hi, has_nulls = r
        return int(hi - lo + 1) + (1 if has_nulls else 0)
    return 1 << 20


def should_swap_join(join: nd.Join, threshold: float = 1.5) -> bool:
    """True when the probe (lhs) is estimated smaller than the build
    (rhs) by ``threshold`` — the sorted-hash join builds on rhs, so the
    bigger side belongs on the left (reference:
    FromTableReordering.cpp cardinality-ordered traversal)."""
    if join.join_type != nd.JoinType.INNER or not join.key_pairs:
        return False
    l = estimate_rows(join.inputs[0])
    r = estimate_rows(join.inputs[1])
    return r > l * threshold


def dist_join_strategy(lhs_rows: int, rhs_rows: int, n_dev: int,
                       broadcast_limit: int) -> str:
    """'broadcast' replicates the build side to every shard (cheap when
    the build side is small: n_dev * rhs bytes over ICI); 'partition'
    shuffles both sides by key hash (each row crosses ICI once).
    ``broadcast_limit`` is a per-device MEMORY cap on the replicated
    build side — ICI traffic alone must not override it (a 5e8-row
    build replicated per device would exhaust HBM).  Reference analog:
    per-device replicas in PerfectJoinHashTable.cpp vs partitioned
    fragments."""
    if rhs_rows > broadcast_limit:
        return "partition"
    # within the cap the replicated build wins: one collective, no
    # probe-side shuffle, and the per-device table stays small
    return "broadcast"
