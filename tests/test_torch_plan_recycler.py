"""Skipping a join's build subtree whose build tables are recycled, the
port against the JAX package: the cases of tests/test_plan_recycler.py
as twin tests (a warm run of a TPC-H Q3-shaped query skips its filtered
build subtree and takes the label "perfect(recycled)"; an append
invalidates the recycled tables; a disabled cache never skips; every
repetition equals a fresh session), and the port's own paths next to a
skip: EXPLAIN ANALYZE, a pruned probe scan and the eager-aggregation plan
A/B.  Tolerances: see tests/torch_twin.py."""

import numpy as np
import pytest

import hdk_tpu_torch
from torch_twin import assert_same, twin_sessions

EAGER = {"exec.eager_agg_min_rows": 500, "exec.eager_agg_min_ratio": 1.0}

Q = ("SELECT l.ok, SUM(l.price) AS rev, o.pri "
     "FROM rc_l l, rc_o o, rc_c c "
     "WHERE l.ok = o.ok AND o.ck = c.ck AND c.seg = 2 "
     "GROUP BY l.ok, o.pri ORDER BY rev DESC LIMIT 5")


def _q3ish(seed=5, n_c=300, n_o=3000, n_l=12000):
    rng = np.random.default_rng(seed)
    return {
        "rc_c": {"ck": np.arange(n_c, dtype=np.int64),
                 "seg": rng.integers(0, 5, n_c).astype(np.int64)},
        "rc_o": {"ok": np.arange(n_o, dtype=np.int64),
                 "ck": rng.integers(0, n_c, n_o),
                 "pri": rng.integers(0, 3, n_o).astype(np.int64)},
        "rc_l": {"ok": rng.integers(0, n_o, n_l),
                 "price": rng.gamma(3.0, 100.0, n_l)},
    }


def _both(jx, pt, sql=Q):
    """Run ``sql`` in both sessions: both results equal, both route
    labels equal; returns the port's label."""
    want, got = jx.sql(sql), pt.sql(sql)
    assert_same(want, got)
    assert jx._executor._join_route == pt._executor._join_route
    return pt._executor._join_route


def test_second_run_skips_build_subtree():
    jx, pt = twin_sessions(_q3ish(), **EAGER)
    _both(jx, pt)
    assert not jx._executor._join_skip_rhs
    assert not pt._executor._join_skip_rhs, "no skip on the cold run"
    assert _both(jx, pt) == "perfect(recycled)"
    assert jx._executor._join_skip_rhs
    assert pt._executor._join_skip_rhs, "the warm run ran its build side"


def test_append_invalidates_recycled_artifacts():
    jx, pt = twin_sessions(_q3ish(), **EAGER)
    for _ in range(2):
        _both(jx, pt)
    assert pt._executor._join_skip_rhs
    rng = np.random.default_rng(6)
    extra = {
        "rc_c": {"ck": np.arange(300, 340, dtype=np.int64),
                 "seg": np.full(40, 2, dtype=np.int64)},
        "rc_o": {"ok": np.arange(3000, 3100, dtype=np.int64),
                 "ck": rng.integers(300, 340, 100).astype(np.int64),
                 "pri": np.zeros(100, dtype=np.int64)},
        "rc_l": {"ok": rng.integers(3000, 3100, 400).astype(np.int64),
                 "price": 1e7 + rng.uniform(0, 1e6, 400)},
    }
    for name, data in extra.items():
        jx.append_pydict(name, data)
        pt.append_pydict(name, data)
    _both(jx, pt)
    assert not jx._executor._join_skip_rhs
    assert not pt._executor._join_skip_rhs, "stale artifacts after append"
    assert pt.sql(Q).to_numpy()["rev"][0] > 1e7  # the appended rows count


def test_disabled_cache_never_skips():
    jx, pt = twin_sessions(_q3ish(),
                           **{**EAGER, "cache.enable_hashtable_cache": False})
    for _ in range(3):
        assert _both(jx, pt) == "perfect"
        assert not pt._executor._join_skip_rhs


def test_recycled_route_matches_fresh_session():
    tables = _q3ish()
    jx, pt = twin_sessions(tables, **EAGER)
    fresh = hdk_tpu_torch.HDK(device="cpu", **EAGER)
    for name, data in tables.items():
        fresh.import_pydict(data, name=name)
    first = fresh.sql(Q)
    for _ in range(4):
        want, got = jx.sql(Q), pt.sql(Q)
        assert jx._executor._join_route == pt._executor._join_route
        assert_same(want, got)
        assert_same(first, got)


# -- the port's own paths next to a skip -------------------------------------

def test_skip_under_explain_analyze():
    """EXPLAIN ANALYZE of a warm run times the join over the recycled
    tables; the skipped build nodes say they did not run."""
    jx, pt = twin_sessions(_q3ish())
    for _ in range(2):
        _both(jx, pt)
    assert pt._executor._join_skip_rhs
    text = pt.explain(Q, analyze=True)
    assert pt._executor._join_skip_rhs
    assert pt._executor._join_route == "perfect(recycled)"
    lines = text.splitlines()
    joins = [ln for ln in lines if "Join[inner]" in ln]
    recycled = [ln for ln in lines if ln.endswith("[recycled: not run]")]
    assert recycled, text
    # the top join ran and is timed; each skipped line is a build node
    assert " ms, " in joins[0] and joins[0].rstrip().endswith("rows]")
    assert all("Scan(" not in ln for ln in recycled)
    assert any("Filter((seg" in ln for ln in recycled), text


def test_skip_next_to_a_pruned_probe_scan():
    """The probe scan is cut to the fragments its Filter can match while
    the build subtree is skipped; the build side never reaches fragment
    skipping."""
    from hdk_tpu_torch.ir import node as nd

    tables = _q3ish()
    li = tables["rc_l"]
    order = np.argsort(li["ok"], kind="stable")
    tables["rc_l"] = {c: v[order] for c, v in li.items()}  # ok-ordered
    sql = Q.replace("WHERE ", "WHERE l.ok < 700 AND ")
    jx, pt = twin_sessions(tables, **{"storage.fragment_size": 2000})
    _both(jx, pt, sql)
    assert pt._executor._frag_prune_stats == {"selected": 2, "total": 6}
    ex = pt._executor
    pruned = []
    orig = ex._maybe_prune_scan

    def spy(src_node, chain, results):
        out = orig(src_node, chain, results)
        if isinstance(src_node, nd.Scan):
            pruned.append(src_node.table.name)
        return out

    ex._maybe_prune_scan = spy
    assert _both(jx, pt, sql) == "perfect(recycled)"
    assert ex._join_skip_rhs
    assert (ex._frag_prune_stats == jx._executor._frag_prune_stats
            == {"selected": 2, "total": 6})
    # the probe side was pruned; the skipped build side never resolved
    assert "rc_l" in pruned and "rc_c" not in pruned


def test_eager_aggregation_plan_ab_with_recycling():
    """The plan A/B runs the rewrite cold and timed, then the original
    cold and timed, then the faster plan: every run equals the reference
    with the same label.  Each plan's joins key their artifacts by their
    own build subtree's data-plan signature (subtrees that are the same
    in both plans share them), so each warm run skips its build subtree
    and builds nothing."""
    from hdk_tpu_torch.ir import node as nd

    jx, pt = twin_sessions(_q3ish(), **EAGER)
    ex = pt._executor
    keys = []
    orig = ex._plan_recycle_skips

    def spy(order):
        keys.append({n.id: ex._join_build_plan_sig(n) for n in order
                     if isinstance(n, nd.Join)})
        return orig(order)

    ex._plan_recycle_skips = spy
    labels = [_both(jx, pt) for _ in range(4)]
    assert labels[0] == labels[2] == "perfect"  # each plan's cold run
    assert labels[1] == labels[3] == "perfect(recycled)"  # its timed run
    plan_sigs = [s for s in ex._feedback._t if s[0].startswith("eagerplan|")]
    assert {v for _, v in plan_sigs} == {"rewrite", "original"}
    # the two plans are different DAGs; a recycled table reaches a join
    # only under its own build subtree's key
    assert not set(keys[0]) & set(keys[2])
    assert not pt._executor._join_skip_rhs.keys() - set(keys[3])
    builds = ex._join_builds
    for _ in range(2):
        assert _both(jx, pt) == "perfect(recycled)"
        assert ex._join_skip_rhs
    assert ex._join_builds == builds
