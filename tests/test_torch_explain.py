"""EXPLAIN and EXPLAIN ANALYZE, the port against the JAX package: the
plan text of each query shape equals ``hdk_tpu``'s (builder and SQL
queries, filters, aggregates, sorts, joins, windows, UNION ALL, VALUES,
UNNEST), through ``HDK.explain``, the ``EXPLAIN`` prefix and the
``just_explain`` option; EXPLAIN ANALYZE gives every line its time and
rows, and the rows of each line the JAX package annotates equal its."""

import re

import numpy as np
import pytest

import hdk_tpu_torch
from torch_twin import assert_same, twin_sessions


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(21)
    n = 3000
    return twin_sessions({
        "t": {"g": rng.integers(0, 7, n), "v": rng.normal(size=n),
              "i": rng.integers(-50, 50, n).astype(np.int32)},
        "r": {"k": np.arange(7), "w": rng.normal(size=7)},
        "arr": {"id": [1, 2, 3], "xs": [[1, 2], [3], [4, 5, 6]]},
    })


SQL = {
    "sql_group_order_limit": "SELECT g, COUNT(*) AS c FROM t WHERE v > 0 "
                             "GROUP BY g ORDER BY c DESC LIMIT 3",
    "sql_scalar_agg": "SELECT COUNT(*) AS c, AVG(v) AS a FROM t",
    "sql_sort_limit": "SELECT g, v FROM t ORDER BY v DESC LIMIT 5",
    "sql_inner_join": "SELECT t.g, SUM(r.w) AS s FROM t JOIN r "
                      "ON t.g = r.k GROUP BY t.g",
    "sql_left_join": "SELECT t.i, r.w FROM t LEFT JOIN r ON t.g = r.k "
                     "WHERE t.i > 40",
    "sql_in_subquery": "SELECT COUNT(*) AS c FROM t WHERE g IN "
                       "(SELECT k FROM r WHERE w > 0)",
    "sql_window": "SELECT g, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) "
                  "AS rn FROM t",
    "sql_union_all": "SELECT g FROM t WHERE i > 45 UNION ALL SELECT k FROM r",
    "sql_values": "SELECT 1 + 1 AS a, 2.5 AS b",
    "sql_unnest": "SELECT id, e FROM arr, UNNEST(xs) AS e ORDER BY id, e",
}

BUILDER = {
    "builder_agg": lambda h: h.scan("t").agg("g", "count", "sum(v)"),
    "builder_filter_proj": lambda h: (lambda t: t.filter(t["i"] > 0).proj(
        "g", "v"))(h.scan("t")),
    "builder_sort": lambda h: h.scan("t").sort(("v", "desc"), limit=4),
    "builder_unnest": lambda h: h.scan("arr").unnest("xs"),
}


def _query(h, name):
    return SQL[name] if name in SQL else BUILDER[name](h)


@pytest.mark.parametrize("name", sorted(SQL) + sorted(BUILDER))
def test_plan_text_equals_reference(twins, name):
    jx, pt = twins
    text = pt.explain(_query(pt, name))
    assert text == jx.explain(_query(jx, name))
    assert " ms, " not in text and "-- " not in text


@pytest.mark.parametrize("name", sorted(SQL))
def test_explain_prefix_and_just_explain(twins, name):
    jx, pt = twins
    want = jx.sql(SQL[name], just_explain=True)
    assert pt.sql(SQL[name], just_explain=True) == want
    assert pt.sql("EXPLAIN " + SQL[name]) == want
    assert pt.sql("  explain " + SQL[name]) == jx.sql("EXPLAIN " + SQL[name])


def test_builder_just_explain(twins):
    jx, pt = twins
    assert (BUILDER["builder_agg"](pt).run(just_explain=True)
            == BUILDER["builder_agg"](jx).run(just_explain=True))


_NOTE = re.compile(r"^(\s*)(.*?)(?:  \[(.*)\])?$")


def _lines(text):
    """(plan line, annotation or None) of each plan line."""
    out = []
    for line in text.split("\n-- ")[0].splitlines():
        m = _NOTE.match(line)
        out.append((m.group(1) + m.group(2), m.group(3)))
    return out


def _rows(note):
    return int(re.search(r"(\d+) rows$", note).group(1))


@pytest.mark.parametrize("name", ["sql_group_order_limit", "sql_scalar_agg",
                                  "sql_sort_limit", "sql_in_subquery",
                                  "sql_window", "sql_union_all",
                                  "builder_agg", "builder_filter_proj",
                                  "builder_unnest"])
def test_analyze_rows_equal_reference(twins, name):
    """Every line of the port's EXPLAIN ANALYZE carries [ms, rows]; the
    lines the JAX package annotates have its row counts."""
    jx, pt = twins
    got = pt.explain(_query(pt, name), analyze=True)
    want = jx.explain(_query(jx, name), analyze=True)
    g, w = _lines(got), _lines(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (plan, gn), (_, wn) in zip(g, w):
        assert gn is not None and re.search(r"[\d.]+ ms, \d+ rows$", gn), \
            plan
        if wn is not None:
            assert _rows(gn) == _rows(wn), (plan, gn, wn)
    assert "step builds" not in got  # the port compiles no step


def test_analyze_fused_filter_reports_its_live_rows(twins):
    _jx, pt = twins
    q = pt.scan("t")
    q = q.filter(q["i"] > 0).agg("g", "count")
    text = pt.explain(q, analyze=True)
    filt = next(n for p, n in _lines(text) if p.strip().startswith("Filter"))
    i = pt._schema.get("t").column("i").data
    assert filt.startswith("in the Aggregate step: ")
    assert _rows(filt) == int((i > 0).sum())


def test_analyze_runs_the_query_and_the_result_stands(twins):
    """EXPLAIN ANALYZE leaves the session as it was: the next run of the
    query gives the same answer as the JAX package."""
    jx, pt = twins
    pt.explain(SQL["sql_inner_join"], analyze=True)
    assert not pt._executor._analyze
    assert_same(jx.sql(SQL["sql_inner_join"]), pt.sql(SQL["sql_inner_join"]),
                ordered=False)


def test_analyze_reports_the_ndv_sample():
    """The sampling line reports the NDV sample's host time where the
    group-by sampled."""
    rng = np.random.default_rng(2)
    pt = hdk_tpu_torch.HDK(device="cpu", **{
        "exec.group_by.ndv_sample_min_rows": 1 << 20})
    # the sample sizes a sort-route buffer over more than 2^20 rows
    t = pt.import_pydict({"h": rng.integers(0, 10**6, (1 << 20) + 1000)
                          * 0.5}, name="ndv")
    text = pt.explain(t.agg("h", "count"), analyze=True)
    assert "-- sampling estimators (NDV): " in text
    assert pt._executor._ndv_sample_seconds > 0
