"""Subqueries and SQL shapes that bind to joins and unions, against the
JAX package: IN / NOT IN / EXISTS (SEMI and ANTI joins), correlated
subqueries (SEMI, ANTI and LEFT joins on the correlation keys, NOT IN's
per-group three-valued logic), SQL joins, comma FROM lists, set
operations and GROUPING SETS (UNION ALL), and TPC-H Q3 at a few thousand
rows, each through ``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device=
"cpu")`` over the same seeded numpy tables (the cases of
tests/test_sql.py, tests/test_correlated.py and
tests/test_advice_fixes.py that reach a join).  Tolerances: see
tests/torch_twin.py."""

import numpy as np
import pytest

from chip_smoke import TPCH_Q3, gen_tpch_q3, q3_oracle, q3_schema
from torch_twin import assert_same, twin_sessions

Q3_SCALE = 1e-4  # 150 customers, 1500 orders, 6000 lineitem rows


def _tables():
    rng = np.random.default_rng(47)
    n = 2000
    vn = np.round(rng.normal(50, 20, n), 6).tolist()
    for i in np.flatnonzero(rng.random(n) < 0.1):
        vn[i] = None
    na, nb = 800, 300
    wn = rng.integers(0, 100, nb)
    wn_null = rng.random(nb) < 0.15
    bk = np.arange(4000, dtype=np.int64)
    bk[-1] = 50_000_000  # base-table stats far past the perfect range
    return {
        # tests/test_sql.py
        "t": {"k": rng.integers(0, 8, n), "g": rng.integers(0, 1000, n),
              "v": np.round(rng.normal(50, 20, n), 6),
              "w": rng.integers(-50, 50, n),
              "s": rng.choice(["red", "green", "blue", "cyan"], n),
              "vn": vn},
        "dim": {"k": np.arange(6), "label": ["a", "b", "c", "d", "e", "f"],
                "mult": [1, 2, 3, 4, 5, 6]},
        "c3t": {"ck": np.arange(20), "seg": rng.integers(0, 3, 20)},
        "o3t": {"ok": np.arange(50), "ock": rng.integers(0, 20, 50)},
        "l3t": {"lok": rng.integers(0, 50, 200),
                "price": rng.integers(1, 100, 200).astype(np.float32)},
        # tests/test_correlated.py
        "a": {"k": rng.integers(0, 12, na), "v": rng.integers(0, 100, na),
              "x": np.round(rng.normal(10, 5, na), 6)},
        "b": {"k": rng.integers(0, 15, nb), "w": wn,
              "wn": [None if z else float(x) for x, z in zip(wn, wn_null)]},
        # tests/test_advice_fixes.py
        "ni_t": {"a": [1.0, 2.0, 3.0, 4.0, None], "tag": list("vwxyz")},
        "ni_s": {"b": [2.0, None]},
        "ni_sn": {"b": [2.0, 4.0]},
        "adv_sb": {"k": bk, "w": rng.normal(size=4000)},
        "adv_sp": {"k": rng.integers(0, 200, 5000),
                   "v": rng.normal(size=5000)},
    }


@pytest.fixture(scope="module")
def sessions():
    return twin_sessions(_tables())


@pytest.fixture(scope="module")
def q3_sessions():
    customer, orders, lineitem = gen_tpch_q3(Q3_SCALE)
    tables = {"customer3": customer, "orders3": orders,
              "lineitem3": lineitem}
    out = []
    # eager aggregation forced at this size (the optimizer pushes the
    # GROUP BY below the lineitem join only above 2^23 estimated rows)
    for extra in ({}, {"exec.eager_agg_min_rows": 1,
                       "exec.eager_agg_min_ratio": 1.0}):
        out.append(_q3_twin(tables, **extra))
    return out


def _q3_twin(tables, **config):
    import hdk_tpu
    import hdk_tpu_torch

    jx = hdk_tpu.HDK(**config)
    pt = hdk_tpu_torch.HDK(device="cpu", **config)
    for s, mod in ((jx, hdk_tpu), (pt, hdk_tpu_torch)):
        for name, data in tables.items():
            s.import_pydict(data, name=name,
                            schema=q3_schema(mod.types, name))
    return jx, pt


QUERIES = {
    # tests/test_sql.py
    "inner_join": ("SELECT t.k, t.v, dim.label FROM t "
                   "JOIN dim ON t.k = dim.k WHERE t.v > 60"),
    "left_join": "SELECT t.k, dim.label FROM t LEFT JOIN dim ON t.k = dim.k",
    "join_aliases": ("SELECT a.k, b.mult FROM t a JOIN dim b ON a.k = b.k "
                     "WHERE a.w > 25"),
    "implicit_join": ("SELECT t.k, dim.label FROM t, dim "
                      "WHERE t.k = dim.k AND t.v > 70"),
    "join_group": ("SELECT dim.label, COUNT(*) AS c, SUM(t.v) AS s FROM t "
                   "JOIN dim ON t.k = dim.k GROUP BY dim.label"),
    "semi_join": "SELECT k FROM t SEMI JOIN dim ON t.k = dim.k",
    "anti_join": "SELECT k FROM t ANTI JOIN dim ON t.k = dim.k",
    "in_subquery": ("SELECT k, v FROM t WHERE k IN "
                    "(SELECT k FROM dim WHERE mult > 2)"),
    "not_in_subquery": ("SELECT k FROM t WHERE k NOT IN (SELECT k FROM dim) "
                        "AND w > 10"),
    "exists_subquery": ("SELECT k FROM t WHERE EXISTS "
                        "(SELECT k FROM dim WHERE mult > 100)"),
    "not_exists_subquery": ("SELECT COUNT(*) AS c FROM t WHERE NOT EXISTS "
                            "(SELECT k FROM dim WHERE mult > 100)"),
    "union_all": ("SELECT k FROM t WHERE k < 2 UNION ALL "
                  "SELECT k FROM t WHERE k > 6"),
    "union_distinct": ("SELECT k FROM t WHERE k < 4 UNION "
                       "SELECT k FROM t WHERE k > 2"),
    "intersect": ("SELECT k, s FROM t WHERE v > 40 INTERSECT "
                  "SELECT k, s FROM t WHERE w > 0"),
    "except": "SELECT k FROM t EXCEPT SELECT k FROM dim WHERE mult > 3",
    "except_intersect_precedence": (
        "SELECT k FROM t EXCEPT SELECT k FROM t WHERE k > 2 "
        "INTERSECT SELECT k FROM t WHERE k < 5"),
    "intersect_with_nulls": (
        "SELECT vn FROM t WHERE vn IS NULL OR vn > 70 INTERSECT "
        "SELECT vn FROM t WHERE vn IS NULL OR vn > 75"),
    "rollup": ("SELECT k, w, COUNT(*) AS c, SUM(v) AS s FROM t "
               "GROUP BY ROLLUP(k, w)"),
    "cube": ("SELECT k, w, COUNT(*) AS c, SUM(v) AS s FROM t "
             "GROUP BY CUBE(k, w)"),
    "grouping_sets": ("SELECT k, w, COUNT(*) AS c, SUM(v) AS s FROM t "
                      "GROUP BY GROUPING SETS ((k), (w))"),
    "grouping_sets_with_having": (
        "SELECT k, COUNT(*) AS c FROM t "
        "GROUP BY GROUPING SETS ((k), ()) HAVING COUNT(*) > 100"),
    "comma_join_three_tables": (
        "SELECT SUM(price) AS s, COUNT(*) AS n FROM c3t, o3t, l3t "
        "WHERE ck = ock AND lok = ok AND seg = 1"),
    # tests/test_correlated.py
    "correlated_exists": ("SELECT k, v FROM a WHERE EXISTS "
                          "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > 90)"),
    "correlated_not_exists": (
        "SELECT k, COUNT(*) AS c FROM a WHERE NOT EXISTS "
        "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > 95) GROUP BY k"),
    "correlated_in": ("SELECT k, v FROM a WHERE v IN "
                      "(SELECT w FROM b WHERE b.k = a.k)"),
    "correlated_not_in": ("SELECT k, v FROM a WHERE v NOT IN "
                          "(SELECT w FROM b WHERE b.k = a.k)"),
    "correlated_not_in_nullable": ("SELECT k, v FROM a WHERE v NOT IN "
                                   "(SELECT wn FROM b WHERE b.k = a.k)"),
    "correlated_scalar_agg": ("SELECT k, v FROM a WHERE v > "
                              "(SELECT AVG(w) FROM b WHERE b.k = a.k)"),
    "correlated_scalar_max_flipped_eq": (
        "SELECT k, v FROM a WHERE "
        "(SELECT MAX(w) FROM b WHERE a.k = b.k) < v + 10"),
    "correlated_scalar_count_empty_is_zero": (
        "SELECT k, COUNT(*) AS c FROM a WHERE "
        "(SELECT COUNT(*) FROM b WHERE b.k = a.k AND b.w > 50) = 0 "
        "GROUP BY k"),
    "correlated_scalar_in_arithmetic": (
        "SELECT k FROM a WHERE "
        "x + (SELECT AVG(w) FROM b WHERE b.k = a.k) > 60"),
    "correlated_with_extra_inner_filter": (
        "SELECT k, v FROM a WHERE EXISTS "
        "(SELECT 1 FROM b WHERE b.k = a.k AND b.w < 20)"),
    "two_correlated_predicates": (
        "SELECT k, v FROM a WHERE v > "
        "(SELECT AVG(w) FROM b WHERE b.k = a.k) AND EXISTS "
        "(SELECT 1 FROM b WHERE b.k = a.k AND b.w > 80)"),
    "uncorrelated_in": "SELECT k, v FROM a WHERE v IN (SELECT w FROM b)",
    "uncorrelated_scalar": ("SELECT k FROM a WHERE v > "
                            "(SELECT AVG(w) FROM b)"),
    # tests/test_advice_fixes.py
    "not_in_null_in_subquery": ("SELECT tag FROM ni_t "
                                "WHERE a NOT IN (SELECT b FROM ni_s)"),
    "not_in_null_probe": ("SELECT tag FROM ni_t "
                          "WHERE a NOT IN (SELECT b FROM ni_sn)"),
    "in_unaffected": "SELECT tag FROM ni_t WHERE a IN (SELECT b FROM ni_s)",
    "filtered_build_static_range_falls_back_to_probe": (
        "SELECT p.k, p.v, b.w FROM adv_sp p JOIN adv_sb b ON p.k = b.k "
        "WHERE b.k < 200"),
}

# the query orders its rows: compare them in order
ORDERED = {
    "union_all_order": ("SELECT k, w FROM t WHERE k = 0 UNION ALL "
                        "SELECT k, w FROM t WHERE k = 7 ORDER BY w LIMIT 9"),
    "union_then_order": ("SELECT k FROM t WHERE k = 1 UNION "
                         "SELECT k FROM t WHERE k IN (2, 3) ORDER BY k"),
}


def _route(s):
    """The route of the session's last equi-join; the reference's
    variants of the perfect route ("spread", "perfect(recycled)") read
    as "perfect"."""
    route = s._executor._join_route
    if route is None:
        return None
    return "perfect" if route.startswith(("perfect", "spread")) else route


@pytest.mark.parametrize("name", sorted(QUERIES) + sorted(ORDERED))
def test_query(sessions, name):
    jx, pt = sessions
    sql = QUERIES.get(name) or ORDERED[name]
    jx._executor._join_route = pt._executor._join_route = None
    want = jx.sql(sql)
    got = pt.sql(sql)
    assert _route(pt) == _route(jx)
    assert_same(want, got, ordered=name in ORDERED)


@pytest.fixture(scope="module")
def spread_port():
    """The port over the same tables with the spread route admitted at
    any probe size (``spread_join_min_rows`` 1)."""
    import hdk_tpu_torch

    pt = hdk_tpu_torch.HDK(device="cpu",
                           **{"exec.join.spread_join_min_rows": 1})
    for name, data in _tables().items():
        pt.import_pydict(data, name=name)
    return pt


@pytest.mark.parametrize("name", sorted(QUERIES) + sorted(ORDERED))
def test_demand_safety_sweep(sessions, spread_port, name):
    """Every query again in the port with the spread route admitted at any
    size: none pulls a column outside a spread output's demand set (those
    raise), and each equals the reference at its default settings (the
    routes may differ: the perfect table's range guard also reads
    ``spread_join_min_rows``)."""
    sql = QUERIES.get(name) or ORDERED[name]
    assert_same(sessions[0].sql(sql), spread_port.sql(sql),
                ordered=name in ORDERED)


def test_filtered_build_takes_the_perfect_route():
    """A filtered build whose base-table range fails the density guard
    falls back to a device min/max and takes the perfect route (in a
    fresh session: from the second run on the filtered build side is
    recycled)."""
    import hdk_tpu_torch

    pt = hdk_tpu_torch.HDK(device="cpu")
    for name, data in _tables().items():
        pt.import_pydict(data, name=name)
    for route in ("perfect", "perfect(recycled)"):
        pt.sql(QUERIES["filtered_build_static_range_falls_back_to_probe"])
        assert pt._executor._join_route == route


def test_correlated_non_equality_raises(sessions):
    jx, pt = sessions
    for s in (jx, pt):
        with pytest.raises(Exception):
            s.sql("SELECT k FROM a WHERE EXISTS "
                  "(SELECT 1 FROM b WHERE b.w < a.v)").to_arrow()


@pytest.mark.parametrize("eager", [False, True])
def test_tpch_q3(q3_sessions, eager):
    """TPC-H Q3 as bench_suite.py writes it, at a few thousand rows; with
    ``eager`` the GROUP BY is pushed below the lineitem join."""
    jx, pt = q3_sessions[int(eager)]
    want = jx.sql(TPCH_Q3)
    got = pt.sql(TPCH_Q3)
    assert _route(pt) == _route(jx) == "perfect"
    assert_same(want, got)
    assert got.row_count == 10


def test_tpch_q3_numpy_oracle(q3_sessions):
    """Q3 against chip_smoke.py's numpy oracle: the ten highest revenues,
    float32 products as the engine computes them, summed in float64."""
    _, pt = q3_sessions[0]
    customer, orders, lineitem = gen_tpch_q3(Q3_SCALE)
    top, revenue, _ = q3_oracle(customer, orders, lineitem)
    out = pt.sql(TPCH_Q3).to_numpy()
    assert np.array_equal(out["l_orderkey"], top)
    np.testing.assert_allclose(out["revenue"], revenue, rtol=1e-6)
    assert np.array_equal(out["o_orderdate"], orders["o_orderdate"][top])
    assert np.array_equal(out["o_shippriority"], orders["o_shippriority"][top])
