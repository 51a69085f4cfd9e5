"""The port's main path against the JAX package: the same queries over the
same data through ``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device="cpu")``
(taxi Q1-Q4, TPC-H Q1/Q6, a NULL-heavy group-by, ORDER BY ... LIMIT with
ties, result chaining).  Tolerances: see tests/torch_twin.py."""

import numpy as np
import pytest

import bench
from chip_smoke import NULLS_Q, TPCH_Q1, TPCH_Q6, gen_lineitem, gen_taxi
from torch_twin import assert_same, twin_sessions

TAXI_ROWS = 20_000


def _ts(t):
    return {"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)}


@pytest.fixture(scope="module")
def taxi():
    return twin_sessions({"trips": bench.gen_data(TAXI_ROWS)}, schema=_ts)


def _taxi_queries():
    """bench.py's Q1-Q4, written once for both packages."""
    def year(ht):
        return ht["pickup_datetime"].extract("year").name("y")

    return {
        "q1": lambda ht: ht.agg("cab_type", "count"),
        "q2": lambda ht: ht.agg("passenger_count", "avg(total_amount)"),
        "q3": lambda ht: ht.agg(["passenger_count", year(ht)], "count"),
        "q4": lambda ht: ht.agg(
            ["passenger_count", year(ht),
             ht["trip_distance"].cast("int32").name("dist")],
            "count").sort(("count", "desc")),
    }


def test_smoke_taxi_generator_matches_bench():
    """chip_smoke.py's own taxi columns equal bench.py's, value and dtype."""
    ours, theirs = gen_taxi(5000), bench.gen_data(5000)
    assert list(ours) == list(theirs)
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype, name
        assert np.array_equal(ours[name], theirs[name]), name


@pytest.mark.parametrize("q", ["q1", "q2", "q3", "q4"])
def test_taxi(taxi, q):
    jx, pt = taxi
    make = _taxi_queries()[q]
    assert_same(make(jx.scan("trips")).run(), make(pt.scan("trips")).run(),
                f32_avg=["total_amount_avg"])


@pytest.fixture(scope="module")
def lineitem():
    return twin_sessions({"lineitem": gen_lineitem(30_000)},
                         schema=lambda t: {"l_shipdate": t.timestamp(
                             t.TimeUnit.SECOND, False)})


@pytest.mark.parametrize("sql", [TPCH_Q1, TPCH_Q6], ids=["q1", "q6"])
def test_tpch(lineitem, sql):
    jx, pt = lineitem
    assert_same(jx.sql(sql), pt.sql(sql))


def _nullable(rng, n, values):
    """A list with 10% None, which both importers read as NULL."""
    keep = rng.random(n) >= 0.1
    return [v if k else None for v, k in zip(values.tolist(), keep)]


@pytest.fixture(scope="module")
def nulls():
    rng = np.random.default_rng(5)
    n = 5_000
    data = {
        "g": rng.integers(0, 1000, n),
        "x": _nullable(rng, n, rng.integers(-10**12, 10**12, n)),
        "y": _nullable(rng, n, rng.normal(50.0, 20.0, n)),
        "s": np.asarray(["ab", "b", "abc", "c", None], dtype=object)[
            rng.integers(0, 5, n)],
        "k": rng.integers(0, 4, n).astype(np.int32),
    }
    return twin_sessions({"t": data})


def test_nulls_query(nulls):
    jx, pt = nulls
    assert_same(jx.sql(NULLS_Q), pt.sql(NULLS_Q))


@pytest.mark.parametrize("sql", [
    # scalar aggregates over NULLs and a filter
    "SELECT COUNT(*), COUNT(x), SUM(x), MIN(x), MAX(y), AVG(y), "
    "STDDEV_SAMP(y), VAR_SAMP(x) FROM t WHERE k <> 2",
    # MIN/MAX/VAR/CORR per group, nullable dictionary keys
    "SELECT s, k, MIN(x), MAX(x), MIN(y), VAR_SAMP(y), CORR(x, y) FROM t "
    "GROUP BY s, k ORDER BY s, k",
    # CASE, LIKE and IN inside the group-by's chain
    "SELECT k, SUM(CASE WHEN s LIKE 'ab%' THEN 1 ELSE 0 END), "
    "COUNT(*) FROM t WHERE g IN (1, 5, 7, 500, 999) OR y > 60 "
    "GROUP BY k ORDER BY k",
], ids=["scalar", "minmax_corr", "case_like_in"])
def test_nulls_aggregates(nulls, sql):
    jx, pt = nulls
    assert_same(jx.sql(sql), pt.sql(sql))


@pytest.mark.parametrize("sql", [
    # many equal counts: ties must keep the JAX package's order
    "SELECT k, g, COUNT(*) AS c FROM t GROUP BY k, g "
    "ORDER BY c DESC LIMIT 7",
    "SELECT k, g, COUNT(*) AS c FROM t GROUP BY k, g "
    "ORDER BY c DESC, k LIMIT 11 OFFSET 3",
    # row sorts (no aggregate): single and multi key, NULLs, strings
    "SELECT g, x FROM t ORDER BY x DESC NULLS LAST LIMIT 9",
    "SELECT g, k, s FROM t ORDER BY k, s NULLS FIRST, g DESC LIMIT 25",
    "SELECT s, COUNT(*) FROM t GROUP BY s ORDER BY s DESC",
], ids=["agg_topn", "agg_topn_offset", "row_topn", "row_multikey",
        "dict_order"])
def test_order_limit_ties(nulls, sql):
    jx, pt = nulls
    assert_same(jx.sql(sql), pt.sql(sql))


def test_result_chaining(taxi):
    jx, pt = taxi
    out = []
    for hdk in (jx, pt):
        ht = hdk.scan("trips")
        res = ht.agg(["passenger_count", "cab_type"], "count",
                     "sum(trip_distance)").run()
        chained = res.scan
        out.append(chained.filter(chained["count"] > 1000)
                   .agg("passenger_count", "sum(count)").run())
    assert_same(*out)


@pytest.mark.parametrize("what", ["values", "unnest"])
def test_values_and_unnest_are_refused(taxi, what):
    """VALUES (a FROM-less SELECT) and UNNEST of an imported array column
    are no longer refused: each runs and equals the JAX package (the name
    is kept from when they raised; their tests:
    tests/test_torch_arrays.py)."""
    out = []
    for hdk in taxi:
        if what == "values":
            out.append(hdk.sql("SELECT 1 + 1 AS a"))
        else:
            out.append(hdk.import_pydict(
                {"id": [1, 2], "xs": [[1, 2], [3, 4]]},
                name=f"arr_{what}").unnest("xs").run())
    assert_same(*out)


def test_sort_based_groupby_is_refused(nulls):
    """The sort-based group-by is no longer refused: a float key runs and
    equals the JAX package (the name is kept from when the route raised;
    tests of the route: tests/test_torch_sortgroup.py)."""
    jx, pt = nulls
    sql = "SELECT y, COUNT(*) FROM t GROUP BY y"
    assert_same(jx.sql(sql), pt.sql(sql))
