"""Aggregate -> Sort as one step in the port, against the JAX package (the
twin of tests/test_fused_agg_sort.py): the same numpy data through
``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device="cpu")``.  The group
buffer is ordered with dead groups last, fully without a LIMIT and by
the streaming top-n with one (``_topn_route``); the last three tests run
the dense route's fused sort in 8-shard sessions (JAX's 8 virtual CPU
devices, 8 CPU shards in the port), route ``dense_psum_fused_sort``.

Row order is exact: keys and counts equal, float aggregates (multiples
of 1/8) to rtol 1e-9 (``torch_twin.assert_same``)."""

import numpy as np
import pytest

import jax

from torch_twin import assert_same, twin_sessions

DIST = {"dist.enable": True, "dist.num_devices": 8}
needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 (virtual) devices")


def _data(n=20000):
    rng = np.random.default_rng(19)
    return {"pc": rng.integers(0, 9, n), "yr": rng.integers(2013, 2017, n),
            "dist": rng.integers(0, 40, n),
            "amt": np.round(rng.normal(15, 5, n) * 8) / 8,
            "big": rng.integers(0, 3000, n) * 2**33 + 1}


@pytest.fixture(scope="module")
def twins():
    return twin_sessions({"q4_t": _data()})


def _both(pair, make, route, table="q4_t"):
    jx, pt = pair
    got = make(pt.scan(table)).run()
    assert_same(make(jx.scan(table)).run(), got, ordered=True)
    assert pt._executor._topn_route == route
    return got


def q4(t, limit=None):
    return t.agg(["pc", "yr", "dist"], "count").sort(("count", "desc"),
                                                     limit=limit)


def test_q4_shape_fused(twins):
    _both(twins, q4, "full")


def test_q4_with_limit(twins):
    got = _both(twins, lambda t: q4(t, 10), "streaming")
    assert got.row_count == 10


def test_fused_multikey_sort_with_tiebreak(twins):
    _both(twins, lambda t: t.agg(["pc", "yr"], "count", "avg(amt)").sort(
        ("count", "desc"), "pc", ("yr", "desc")), "full")


def test_fused_baseline_layout_high_ndv(twins):
    """A key range above the dense limit: the sort-route GROUP BY, its
    buffer through the streaming top-n."""
    _both(twins, lambda t: t.agg("big", "count", "sum(amt)").sort(
        ("count", "desc"), ("big", "desc"), limit=25), "streaming")


def test_fused_overflow_retry():
    """A group buffer of 16 overflows, widens and runs again."""
    rng = np.random.default_rng(29)
    n = 4000
    pair = twin_sessions(
        {"fo": {"k": rng.integers(0, 700, n) * 2**33,
                "v": np.round(rng.normal(size=n) * 8) / 8}},
        **{"exec.group_by.default_max_groups": 16})
    _both(pair, lambda t: t.agg("k", "count").sort(("count", "desc"), "k"),
          "full", table="fo")


def test_agg_sort_sql(twins):
    jx, pt = twins
    sql = ("SELECT pc, yr, COUNT(*) AS c FROM q4_t GROUP BY pc, yr "
           "ORDER BY c DESC, pc, yr LIMIT 7")
    assert_same(jx.sql(sql), pt.sql(sql), ordered=True)
    assert pt._executor._topn_route == "streaming"


def test_agg_used_twice_not_fused(twins):
    """One aggregate node feeding a sort through the builder's chaining."""
    jx, pt = twins
    got = pt.scan("q4_t").agg("pc", "count").sort(("count", "desc")).run()
    want = jx.scan("q4_t").agg("pc", "count").sort(("count", "desc")).run()
    assert_same(want, got, ordered=True)


@pytest.fixture(scope="module")
def dist_twins():
    return twin_sessions({"q4_dist": _data()}, **DIST)


def _dist_route(pair):
    for s in pair:
        assert s._executor._dist_agg_route == "dense_psum_fused_sort", (
            s._executor._dist_agg_route)


@needs_8
def test_dist_fused_agg_sort_route_and_result(dist_twins):
    _both(dist_twins, q4, "full", table="q4_dist")
    _dist_route(dist_twins)


@needs_8
def test_dist_fused_agg_sort_limit(dist_twins):
    got = _both(dist_twins, lambda t: q4(t, 10), "streaming",
                table="q4_dist")
    _dist_route(dist_twins)
    assert got.row_count == 10


@needs_8
def test_dist_fused_agg_sort_avg_asc_nulls():
    """AVG and SUM over a column with NULLs, ordered ascending by the
    average: 8 shards against one device, in each package."""
    rng = np.random.default_rng(37)
    n = 5000
    v = np.round(rng.normal(size=n) * 8) / 8
    data = {"k": rng.integers(0, 7, n),
            "v": [None if nul else float(x)
                  for x, nul in zip(v, rng.random(n) < 0.1)]}
    dist = twin_sessions({"fd": data}, **DIST)
    solo = twin_sessions({"fd": data})
    sql = "SELECT k, AVG(v) AS m, SUM(v) AS s FROM fd GROUP BY k ORDER BY m"
    got = dist[1].sql(sql)
    assert_same(dist[0].sql(sql), got, ordered=True)
    assert_same(solo[1].sql(sql), got, ordered=True)
    _dist_route(dist)
