"""Multi-device joins, the port against the JAX package (the join half
of the twin of tests/test_dist_engine.py; tests/test_torch_dist_engine.py
holds the rest): broadcast joins of a build side under
``dist.broadcast_join_threshold`` rows, partitioned joins above it
(threshold 64 here), INNER, LEFT, SEMI and ANTI, a join feeding a sort,
on 8 CPU shards against JAX's 8 virtual devices.  Results compare with
``torch_twin.assert_same`` (integers exact, float64 rtol 1e-9) and the
port's ``_dist_join_route`` names the strategy taken."""

import numpy as np
import pytest

import jax

from torch_twin import assert_same, twin_sessions

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

DIST = {"dist.enable": True, "dist.num_devices": 8}


def _both(sessions, q, ordered=False):
    jx, pt = sessions
    a = jx.sql(q) if isinstance(q, str) else q(jx)
    b = pt.sql(q) if isinstance(q, str) else q(pt)
    assert_same(a, b, ordered=ordered)


@pytest.fixture(scope="module")
def join_pair():
    rng = np.random.default_rng(11)
    n = 8 * 400 + 3
    fact = {"k": rng.integers(0, 300, n).astype(np.int64),
            "v": rng.normal(size=n).round(3),
            "tag": rng.integers(0, 5, n).astype(np.int64)}
    dim = {"k": np.arange(0, 250, dtype=np.int64),
           "w": (np.arange(250) * 3 + 1).astype(np.int64)}
    dim_dup = {c: np.concatenate([a, a[:40]]) for c, a in dim.items()}
    return twin_sessions({"f": fact, "d": dim, "dd": dim_dup}, **DIST)


@pytest.mark.parametrize("dim", ["d", "dd"])
def test_broadcast_inner_join(join_pair, dim):
    _both(join_pair, f"SELECT f.tag, COUNT(*) AS c, SUM({dim}.w) AS sw, "
          f"SUM(f.v) AS sv FROM f JOIN {dim} ON f.k = {dim}.k GROUP BY f.tag")
    assert join_pair[1]._executor._dist_join_route == "broadcast"


def test_broadcast_join_rows(join_pair):
    _both(join_pair, "SELECT f.k, f.v, f.tag, d.w FROM f JOIN d "
          "ON f.k = d.k WHERE f.tag = 2")


@pytest.mark.parametrize("how", ["LEFT", "SEMI", "ANTI"])
def test_broadcast_outer_semi_anti(join_pair, how):
    if how == "LEFT":
        q = ("SELECT f.tag, COUNT(*) AS c, SUM(d.w) AS sw, COUNT(d.w) AS cw "
             "FROM f LEFT JOIN d ON f.k = d.k GROUP BY f.tag")
    else:
        op = "IN" if how == "SEMI" else "NOT IN"
        q = (f"SELECT tag, COUNT(*) AS c, SUM(v) AS sv FROM f WHERE k {op} "
             "(SELECT k FROM d) GROUP BY tag")
    _both(join_pair, q)


def test_join_then_sort(join_pair):
    _both(join_pair, "SELECT f.k, d.w FROM f JOIN d ON f.k = d.k "
          "ORDER BY d.w DESC, f.k LIMIT 20", ordered=True)


@pytest.fixture(scope="module")
def part_pair():
    rng = np.random.default_rng(12)
    n, m = 8 * 300, 8 * 200
    kd = rng.permutation(1200)[:m % 1200 + 500].astype(np.int64)
    return twin_sessions(
        {"pf": {"k": rng.integers(0, 1000, n).astype(np.int64),
                "v": rng.integers(0, 50, n).astype(np.int64)},
         "pd_": {"k": kd, "w": kd * 2 + 1}},
        **DIST, **{"dist.broadcast_join_threshold": 64})


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_partitioned_join(part_pair, how):
    def q(s):
        return (s.scan("pf").join(s.scan("pd_"), "k", "k", how=how)
                .agg([], "count", "sum(v)").run())

    _both(part_pair, q)
    assert part_pair[1]._executor._dist_join_route == "partitioned"


def test_partitioned_join_rows(part_pair):
    _both(part_pair, "SELECT pf.k, pf.v, pd_.w FROM pf JOIN pd_ "
          "ON pf.k = pd_.k")
