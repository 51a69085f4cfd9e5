"""Uncorrelated scalar subqueries against the JAX package: the same SQL
over the same seeded numpy data through ``hdk_tpu.HDK()`` and
``hdk_tpu_torch.HDK(device="cpu")``.  The binder runs the subquery, reads
its one value on the host and folds it into the outer query as a
literal; a subquery that yields NULL makes every comparison with it
UNKNOWN.  Tolerances: see tests/torch_twin.py."""

import numpy as np
import pytest

from torch_twin import assert_same, twin_sessions

QUERIES = {
    # a float AVG (the shape of TPC-H Q11/Q15/Q22)
    "float_avg": ("SELECT COUNT(*), SUM(y) FROM t "
                  "WHERE y > (SELECT AVG(y) FROM t)"),
    # an int MAX, grouped outer query
    "int_max": ("SELECT g, COUNT(*), SUM(x) FROM t "
                "WHERE q < (SELECT MAX(q) FROM t) GROUP BY g ORDER BY g"),
    # an AVG over a column with NULLs
    "nullable_avg": ("SELECT COUNT(*), SUM(x) FROM t "
                     "WHERE x > (SELECT AVG(x) FROM t)"),
    # no row qualifies: MAX is NULL, so no outer row does
    "null_result": ("SELECT COUNT(*), SUM(y) FROM t "
                    "WHERE x > (SELECT MAX(x) FROM t WHERE g > 1000)"),
    # the subquery on both sides of a range
    "two_subqueries": ("SELECT COUNT(*) FROM t "
                       "WHERE y BETWEEN (SELECT MIN(y) FROM t WHERE g = 3) "
                       "AND (SELECT AVG(y) FROM t WHERE g = 4)"),
}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(41)
    n = 6_000
    x = rng.integers(-10**12, 10**12, n)
    keep = rng.random(n) >= 0.1
    data = {
        "g": rng.integers(0, 50, n),
        "q": rng.integers(1, 51, n).astype(np.int8),
        # 10% None: both importers read them as NULL
        "x": [v if k else None for v, k in zip(x.tolist(), keep)],
        "y": rng.gamma(3.0, 100.0, n),
    }
    return twin_sessions({"t": data})


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_scalar_subquery(sessions, name):
    jx, pt = sessions
    sql = QUERIES[name]
    want = jx.sql(sql)
    got = pt.sql(sql)
    assert_same(want, got)


def test_null_result_selects_nothing(sessions):
    _, pt = sessions
    out = pt.sql(QUERIES["null_result"]).to_numpy()
    count, total = out.values()
    assert int(count[0]) == 0
    assert np.ma.is_masked(total[0])
