"""Window functions in multi-device sessions, the port against the JAX
package (the window half of the twin of tests/test_dist_engine.py; the
rest is in tests/test_torch_dist_engine.py): the 4001-row frame in
``hdk_tpu.HDK`` over JAX's 8 virtual devices and in
``hdk_tpu_torch.HDK(device="cpu")`` on 8 shards.  Each window's route
(``_dist_window_route``: ``dist_window``, or ``gspmd`` for a window
without PARTITION BY) must be the JAX package's, and its result equal
(``torch_twin.assert_same``)."""

import numpy as np
import pytest

import jax

from torch_twin import twin_sessions
from test_torch_dist_engine import DIST, _both, _frame

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def pair():
    return twin_sessions({"t": _frame()}, **DIST)


@pytest.mark.parametrize("q,route", [
    ("SELECT k, big, RANK() OVER (PARTITION BY k ORDER BY big) AS r, "
     "SUM(v) OVER (PARTITION BY k) AS s FROM t", "dist_window"),
    ("SELECT k, big, ROW_NUMBER() OVER (PARTITION BY k ORDER BY big) AS rn "
     "FROM t WHERE v > 0", "dist_window"),
    ("SELECT big, LAG(big, 1) OVER (PARTITION BY k ORDER BY big) AS lg, "
     "LEAD(big, 1) OVER (PARTITION BY k ORDER BY big) AS ld FROM t",
     "dist_window"),
    ("SELECT big, RANK() OVER (ORDER BY big) AS r FROM t", "gspmd"),
])
def test_windows(pair, q, route):
    _both(pair, q, win=route)


def test_window_feeding_aggregate(pair):
    _both(pair, "SELECT k, MAX(rn) AS mx, SUM(cs) AS sc FROM (SELECT k, "
          "ROW_NUMBER() OVER (PARTITION BY k ORDER BY big) AS rn, "
          "SUM(v) OVER (PARTITION BY k) AS cs FROM t) sub GROUP BY k",
          win="dist_window")


def test_window_feeding_sort(pair):
    _both(pair, "SELECT big, RANK() OVER (PARTITION BY k ORDER BY big) AS r "
          "FROM t WHERE v > 0 ORDER BY r DESC, big LIMIT 40", ordered=True,
          win="dist_window")


def test_window_feeding_full_sort(pair):
    """A window under an ORDER BY without a small LIMIT: the window's
    route, then the range sort over its output."""
    _both(pair, "SELECT big, RANK() OVER (PARTITION BY k ORDER BY big) AS r "
          "FROM t ORDER BY r, big", ordered=True, win="dist_window")
    assert pair[1]._executor._dist_sort_route == "range"


def test_window_feeding_join(pair):
    _both(pair, "SELECT w.k, COUNT(*) AS c FROM (SELECT k, big, "
          "ROW_NUMBER() OVER (PARTITION BY k ORDER BY big) AS rn FROM t) w "
          "JOIN (SELECT k, COUNT(*) AS n FROM t GROUP BY k) g ON w.k = g.k "
          "WHERE w.rn <= g.n / 2 GROUP BY w.k")
