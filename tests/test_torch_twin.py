"""The differential helper tells NaN from NULL (tests/torch_twin.py::
assert_same reads NULLs from the Arrow validity bitmaps), and queries that
make NaN and NULL in one column give the same NULLs and NaNs in hdk_tpu
and hdk_tpu_torch: SUM/AVG over a group holding NaN, STDDEV of a one-row
group, an all-NULL group, a float key with a NaN and a NULL group.  The
tables come in through ``import_arrow``: ``import_pydict`` reads a NaN in a
float list or array as NULL in both packages."""

import numpy as np
import pyarrow as pa
import pytest

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same, assert_same_storage

NAN = float("nan")


class _Result:
    """A query result as ``assert_same`` reads it: an Arrow table."""

    def __init__(self, **columns):
        self._table = pa.table(columns)

    def to_arrow(self):
        return self._table


def _floats(vals):
    return pa.array(vals, pa.float64())


# -- the helper --------------------------------------------------------------

@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "canon"])
@pytest.mark.parametrize("jax_vals,torch_vals", [
    ([1.0, None, 3.0], [1.0, NAN, 3.0]),
    ([1.0, NAN, 3.0], [1.0, None, 3.0]),
    ([None, None], [NAN, NAN]),
], ids=["null_vs_nan", "nan_vs_null", "all"])
def test_helper_fails_on_null_vs_nan(jax_vals, torch_vals, ordered):
    with pytest.raises(AssertionError, match="NULLs differ"):
        assert_same(_Result(y=_floats(jax_vals)),
                    _Result(y=_floats(torch_vals)), ordered=ordered)


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "canon"])
@pytest.mark.parametrize("vals", [
    [1.0, None, 3.0], [1.0, NAN, 3.0], [None, NAN, 2.5, None, NAN],
], ids=["null", "nan", "both"])
def test_helper_passes_on_null_vs_null_and_nan_vs_nan(vals, ordered):
    keys = list(range(len(vals)))
    # unordered: the port's rows may come in another order
    other = (_Result(g=pa.array(keys), y=_floats(vals)) if ordered
             else _Result(g=pa.array(keys[::-1]), y=_floats(vals[::-1])))
    assert_same(_Result(g=pa.array(keys), y=_floats(vals)), other,
                ordered=ordered)


def test_helper_fails_on_nan_at_other_rows():
    with pytest.raises(AssertionError, match="NaNs differ"):
        assert_same(_Result(y=_floats([NAN, 1.0])),
                    _Result(y=_floats([1.0, NAN])))


def test_helper_compares_nullable_integers_exactly():
    """An int64 column with NULLs is compared as int64, not as the float64
    a pandas frame turns it into."""
    big = 2 ** 60
    with pytest.raises(AssertionError, match="values differ"):
        assert_same(_Result(x=pa.array([big, None], pa.int64())),
                    _Result(x=pa.array([big + 1, None], pa.int64())))
    assert_same(_Result(x=pa.array([big, None], pa.int64())),
                _Result(x=pa.array([big, None], pa.int64())))


# -- NaN and NULL through both packages --------------------------------------

def _nan_table():
    """g in [0, 60): groups 0-5 spelled out (0: 1.0 and NaN; 1: 2.0 and
    3.0; 2: one row; 3: all NULL; 4: one NaN; 5: NaN and NULL), the rest
    random with 5% NaN and 5% NULL in y; x int64 with 10% NULLs; k = g
    spread over 6e10 (the sort route); r = y rounded to tens, a float key
    with a NaN and a NULL group."""
    rng = np.random.default_rng(9)
    n = 3000
    g = np.concatenate([[0, 0, 1, 1, 2, 3, 3, 4, 5, 5],
                        rng.integers(6, 60, n)])
    y = rng.normal(50.0, 20.0, n)
    y[rng.random(n) < 0.05] = NAN
    ys = ([1.0, NAN, 2.0, 3.0, 5.0, None, None, NAN, NAN, None]
          + [None if m else float(v)
             for v, m in zip(y, rng.random(n) < 0.05)])
    xs = ([1, 2, None, 4, 5, None, None, 8, 0, 0]
          + [None if m else int(v)
             for v, m in zip(rng.integers(-1000, 1000, n),
                             rng.random(n) < 0.1)])
    rs = [v if v is None or v != v else round(v / 10) * 10 for v in ys]
    return pa.table({"g": pa.array(g, pa.int64()),
                     "k": pa.array(g * 1_000_000_007, pa.int64()),
                     "y": _floats(ys), "x": pa.array(xs, pa.int64()),
                     "r": _floats(rs)})


@pytest.fixture(scope="module")
def nan_twins():
    table = _nan_table()
    jx = hdk_tpu.HDK()
    pt = hdk_tpu_torch.HDK(device="cpu")
    for session in (jx, pt):
        session.import_arrow(table, name="t")
    assert_same_storage(jx, pt)
    return jx, pt, table


@pytest.mark.parametrize("sql", [
    "SELECT g, SUM(y), AVG(y), COUNT(y), COUNT(*) FROM t GROUP BY g "
    "ORDER BY g",
    "SELECT g, STDDEV_SAMP(y), VAR_SAMP(y), MIN(y), MAX(y) FROM t "
    "GROUP BY g ORDER BY g",
    "SELECT SUM(y), AVG(y), STDDEV_SAMP(y), COUNT(y) FROM t WHERE g = 0",
    "SELECT SUM(y), AVG(y), STDDEV_SAMP(y), COUNT(y) FROM t WHERE g = 2",
    "SELECT SUM(y), AVG(y), STDDEV_SAMP(y), COUNT(y) FROM t WHERE g = 3",
    "SELECT r, COUNT(*), SUM(x) FROM t GROUP BY r ORDER BY r",
    "SELECT g, MEDIAN(y), COUNT(DISTINCT y) FROM t GROUP BY g ORDER BY g",
    "SELECT g, SUM(y) AS s FROM t GROUP BY g ORDER BY s DESC NULLS LAST, g "
    "LIMIT 10",
    "SELECT g, y FROM t WHERE g < 6 ORDER BY y NULLS FIRST, g",
    "SELECT g, x, y / x, y * 0.0 FROM t WHERE g < 6 ORDER BY g, x",
], ids=["sum_avg_nan_group", "stddev_one_row", "scalar_nan",
        "scalar_one_row", "scalar_all_null", "float_key_nan_null",
        "median_distinct", "topn_nan_sums", "row_sort_nan_null",
        "row_exprs"])
def test_nan_and_null_match(nan_twins, sql):
    jx, pt, _ = nan_twins
    assert_same(jx.sql(sql), pt.sql(sql))


def _engines():
    return [pytest.param("torch"),
            pytest.param("jax", marks=pytest.mark.xfail(
                strict=True, reason="the JAX package's sort route takes a "
                                    "group's float sums as differences of "
                                    "one prefix sum: a NaN reaches every "
                                    "later group (ROADMAP C)"))]


@pytest.mark.parametrize("engine", _engines())
def test_sort_route_nan_stays_in_its_group(nan_twins, engine):
    """GROUP BY a key spread over 6e10 (the sort route): SUM and AVG are
    NaN in the groups that hold a NaN, NULL in the all-NULL group, and
    the group's own sum elsewhere."""
    jx, pt, table = nan_twins
    hdk = pt if engine == "torch" else jx
    out = hdk.sql("SELECT k, SUM(y) AS s, AVG(y) AS a, COUNT(y) AS c "
                  "FROM t GROUP BY k ORDER BY k").to_arrow()
    k = table.column("k").to_numpy()
    y = table.column("y")
    valid = ~y.is_null().to_numpy()
    yv = y.fill_null(0.0).to_numpy()
    keys = np.unique(k)
    slot = np.searchsorted(keys, k)
    count = np.bincount(slot[valid], minlength=keys.size)
    sums = np.bincount(slot[valid], weights=yv[valid], minlength=keys.size)
    assert out.column("k").to_pylist() == keys.tolist()
    assert out.column("c").to_pylist() == count.tolist()
    for name, want in (("s", sums), ("a", sums / np.maximum(count, 1))):
        col = out.column(name)
        assert col.is_null().to_numpy().tolist() == (count == 0).tolist()
        got = col.fill_null(0.0).to_numpy()[count > 0]
        want = want[count > 0]
        assert np.isnan(got).tolist() == np.isnan(want).tolist(), name
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9)
