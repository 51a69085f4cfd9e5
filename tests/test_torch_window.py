"""Window functions of the port against the JAX package: every WindowKind
with and without PARTITION BY and ORDER BY, ROWS and RANGE frames (DESC,
NULL order keys), windows after a Filter, global windows, and windows
under an Aggregate, a Sort and a join input, through ``hdk_tpu`` and
``hdk_tpu_torch.HDK(device="cpu")`` on the same numpy data.  Integers
match exactly, floats to rtol 1e-9, FLOAT (float32) outputs to 1e-6
(tests/torch_twin.py).  Frames are also held to sqlite, and
``compute_window`` to the JAX function on the same inputs."""

import math
import sqlite3

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import hdk_tpu
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu.exec.window import compute_window as jax_window
from hdk_tpu.ir.expr import WindowFrame as JFrame
from hdk_tpu.ir.expr import WindowKind as JKind

import hdk_tpu_torch
from hdk_tpu_torch.exec.masked import MaskedCol as TCol
from hdk_tpu_torch.exec.window import compute_window as torch_window
from hdk_tpu_torch.ir.expr import WindowFrame as TFrame
from hdk_tpu_torch.ir.expr import WindowKind as TKind

from harness import assert_frames_match
from torch_twin import assert_same, twin_sessions

ROWS = 300


def _nullable(rng, values, frac=0.1):
    """A list with ``frac`` None, which both importers read as NULL."""
    keep = rng.random(len(values)) >= frac
    return [v if k else None for v, k in zip(values.tolist(), keep)]


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(23)
    n = ROWS
    w = {
        "g": rng.integers(0, 7, n),
        "o": rng.integers(0, 40, n),  # ties
        "z": _nullable(rng, rng.integers(0, 30, n)),  # nullable order key
        "v": _nullable(rng, np.round(rng.normal(10, 5, n), 4)),
        "x": _nullable(rng, rng.integers(-1000, 1000, n)),
        "f": rng.normal(5, 2, n).astype(np.float32),
        "s": np.asarray(["a", "b", "c", None], dtype=object)[
            rng.integers(0, 4, n)],
        "k": rng.integers(0, 20, n),
    }
    d = {"k": np.arange(20), "w": rng.integers(0, 5, 20)}
    return twin_sessions({"w": w, "d": d})


def _over(spec):
    return f"OVER ({spec})"


def _aggs(spec, star=True):
    """Windowed aggregates; ``star=False`` leaves COUNT(*) out (OVER ()
    without a column input: both packages refuse it)."""
    o = _over(spec)
    return ((f"COUNT(*) {o} AS c, " if star else "")
            + f"COUNT(v) {o} AS cv, SUM(x) {o} AS sx, "
            f"SUM(v) {o} AS sv, AVG(v) {o} AS av, AVG(x) {o} AS ax, "
            f"MIN(v) {o} AS mnv, MAX(x) {o} AS mxx, MIN(s) {o} AS mns, "
            f"SUM(f) {o} AS sf")


def _ranks(spec):
    o = _over(spec)
    return (f"ROW_NUMBER() {o} AS rn, RANK() {o} AS r, DENSE_RANK() {o} AS dr, "
            f"PERCENT_RANK() {o} AS pr, CUME_DIST() {o} AS cd, "
            f"NTILE(4) {o} AS nt")


def _nav(spec):
    o = _over(spec)
    return (f"LAG(v) {o} AS lg, LEAD(x, 2) {o} AS ld, LAG(s, 3) {o} AS ls, "
            f"FIRST_VALUE(v) {o} AS fv, LAST_VALUE(x) {o} AS lv, "
            f"NTH_VALUE(v, 3) {o} AS nv")


SQL = {
    # rank family
    "ranks": f"SELECT g, o, {_ranks('PARTITION BY g ORDER BY o')} FROM w",
    "ranks_desc_nulls": "SELECT g, z, "
                        f"{_ranks('PARTITION BY g ORDER BY z DESC')} FROM w",
    "ranks_global": f"SELECT o, {_ranks('ORDER BY o, x')} FROM w",
    "ranks_no_order": f"SELECT g, {_ranks('PARTITION BY g')} FROM w",
    "ranks_multi_key": "SELECT g, s, o, "
                       f"{_ranks('PARTITION BY g, s ORDER BY o DESC, x')} "
                       "FROM w",
    "ranks_dict_order": f"SELECT g, s, {_ranks('PARTITION BY g ORDER BY s')} "
                        "FROM w",
    # navigation
    "navigation": f"SELECT g, {_nav('PARTITION BY g ORDER BY o, x')} FROM w",
    "navigation_global": f"SELECT {_nav('ORDER BY z DESC, o')} FROM w",
    # aggregates over the default frames
    "whole_partition": f"SELECT g, {_aggs('PARTITION BY g')} FROM w",
    "whole_partition_two_keys": f"SELECT {_aggs('PARTITION BY g, s')} FROM w",
    "whole_table": f"SELECT {_aggs('', star=False)} FROM w WHERE o <> 3",
    "cumulative": f"SELECT g, o, {_aggs('PARTITION BY g ORDER BY o')} FROM w",
    "cumulative_desc_nulls": "SELECT g, z, "
                             f"{_aggs('PARTITION BY g ORDER BY z DESC')} "
                             "FROM w",
    "cumulative_global": f"SELECT {_aggs('ORDER BY o')} FROM w",
    # explicit frames
    "rows_frames": (
        "SELECT g, "
        "SUM(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 2 PRECEDING "
        "AND CURRENT ROW) AS s2, "
        "AVG(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 1 PRECEDING "
        "AND 1 FOLLOWING) AS a1, "
        "MIN(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 3 PRECEDING "
        "AND 1 FOLLOWING) AS mn, "
        "MAX(x) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 3 PRECEDING "
        "AND 1 FOLLOWING) AS mx, "
        "COUNT(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 2 PRECEDING "
        "AND 2 FOLLOWING) AS cv, "
        "SUM(x) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 1 FOLLOWING "
        "AND 3 FOLLOWING) AS sx, "
        "SUM(f) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 6 PRECEDING "
        "AND CURRENT ROW) AS sf FROM w"),
    "rows_unbounded": (
        "SELECT g, "
        "SUM(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN CURRENT ROW "
        "AND UNBOUNDED FOLLOWING) AS s, "
        "AVG(v) OVER (ORDER BY o, x ROWS BETWEEN UNBOUNDED PRECEDING AND "
        "2 PRECEDING) AS a, "
        "MAX(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN UNBOUNDED "
        "PRECEDING AND UNBOUNDED FOLLOWING) AS m, "
        "SUM(v) OVER (ORDER BY o, x ROWS BETWEEN 70 PRECEDING AND 5 "
        "FOLLOWING) AS wide FROM w"),
    "range_frames": (
        "SELECT g, o, "
        "COUNT(*) OVER (PARTITION BY g ORDER BY o RANGE BETWEEN 5 PRECEDING "
        "AND 5 FOLLOWING) AS c, "
        "SUM(v) OVER (PARTITION BY g ORDER BY o RANGE BETWEEN 10 PRECEDING "
        "AND CURRENT ROW) AS s, "
        "SUM(v) OVER (PARTITION BY g ORDER BY o DESC RANGE BETWEEN 5 "
        "PRECEDING AND 5 FOLLOWING) AS sd, "
        "MIN(x) OVER (PARTITION BY g ORDER BY z RANGE BETWEEN 3 PRECEDING "
        "AND 3 FOLLOWING) AS mn, "
        "AVG(v) OVER (PARTITION BY g ORDER BY z DESC RANGE BETWEEN CURRENT "
        "ROW AND 4 FOLLOWING) AS an FROM w"),
    "frame_navigation": (
        "SELECT g, "
        "FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 1 "
        "PRECEDING AND 1 FOLLOWING) AS f, "
        "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN 1 "
        "PRECEDING AND 1 FOLLOWING) AS l, "
        "NTH_VALUE(x, 2) OVER (PARTITION BY g ORDER BY o, x ROWS BETWEEN "
        "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS nv, "
        "FIRST_VALUE(x) OVER (PARTITION BY g ORDER BY o RANGE BETWEEN 3 "
        "PRECEDING AND CURRENT ROW) AS fr FROM w"),
    # a window after a Filter sees only the surviving rows
    "after_filter": (
        f"SELECT g, o, {_ranks('PARTITION BY g ORDER BY o')}, "
        f"{_aggs('PARTITION BY g')} FROM w WHERE v > 8 AND o <> 3"),
    "cumulative_after_filter": (
        f"SELECT g, {_aggs('PARTITION BY g ORDER BY o DESC')} FROM w "
        "WHERE x > -500"),
    # windows under an Aggregate, a Sort and a join input
    "under_aggregate": (
        "SELECT g, MAX(rn) AS m, SUM(cs) AS t, COUNT(*) AS c FROM (SELECT g, "
        "ROW_NUMBER() OVER (PARTITION BY g ORDER BY o) AS rn, SUM(x) OVER "
        "(PARTITION BY g ORDER BY o) AS cs FROM w) GROUP BY g ORDER BY g"),
    "under_scalar_aggregate": (
        "SELECT COUNT(*) AS c, SUM(s) AS t FROM (SELECT SUM(v) OVER "
        "(PARTITION BY k) AS s, COUNT(*) OVER (PARTITION BY k) AS n FROM w) "
        "WHERE s > 100 AND n >= 5"),
    "under_sort_top_n": (
        "SELECT g, v, rn FROM (SELECT g, v, ROW_NUMBER() OVER (PARTITION BY "
        "g ORDER BY v DESC, o) AS rn FROM w) WHERE rn <= 3 ORDER BY g, rn"),
    "under_sort": (
        "SELECT g, o, x, r FROM (SELECT g, o, x, RANK() OVER (ORDER BY x "
        "DESC) AS r FROM w) ORDER BY r, g, o LIMIT 25"),
    "join_input": (
        "SELECT d.w, a.rn, a.cs FROM (SELECT k, ROW_NUMBER() OVER (PARTITION "
        "BY k ORDER BY o, x) AS rn, SUM(x) OVER (PARTITION BY k ORDER BY o, "
        "x) AS cs FROM w) a JOIN d ON a.k = d.k WHERE a.rn <= 2 "
        "ORDER BY d.w, a.rn, a.cs"),
}

F32_COLUMNS = ["sf"]


@pytest.mark.parametrize("name", sorted(SQL))
def test_window_sql(twins, name):
    jx, pt = twins
    assert_same(jx.sql(SQL[name]), pt.sql(SQL[name]), f32_avg=F32_COLUMNS)


def _builder_queries(hdk, ht):
    order = (ht["o"], ht["rowid"])
    flt = ht.filter(ht["v"] > 10)
    return {
        "facade": lambda: ht.proj(
            "g", "o",
            rn=hdk.row_number().over(ht["g"]).order_by(*order),
            r=hdk.rank().over(ht["g"]).order_by(ht["o"]),
            dr=hdk.dense_rank().over(ht["g"]).order_by(ht["o"]),
            pr=hdk.percent_rank().over(ht["g"]).order_by(ht["o"]),
            cd=hdk.cume_dist().over(ht["g"]).order_by(ht["o"]),
            nt=hdk.ntile(3).over(ht["g"]).order_by(*order)).run(),
        "global": lambda: ht.proj(
            rn=hdk.row_number().over().order_by(*order),
            cs=ht["v"].sum().over().order_by(*order)).run(),
        "lag_lead_cumsum": lambda: ht.proj(
            "g", "v",
            lg=ht["v"].lag(1).over(ht["g"]).order_by(*order),
            ld=ht["v"].lead(1).over(ht["g"]).order_by(*order),
            cs=ht["v"].sum().over(ht["g"]).order_by(*order)).run(),
        "frame": lambda: ht.proj(
            "g", s=ht["v"].sum().over(ht["g"]).order_by(ht["o"], ht["v"])
            .frame("rows", ("preceding", 2), "current_row")).run(),
        "after_filter": lambda: flt.proj(
            "g", rn=hdk.row_number().over(flt["g"]).order_by(flt["o"]),
            m=flt["x"].max().over(flt["g"])).run(),
    }


@pytest.mark.parametrize("name", ["facade", "global", "lag_lead_cumsum",
                                  "frame", "after_filter"])
def test_window_builder(twins, name):
    jx, pt = twins
    assert_same(_builder_queries(jx, jx.scan("w"))[name](),
                _builder_queries(pt, pt.scan("w"))[name]())


# -- frames held to sqlite, as tests/test_window.py holds the reference ----

FRAME_SQL = {
    "rows_sum": "SELECT g, o, v, SUM(v) OVER (PARTITION BY g ORDER BY o, v "
                "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS s FROM fw",
    "rows_avg": "SELECT g, o, AVG(v) OVER (PARTITION BY g ORDER BY o, v "
                "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS m FROM fw",
    "rows_min_max": "SELECT g, o, MIN(v) OVER (PARTITION BY g ORDER BY o, v "
                    "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS lo, "
                    "MAX(v) OVER (PARTITION BY g ORDER BY o, v "
                    "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS hi FROM fw",
    "rows_count_nulls": "SELECT g, o, COUNT(vn) OVER (PARTITION BY g ORDER BY "
                        "o, v ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS c "
                        "FROM fw",
    "rows_following": "SELECT g, o, SUM(v) OVER (PARTITION BY g ORDER BY o, v "
                      "ROWS BETWEEN 1 FOLLOWING AND 3 FOLLOWING) AS s FROM fw",
    "rows_unbounded_following": "SELECT g, o, SUM(v) OVER (PARTITION BY g "
                                "ORDER BY o, v ROWS BETWEEN CURRENT ROW AND "
                                "UNBOUNDED FOLLOWING) AS s FROM fw",
    "rows_wide_nulls": "SELECT g, o, SUM(vn) OVER (PARTITION BY g ORDER BY "
                       "o, v ROWS BETWEEN 80 PRECEDING AND 1 PRECEDING) AS s "
                       "FROM fw",
    "range_offsets": "SELECT g, o, COUNT(*) OVER (PARTITION BY g ORDER BY o "
                     "RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS c, "
                     "SUM(v) OVER (PARTITION BY g ORDER BY o "
                     "RANGE BETWEEN 10 PRECEDING AND CURRENT ROW) AS s "
                     "FROM fw",
    "range_desc": "SELECT g, o, SUM(v) OVER (PARTITION BY g ORDER BY o DESC "
                  "RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS s FROM fw",
    "nth_value": "SELECT g, o, NTH_VALUE(v, 2) OVER (PARTITION BY g ORDER BY "
                 "o, v ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED "
                 "FOLLOWING) AS nv FROM fw",
    "first_last": "SELECT g, o, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY "
                  "o, v ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS f, "
                  "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY o, v ROWS "
                  "BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS l FROM fw",
}


@pytest.fixture(scope="module")
def frame_env():
    rng = np.random.default_rng(41)
    n = 400
    df = pd.DataFrame({"g": rng.integers(0, 6, n), "o": rng.integers(0, 60, n),
                       "v": np.round(rng.normal(5, 3, n), 4)})
    vn = df["v"].copy()
    vn[rng.random(n) < 0.1] = np.nan  # NULL in all three
    df["vn"] = vn
    jx = hdk_tpu.HDK()
    pt = hdk_tpu_torch.HDK(device="cpu")
    jx.import_pandas(df, name="fw")
    pt.import_pandas(df, name="fw")
    con = sqlite3.connect(":memory:")
    df.to_sql("fw", con, index=False)
    yield jx, pt, con
    con.close()


@pytest.mark.parametrize("name", sorted(FRAME_SQL))
def test_frames_against_sqlite(frame_env, name):
    jx, pt, con = frame_env
    sql = FRAME_SQL[name]
    got = pt.sql(sql)
    exp = pd.read_sql_query(sql, con)
    frame = got.to_pandas()
    exp.columns = list(frame.columns)
    assert_frames_match(frame, exp)
    assert_same(jx.sql(sql), got)


# -- compute_window against the JAX function on the same inputs -----------

def _cols(rng, n, null_frac):
    """(numpy data, validity or None) of an argument, partition and order
    column."""
    def col(values):
        if not null_frac:
            return values, None
        return values, rng.random(n) >= null_frac

    return (col(np.round(rng.normal(3, 2, n), 3)),
            col(rng.integers(0, 5, n)), col(rng.integers(0, 12, n)))


FRAMES = {
    None: None,
    "rows": ("rows", ("preceding", 2), ("following", 1)),
    "rows_wide": ("rows", ("unbounded_preceding", None), ("preceding", 1)),
    "range": ("range", ("preceding", 3), ("current_row", None)),
}

KIND_CASES = [(k, None) for k in TKind] + [
    (k, f) for k in ("count", "sum", "avg", "min", "max", "first_value",
                     "last_value", "nth_value") for f in FRAMES if f]


@pytest.mark.parametrize("kind,frame", KIND_CASES,
                         ids=[f"{k if isinstance(k, str) else k.value}-{f}"
                              for k, f in KIND_CASES])
def test_compute_window_matches_jax(kind, frame):
    rng = np.random.default_rng(7)
    n = 200
    (arg, am), (part, pm), (order, om) = _cols(rng, n, 0.15)
    row_mask = rng.random(n) >= 0.2
    name = kind if isinstance(kind, str) else kind.value
    arg1 = {"ntile": 3, "lag": 2, "lead": 1, "nth_value": 2}.get(name)
    takes_arg = name in ("lag", "lead", "first_value", "last_value",
                         "nth_value", "sum", "avg", "min", "max")
    spec = FRAMES[frame]

    def run(cls, window, kinds, frame_cls, to_array, dtype):
        def c(d, m):
            return cls(to_array(d), None if m is None else to_array(m))

        return window(kinds(name), [c(arg, am)] if takes_arg else [],
                      [c(part, pm)], [c(order, om)], [True], arg1, n,
                      to_array(row_mask), dtype,
                      frame=frame_cls(*spec) if spec else None)

    want = run(JCol, jax_window, JKind, JFrame, jnp.asarray, jnp.float64)
    got = run(TCol, torch_window, TKind, TFrame, torch.from_numpy,
              torch.float64)
    live = row_mask
    wm = (np.ones(n, bool) if want.mask is None
          else np.asarray(want.mask)) & live
    gm = (np.ones(n, bool) if got.mask is None
          else got.mask.numpy()) & live
    assert (wm == gm).all()
    np.testing.assert_allclose(got.data.numpy()[gm],
                               np.asarray(want.data)[wm], rtol=1e-12)


# -- faults of the reference the port does not share (ROADMAP C) ----------

FAULT_SQL = ("SELECT g, o, SUM(v) OVER (PARTITION BY g) AS s, SUM(v) OVER "
             "(PARTITION BY g ORDER BY o ROWS BETWEEN 1 PRECEDING AND CURRENT "
             "ROW) AS fs FROM t ORDER BY o")

FAULT_VALUES = {
    # one NaN in the first partition: the reference's float64 prefix over
    # every sorted row carries it into the later partitions
    "nan": [1.0, math.nan, 2.0, 3.0, 4.0, 5.0],
    # +inf in the first partition: inf - inf = NaN in the later ones
    "inf": [1.0, math.inf, 2.0, 3.0, 4.0, 5.0],
}


def _fault_oracle(v):
    """(s, fs) by SQL semantics: partitions [0, 1], [2, 3], [4, 5], each
    summed alone; the frame holds the row and its predecessor in the
    partition."""
    v = np.asarray(v)
    s = np.repeat([v[0] + v[1], v[2] + v[3], v[4] + v[5]], 2)
    fs = np.asarray([v[0], v[0] + v[1], v[2], v[2] + v[3], v[4],
                     v[4] + v[5]])
    return s, fs


@pytest.mark.parametrize("package", [
    pytest.param("hdk_tpu", marks=pytest.mark.xfail(
        strict=True, reason="reference fault, ROADMAP C")),
    "hdk_tpu_torch"])
@pytest.mark.parametrize("case", sorted(FAULT_VALUES))
def test_reference_faults(case, package):
    """A NaN or an infinity stays in its own partition; NaN compares
    equal to NaN here (Arrow import keeps it a value, not NULL)."""
    table = pa.table({"g": [0, 0, 1, 1, 2, 2], "v": FAULT_VALUES[case],
                      "o": list(range(6))})
    sess = (hdk_tpu.HDK() if package == "hdk_tpu"
            else hdk_tpu_torch.HDK(device="cpu"))
    sess.import_arrow(table, name="t")
    out = sess.sql(FAULT_SQL).to_arrow()
    s, fs = _fault_oracle(FAULT_VALUES[case])
    np.testing.assert_array_equal(out.column("s").to_numpy(), s)
    np.testing.assert_array_equal(out.column("fs").to_numpy(), fs)


@pytest.mark.parametrize("package", [
    pytest.param("hdk_tpu", marks=pytest.mark.xfail(
        strict=True, reason="reference fault, ROADMAP C")),
    "hdk_tpu_torch"])
def test_whole_table_window_without_filter(package):
    """OVER () over a table without a Filter: no sort key at all (the
    reference hands its sort zero keys and raises)."""
    table = pa.table({"v": [1.5, None, 2.0, 4.0], "x": [3, 1, None, 2]})
    sess = (hdk_tpu.HDK() if package == "hdk_tpu"
            else hdk_tpu_torch.HDK(device="cpu"))
    sess.import_arrow(table, name="t")
    out = sess.sql("SELECT SUM(v) OVER () AS s, COUNT(v) OVER () AS c, "
                   "MIN(x) OVER () AS m FROM t").to_arrow()
    assert out.column("s").to_pylist() == [7.5] * 4
    assert out.column("c").to_pylist() == [3] * 4
    assert out.column("m").to_pylist() == [1] * 4


@pytest.mark.parametrize("package", [
    pytest.param("hdk_tpu", marks=pytest.mark.xfail(
        strict=True, reason="reference fault, ROADMAP C")),
    "hdk_tpu_torch"])
def test_constant_window_argument(package):
    """A constant argument (SUM(1) OVER (PARTITION BY g)) counts each row
    once: the partition's row count on every row (the reference hands
    its window a 0-d array and raises)."""
    table = pa.table({"g": [0, 1, 1, 2, 2, 2, 1], "v": [1.0] * 7})
    sess = (hdk_tpu.HDK() if package == "hdk_tpu"
            else hdk_tpu_torch.HDK(device="cpu"))
    sess.import_arrow(table, name="t")
    out = sess.sql("SELECT g, SUM(1) OVER (PARTITION BY g) AS n, "
                   "COUNT(2) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN "
                   "UNBOUNDED PRECEDING AND CURRENT ROW) AS c "
                   "FROM t").to_arrow()
    assert out.column("n").to_pylist() == [1, 3, 3, 3, 3, 3, 3]
    assert sorted(zip(out.column("g").to_pylist(),
                      out.column("c").to_pylist())) == [
        (0, 1), (1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3)]
