"""The sort-based GROUP BY, the holistic aggregates and the identity pass
of the port against the JAX package, on the same data through
``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device="cpu")``.

Three session configurations: the default (small keys take the dense
route), ``perfect_hash_entries_limit = 16`` (every key of more than 15
values takes the sort route) and, on top of it, ``default_max_groups =
16`` (the group buffer overflows, widens and runs again).  Module level:
``ops/sortops.py``, ``try_pack_keys``/``unpack_keys`` and ``groupby_sort``
against their JAX counterparts.

Tolerances: keys, counts, integer sums and HLL estimates exact; float64
aggregates rtol 1e-9 (tests/torch_twin.py).  The float columns are
multiples of 1/8, so the JAX package's cumsum-difference sums are exact
too.  Where the JAX package is wrong (the ``*_int64_extremes`` tests),
the port is held to an oracle and the JAX comparison is an expected
failure.
"""

import numpy as np
import pytest
import torch

import hdk_tpu
import jax.numpy as jnp
from hdk_tpu.exec import groupby as jgb
from hdk_tpu.exec.agg_exec import AggExecMixin as JaxAgg
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu.ops import sortops as jso

import hdk_tpu_torch
from hdk_tpu_torch.exec import groupby as tgb
from hdk_tpu_torch.exec.agg_exec import AggExecMixin as TorchAgg
from hdk_tpu_torch.exec.masked import from_numpy
from hdk_tpu_torch.ops import sortops as tso

from torch_twin import assert_same, twin_sessions

ROWS = 20_000
I64 = np.iinfo(np.int64)

CONFIGS = {
    "dense": {},
    "sort": {"exec.group_by.perfect_hash_entries_limit": 16},
    "retry": {"exec.group_by.perfect_hash_entries_limit": 16,
              "exec.group_by.default_max_groups": 16},
}


def _nullable(rng, values, share):
    """A list with ``share`` None, which both importers read as NULL."""
    keep = rng.random(len(values)) >= share
    return [v if k else None for v, k in zip(values.tolist(), keep)]


def _data(n=ROWS, seed=11):
    rng = np.random.default_rng(seed)
    return {
        # range above 2^31: an int64 composite
        "big": _nullable(rng, rng.integers(0, 700, n) * 2**33 + 5, 0.03),
        # a few thousand values: an int32 composite on the sort route
        "k": _nullable(rng, rng.integers(0, 3000, n), 0.05),
        "g": rng.integers(0, 12, n).astype(np.int16),
        "v": rng.integers(0, 1000, n),
        "x": _nullable(rng, rng.integers(-50, 50, n), 0.1),
        "y": _nullable(rng, np.round(rng.normal(50, 20, n) * 8) / 8, 0.1),
        "f": (np.round(rng.normal(0, 3, n) * 4) / 4).astype(np.float32),
        "r": np.round(rng.normal(50, 20, n), 0),
    }


@pytest.fixture(scope="module", params=list(CONFIGS))
def twins(request):
    return request.param, twin_sessions({"h": _data()},
                                        **CONFIGS[request.param])


_ALL_AGGS = ("COUNT(*), COUNT(x), SUM(x), AVG(y), MIN(y), MAX(x), "
             "STDDEV_SAMP(y), VAR_SAMP(x), CORR(x, y), SAMPLE(v), "
             "COUNT(DISTINCT x), SUM(DISTINCT x), AVG(DISTINCT y), "
             "QUANTILE(y, 0.3), MEDIAN(x), APPROX_COUNT_DISTINCT(v), "
             "APPROX_QUANTILE(y, 0.75)")

SQL_CASES = {
    # every aggregate of the slice over a small key (dense by default)
    "all_aggs_small_key": f"SELECT g, {_ALL_AGGS} FROM h GROUP BY g "
                          "ORDER BY g",
    # ... over a packed int32 composite with NULL keys
    "all_aggs_int32_composite": f"SELECT k, {_ALL_AGGS} FROM h "
                                "GROUP BY k ORDER BY k",
    # int64 composite, NULL keys, a filter
    "int64_composite_filtered": "SELECT big, COUNT(*), SUM(v), AVG(y), "
                                "COUNT(DISTINCT k) FROM h WHERE v > 200 "
                                "GROUP BY big ORDER BY big",
    # two packed keys
    "two_packed_keys": "SELECT k, g, COUNT(*), SUM(x), MIN(f), MAX(y) "
                       "FROM h WHERE x <> 7 GROUP BY k, g ORDER BY k, g",
    # float keys: no ranges, the lexicographic sort
    "float_key": "SELECT r, COUNT(*), SUM(v), COUNT(DISTINCT g), "
                 "QUANTILE(y, 0.5), APPROX_COUNT_DISTINCT(x) FROM h "
                 "GROUP BY r ORDER BY r",
    "float_and_null_keys": "SELECT f, k, COUNT(*), SUM(v), AVG(y) FROM h "
                           "WHERE v < 900 GROUP BY f, k ORDER BY f, k",
    # the three interpolations
    "quantile_interpolations": None,
    # aggregate -> ORDER BY count with many ties, and LIMIT/OFFSET
    "topn_ties": "SELECT k, COUNT(*) AS c FROM h GROUP BY k "
                 "ORDER BY c DESC LIMIT 100",
    "topn_ties_offset": "SELECT big, g, COUNT(*) AS c, SUM(v) FROM h "
                        "GROUP BY big, g ORDER BY c DESC, g LIMIT 30 "
                        "OFFSET 7",
    "full_sort_desc": "SELECT r, COUNT(*) AS c FROM h GROUP BY r "
                      "ORDER BY c DESC",
    # the holistic aggregates without GROUP BY
    "scalar_holistic": "SELECT COUNT(DISTINCT x), SUM(DISTINCT x), "
                       "MEDIAN(y), APPROX_COUNT_DISTINCT(v), "
                       "APPROX_QUANTILE(y, 0.5) FROM h WHERE v > 10",
}


def _query(case, hdk):
    if case == "quantile_interpolations":
        h = hdk.scan("h")
        return h.agg(["k"], h["y"].quantile(0.35, "lower").name("lo"),
                     h["y"].quantile(0.35, "higher").name("hi"),
                     h["y"].quantile(0.35).name("lin")).sort("k").run()
    return hdk.sql(SQL_CASES[case])


@pytest.mark.parametrize("case", list(SQL_CASES))
def test_groupby_routes(twins, case):
    name, (jx, pt) = twins
    jx._executor._groupby_attempts = pt._executor._groupby_attempts = 0
    want = _query(case, jx)
    got = _query(case, pt)
    assert_same(want, got)
    # one attempt, or one widen-retry (the JAX package counts outside
    # the fused aggregate -> sort step only)
    if jx._executor._groupby_attempts:
        assert (pt._executor._groupby_attempts
                == jx._executor._groupby_attempts)
    grouped = case != "scalar_holistic"
    assert pt._executor._groupby_attempts == (
        0 if not grouped else
        2 if name == "retry" and got.row_count > 16 else 1)


def test_builder_high_ndv_shapes(twins):
    """The two high-NDV suite queries through the builder API."""
    _name, (jx, pt) = twins
    for q in (lambda h: h.agg("k", "count", "sum(v)"),
              lambda h: h.agg("k", "count").sort(("count", "desc"),
                                                 limit=100)):
        assert_same(q(jx.scan("h")).run(), q(pt.scan("h")).run())


def _track_identity(monkeypatch, cls, names):
    fired = []
    for name in names:
        orig = getattr(cls, name)

        def patched(self, *a, _orig=orig):
            r = _orig(self, *a)
            fired.append(r is not None)
            return r

        monkeypatch.setattr(cls, name, patched)
    return fired


@pytest.mark.parametrize("shape", ["plain", "sorted_topn", "sorted_full"])
def test_identity_regroup(twins, monkeypatch, shape):
    """A GROUP BY over an already-grouped result whose keys it covers is
    an identity pass in both packages (the JAX package fuses it with a
    small-LIMIT top-n; the port sorts the identity table)."""
    _name, (jx, pt) = twins
    fired_j = _track_identity(monkeypatch, JaxAgg, (
        "_agg_identity_table", "_exec_fused_identity_sort"))
    fired_t = _track_identity(monkeypatch, TorchAgg, ("_agg_identity_table",))

    def q(hdk):
        h = hdk.scan("h")
        first = h.filter(h["v"] > 300).agg(["k", "g"], "count", "sum(v)")
        second = first.agg(["k", "g"], "sum(v_sum)", "max(count)",
                           "count")
        if shape == "sorted_topn":
            second = second.sort(("v_sum_sum", "desc"), "k", limit=9)
        elif shape == "sorted_full":
            second = second.sort("g", ("k", "desc"))
        return second.run()

    assert_same(q(jx), q(pt))
    assert any(fired_j) and any(fired_t)


@pytest.fixture(scope="module", params=["dense", "sort"])
def typed_twins(request):
    """Timestamp, dictionary-string, bool and date keys."""
    rng = np.random.default_rng(6)
    n = 5000
    data = {"ts": np.int64(1_600_000_000) + rng.integers(0, 10**6, n),
            "s": np.asarray([f"s{i}" for i in range(400)],
                            dtype=object)[rng.integers(0, 400, n)],
            "b": rng.random(n) < 0.5,
            "d": rng.integers(18000, 19000, n).astype(np.int32),
            "v": rng.integers(0, 100, n),
            "y": np.round(rng.normal(0, 1, n) * 8) / 8}
    return twin_sessions(
        {"t": data}, schema=lambda t: {
            "ts": t.timestamp(t.TimeUnit.SECOND, False),
            "d": t.date32(False)},
        **CONFIGS[request.param])


@pytest.mark.parametrize("sql", [
    # not a dense key type: the unpacked sort
    "SELECT ts, COUNT(*), SUM(v) FROM t GROUP BY ts ORDER BY ts",
    # dictionary codes and a bool, packed
    "SELECT s, b, COUNT(*), MEDIAN(y), COUNT(DISTINCT v) FROM t "
    "GROUP BY s, b ORDER BY s, b",
    "SELECT d, APPROX_COUNT_DISTINCT(v), AVG(DISTINCT y) FROM t "
    "GROUP BY d ORDER BY d",
    # key expressions whose ranges come from the device probe
    "SELECT CAST(y * 4 AS INT) AS c, COUNT(*) FROM t "
    "GROUP BY CAST(y * 4 AS INT) ORDER BY c",
    "SELECT v % 7 AS m, s, SUM(y) FROM t WHERE b GROUP BY v % 7, s "
    "ORDER BY m, s",
    "SELECT s, COUNT(*) AS c FROM t GROUP BY s ORDER BY c DESC, s LIMIT 5",
], ids=["timestamp", "dict_bool", "date", "probed_cast", "probed_mod",
        "dict_topn"])
def test_key_types(typed_twins, sql):
    jx, pt = typed_twins
    assert_same(jx.sql(sql), pt.sql(sql))


def test_top_k_names_roadmap_a3(twins):
    """TOP_K (ROADMAP A3) is no longer refused: it runs on each session
    config and equals the JAX package (the name is kept from when it
    raised; its tests: tests/test_torch_arrays.py)."""
    _name, sessions = twins
    out = []
    for hdk in sessions:
        h = hdk.scan("h")
        out.append(h.agg("g", h["v"].top_k(3), h["v"].bottom_k(2)).run())
    assert_same(*out, ordered=False)


# -- the NDV estimator -------------------------------------------------------

@pytest.mark.parametrize("keys", ["float", "nullable_filtered"])
def test_ndv_estimate_matches(keys):
    """Over 2^20 rows with unbounded keys, both packages size the group
    buffer from the same Chao84 sample estimate."""
    rng = np.random.default_rng(5)
    n = (1 << 20) + 4096
    data = {"a": rng.integers(0, 40_000, n) * 0.25,
            "b": _nullable(rng, rng.integers(0, 30_000, n) * 2**35, 0.02),
            "v": rng.integers(0, 10, n)}
    jx, pt = twin_sessions({"u": data},
                           **{"exec.group_by.ndv_sample_min_rows": 1 << 12})
    # no ORDER BY: the groups come in key order from the sort itself
    sql = ("SELECT a, COUNT(*), SUM(v) FROM u GROUP BY a" if keys == "float"
           else "SELECT b, COUNT(*), SUM(v) FROM u WHERE v > 2 GROUP BY b")
    assert_same(jx.sql(sql), pt.sql(sql))
    assert pt._executor._ndv_estimate is not None
    assert pt._executor._ndv_estimate == jx._executor._ndv_estimate
    assert pt._executor._groupby_attempts == jx._executor._groupby_attempts


# -- where the JAX package is not exact ------------------------------------

def _extremes_data():
    """Dense keys g; x holds INT64 extremes and NULLs (g = 0 all NULL)."""
    g, x = [], []
    for gi in range(12):
        for j in range(3):
            g.append(gi)
            if gi == 0:
                x.append(None)
            elif gi == 5:
                x.append(int(I64.min) if j == 0 else None)
            elif gi == 8:
                x.append(int(I64.min) + 1)
            else:
                x.append(int(I64.max) if j != 2 else None)
    keep = (np.arange(len(g)) % 4 != 3).astype(np.int8)
    return {"g": np.asarray(g), "x": x, "keep": keep}


_JAX_FAULT = {
    "identity_topn": "hdk_tpu/exec/agg_exec.py:401 clips the single "
                     "sort key into [imin, imax-1], so a NULL ties with "
                     "INT64_MAX (ROADMAP C)",
    "lex_topn": "hdk_tpu/exec/sort.py:51-70 pins NULLs to the INT64 "
                "extremes, so a NULL ties with INT64_MAX (ROADMAP C)",
    "group_keys": "hdk_tpu/exec/groupby.py:1135-1137 folds a NULL key "
                  "into INT64_MAX on the unpacked sort (ROADMAP C)",
}


def _engines():
    return [pytest.param("torch"),
            pytest.param("jax", marks=pytest.mark.xfail(
                strict=True, reason="the JAX package ties NULL with "
                                    "INT64_MAX (ROADMAP C)"))]


@pytest.fixture(scope="module")
def extremes():
    return twin_sessions({"t": _extremes_data()})


def _pick(extremes, engine):
    jx, pt = extremes
    return pt if engine == "torch" else jx


def _columns(res):
    """Column name -> Python values, None for NULL (exact INT64)."""
    at = res.to_arrow()
    return {name: at.column(name).to_pylist() for name in at.column_names}


@pytest.mark.parametrize("engine", _engines())
def test_identity_topn_int64_extremes(extremes, engine):
    """The identity pass + a small-LIMIT top-n over a masked dense
    buffer, one nullable key at the INT64 extremes, NULLS LAST (the JAX
    package fuses the two; the port sorts the identity table with its
    null-flag lexsort)."""
    h = _pick(extremes, engine).scan("t")
    res = (h.agg("g", "min(x)").agg(["g", "x_min"], "count")
           .sort(("x_min", "asc", "nulls_last"), limit=4).run())
    res = _columns(res)
    # oracle: MIN(x) per g, then ascending, NULLs last, ties by g
    data = _extremes_data()
    mins = {}
    for g, x in zip(data["g"].tolist(), data["x"]):
        if x is not None:
            mins[g] = min(mins.get(g, x), x)
    order = sorted(range(12), key=lambda g: (g not in mins, mins.get(g, 0), g))
    assert res["g"] == order[:4], _JAX_FAULT["identity_topn"]
    assert res["x_min"] == [mins.get(g) for g in order[:4]]


@pytest.mark.parametrize("engine", _engines())
def test_lex_topn_int64_extremes(extremes, engine):
    """A multi-key row top-n under a row mask, INT64 extremes and NULLs,
    NULLS LAST."""
    h = _pick(extremes, engine).scan("t")
    res = (h.filter(h["keep"] == 1)
           .sort(("x", "asc", "nulls_last"), ("g", "desc"), limit=14)
           .run())
    res = _columns(res)
    data = _extremes_data()
    rows = [(x, g) for g, x, k in zip(data["g"].tolist(), data["x"],
                                      data["keep"].tolist()) if k]
    rows.sort(key=lambda r: (r[0] is None, r[0] or 0, -r[1]))
    assert res["g"] == [g for _x, g in rows[:14]], _JAX_FAULT["lex_topn"]
    assert res["x"] == [x for x, _g in rows[:14]]


@pytest.mark.parametrize("engine", _engines())
def test_group_keys_int64_extremes(extremes, engine):
    """GROUP BY a nullable key at the INT64 extremes (no packing: its
    range does not fit 62 bits): NULL is a group of its own."""
    res = _columns(_pick(extremes, engine).sql(
        "SELECT x, COUNT(*) AS c FROM t GROUP BY x ORDER BY x NULLS LAST"))
    data = _extremes_data()
    counts = {}
    for x in data["x"]:
        counts[x] = counts.get(x, 0) + 1
    keys = sorted(counts, key=lambda x: (x is None, x or 0))
    assert res["x"] == keys, _JAX_FAULT["group_keys"]
    assert res["c"] == [counts[x] for x in keys]


# -- module level ------------------------------------------------------------

def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_sortops_match():
    rng = np.random.default_rng(2)
    n = 5000
    a = rng.integers(0, 40, n)
    b = rng.integers(-5, 5, n).astype(np.int32)
    pay = rng.normal(size=n)
    jk, jp = jso.sort_with_payload([jnp.asarray(a), jnp.asarray(b)],
                                   [jnp.asarray(pay)])
    tk, tp, perm = tso.sort_with_payload(
        [torch.from_numpy(a), torch.from_numpy(b)], [torch.from_numpy(pay)])
    for x, y in zip(tk + tp, jk + jp):
        assert np.array_equal(_np(x), _np(y))
    assert np.array_equal(a[_np(perm)], _np(tk[0]))
    jb = jso.changed(jk[0]) | jso.changed(jk[1])
    tb = tso.changed(tk[0]) | tso.changed(tk[1])
    assert np.array_equal(_np(tb), _np(jb))
    ps = tso.PayloadSet()
    t0 = torch.zeros(3)
    assert (ps.add(t0), ps.add(torch.ones(3)), ps.add(t0),
            ps.add(None)) == (0, 1, 0, None)


def _key_cols(rng, n, col):
    a = rng.integers(-3, 40, n)
    b = rng.integers(0, 1000, n) * 5
    bmask = rng.random(n) >= 0.1
    return [col(a, None), col(b, bmask)], [(-3, 39, False), (0, 4995, True)]


def test_pack_unpack_match():
    rng = np.random.default_rng(4)
    jkeys, ranges = _key_cols(rng, 3000, lambda d, m: JCol(
        jnp.asarray(d), None if m is None else jnp.asarray(m)))
    rng = np.random.default_rng(4)
    tkeys, _ = _key_cols(rng, 3000, lambda d, m: from_numpy(d, m, "cpu"))
    jc, jl = jgb.try_pack_keys(jkeys, ranges)
    tc, tl = tgb.try_pack_keys(tkeys, ranges)
    assert jl == tl
    assert np.array_equal(_np(tc), _np(jc))
    for jcol, tcol in zip(jgb.unpack_keys(jc, jkeys, jl),
                          tgb.unpack_keys(tc, tkeys, tl)):
        assert np.array_equal(_np(tcol.data), _np(jcol.data))
        assert (tcol.mask is None) == (jcol.mask is None)
        if tcol.mask is not None:
            assert np.array_equal(_np(tcol.mask), _np(jcol.mask))
    assert tgb.try_pack_keys(tkeys, [(0, 2**61, False), (0, 9, True)]) is None


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("cap", [64, 4096])
def test_groupby_sort_matches(packed, cap):
    """groupby_sort on the same inputs: the first n_groups entries of
    every buffer agree.  At cap 64 the groups overflow; the entries
    before the last, which takes the overflow, agree too."""
    out = []
    for mod, gbm, col in (
            (hdk_tpu, jgb, lambda d, m: JCol(
                jnp.asarray(d), None if m is None else jnp.asarray(m))),
            (hdk_tpu_torch, tgb, lambda d, m: from_numpy(d, m, "cpu"))):
        rng = np.random.default_rng(9)
        n = 6000
        keys, ranges = _key_cols(rng, n, col)
        x = col(rng.integers(-10**9, 10**9, n), rng.random(n) >= 0.1)
        y = col(np.round(rng.normal(5, 2, n) * 8) / 8, rng.random(n) >= 0.1)
        rm = rng.random(n) < 0.9
        k, t = mod.ir.expr.AggKind, mod.types
        specs = [gbm.AggSpec(k.COUNT, None, t.int64(False)),
                 gbm.AggSpec(k.SUM, x, t.int64(True)),
                 gbm.AggSpec(k.AVG, y, t.fp64(True)),
                 gbm.AggSpec(k.MAX, y, t.fp64(True)),
                 gbm.AggSpec(k.COUNT_DISTINCT, x, t.int64(False), True),
                 gbm.AggSpec(k.QUANTILE, y, t.fp64(True), arg1=0.4)]
        rv = jnp.asarray(rm) if gbm is jgb else torch.from_numpy(rm)
        out.append(gbm.groupby_sort(keys, specs, cap, row_valid=rv,
                                    key_ranges=ranges if packed else None))
    (jk, ja, je, jn), (tk, ta, te, tn) = out
    ng = int(jn)
    assert int(tn) == ng
    assert np.array_equal(_np(te), _np(je))
    upto = ng if ng <= cap else cap - 1
    for i, (tc, jc) in enumerate(zip(tk + ta, jk + ja)):
        live = np.ones(upto, bool) if jc.mask is None else _np(jc.mask)[:upto]
        if tc.mask is not None:
            assert np.array_equal(_np(tc.mask)[:upto], live), i
        got, want = _np(tc.data)[:upto][live], _np(jc.data)[:upto][live]
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        else:
            assert np.array_equal(got, want), i
