"""Equi-joins, outer joins and loop joins against the JAX package: the
cases of tests/test_join.py, tests/test_outer_joins.py (but the
multi-device one) and tests/test_loop_join.py, each run through
``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device="cpu")`` over the same
seeded numpy tables.  Each case also requires the port to take the
reference's route label, the perfect route's variants included
("spread", "perfect(recycled)", "perfect(spread-demoted:f64)").  Join
output order is unspecified in SQL, so results compare
as row multisets unless the query orders them.  Tolerances: see
tests/torch_twin.py."""

import numpy as np
import pytest

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same, twin_sessions


def _nullable(values, null_at):
    return [None if i in null_at else v for i, v in enumerate(values)]


def _tables():
    rng = np.random.default_rng(43)
    n_l, n_r = 3000, 500
    big_l = rng.integers(0, 50, 800).astype(np.float64).tolist()
    big_r = rng.integers(25, 75, 300).astype(np.float64).tolist()
    tables = {
        # tests/test_join.py
        "join_l": {"k": rng.integers(0, 600, n_l), "v": rng.normal(size=n_l)},
        "join_r": {"k": rng.permutation(600)[:n_r],
                   "w": rng.integers(0, 100, n_r)},
        "join_dup": {"k": rng.integers(0, 50, 200), "u": rng.normal(size=200)},
        "mk_l": {"a": rng.integers(0, 10, 1000), "b": rng.integers(0, 10, 1000),
                 "v": np.arange(1000)},
        "mk_r": {"a": np.repeat(np.arange(10), 10),
                 "b": np.tile(np.arange(10), 10), "w": np.arange(100) * 2},
        "nk_l": {"k": [1, None, 2, None], "v": [1, 2, 3, 4]},
        "nk_r": {"k": [1, None, 3], "w": [10, 20, 30]},
        "sk_l": {"s": ["a", "b", "c", "a"], "v": [1, 2, 3, 4]},
        "sk_r": {"s": ["a", "c"], "w": [10, 30]},
        "ej_l": {"k": [1, 2], "v": [1, 2]},
        "ej_r": {"k": [5], "w": [9]},
        "pj_l": {"k": [5, 3, 9, 5, 100], "v": [1, 2, 3, 4, 5]},
        "pj_r": {"k": [3, 5, 9], "w": [30, 50, 90]},
        "pjd_l": {"k": [1, 2, 2], "v": [10, 20, 30]},
        "pjd_r": {"k": [2, 2, 3], "w": [7, 8, 9]},
        "lr_l": {"k": rng.integers(0, 10, 200), "v": rng.integers(0, 100, 200)},
        "lr_r": {"k": np.arange(10), "w": rng.integers(0, 100, 10)},
        "sr_l": {"k": rng.integers(0, 8, 150), "v": rng.integers(0, 100, 150)},
        "sr_r": {"k": np.arange(8), "w": rng.integers(0, 100, 8)},
        "mix_l": {"k": np.arange(20, dtype=np.int64)},
        "mix_r": {"kf": np.arange(0, 40, 2).astype(np.float64),
                  "w": np.arange(20)},
        "mix_r2": {"kf": np.arange(20) + 0.5, "w": np.arange(20)},
        "mj_l": {"k": rng.integers(0, 30, 500), "f": rng.integers(0, 2, 500)},
        "mj_r": {"k": np.arange(30), "g": rng.integers(0, 2, 30),
                 "w": rng.normal(size=30)},
        "bl_r": {"k": np.arange(10), "flag": rng.random(10) < 0.5,
                 "q": rng.integers(-5, 5, 10).astype(np.int8)},
        "bl_dup": {"k": rng.integers(0, 8, 30), "flag": rng.random(30) < 0.5},
        "cp_l": {"k": rng.integers(0, 40, 2000)},
        "cp_r": {"k": np.arange(40), "g": np.arange(40) % 4,
                 "w": np.arange(40, dtype=np.float32)},
        # tests/test_outer_joins.py
        "oj_l": {"k": [1.0, 2.0, 3.0, 4.0, None, 2.0],
                 "a": [10.0, 20.0, 30.0, 40.0, 50.0, 60.0]},
        "oj_r": {"k": [1.0, 2.0, 2.0, 5.0, None],
                 "x": [3.0, 6.0, 7.0, 9.0, 11.0]},
        "oj_bl": {"k": _nullable(big_l, set(rng.permutation(800)[:40])),
                  "a": rng.normal(size=800)},
        "oj_br": {"k": _nullable(big_r, set(rng.permutation(300)[:20])),
                  "x": rng.normal(size=300)},
        "oj_sl": {"s": ["a", "b", None, "d"], "v": [1, 2, 3, 4]},
        "oj_sr": {"s": ["a", "c", None], "w": [10, 30, 50]},
        # tests/test_loop_join.py
        "a": {"x": rng.integers(0, 20, 60), "u": rng.normal(size=60).round(6)},
        "b": {"y": rng.integers(0, 20, 35), "w": rng.integers(0, 9, 35)},
        "big": {"z": np.arange(9000)},
    }
    return tables


@pytest.fixture(scope="module")
def sessions():
    return twin_sessions(_tables())


@pytest.fixture(scope="module")
def spread_port():
    """The port over the same tables with the spread route admitted at
    any probe size (``spread_join_min_rows`` 1)."""
    pt = hdk_tpu_torch.HDK(device="cpu",
                           **{"exec.join.spread_join_min_rows": 1})
    for name, data in _tables().items():
        pt.import_pydict(data, name=name)
    return pt


def _join(l, r, lk, rk, how="inner", cond=None):
    """``l.join(r, ...)`` over two table names; ``cond(tl, tr)`` builds the
    residual from the two scans."""
    def run(s):
        tl, tr = s.scan(l), s.scan(r)
        c = cond(tl, tr) if cond is not None else None
        return tl.join(tr, lk, rk, how=how, cond=c).run()
    return run


def _sql(query):
    return lambda s: s.sql(query)


def _filtered(how):
    def run(s):
        tl, tr = s.scan("mj_l"), s.scan("mj_r")
        return tl.filter(tl["f"] == 1).join(tr.filter(tr["g"] == 1), "k",
                                            "k", how=how).run()
    return run


def _cache_filter(gval):
    def run(s):
        tl, tr = s.scan("cp_l"), s.scan("cp_r")
        return (tl.join(tr.filter(tr["g"] == gval), "k", "k")
                .agg([], "count", "sum(w)").run())
    return run


def _empty_build(how):
    def run(s):
        tl, tr = s.scan("ej_l"), s.scan("ej_r")
        empty = tr.filter(tr["w"] > 100).run().scan  # a 0-row table
        return tl.join(empty, "k", "k", how=how).run()
    return run


def _join_then_groupby(s):
    return (s.scan("join_l").join(s.scan("join_r"), "k", "k")
            .agg("w", "count", "sum(v)").run())


CASES = {
    # tests/test_join.py
    "inner_unique_build": _join("join_l", "join_r", "k", "k"),
    "inner_one_to_many": _join("join_l", "join_dup", "k", "k"),
    "left": _join("join_l", "join_r", "k", "k", "left"),
    "semi": _join("join_l", "join_r", "k", "k", "semi"),
    "anti": _join("join_l", "join_r", "k", "k", "anti"),
    "left_one_to_many": _join("join_l", "join_dup", "k", "k", "left"),
    "semi_one_to_many": _join("join_l", "join_dup", "k", "k", "semi"),
    "anti_one_to_many": _join("join_l", "join_dup", "k", "k", "anti"),
    "multikey": _join("mk_l", "mk_r", ["a", "b"], ["a", "b"]),
    "null_keys_inner": _join("nk_l", "nk_r", "k", "k"),
    "null_keys_anti": _join("nk_l", "nk_r", "k", "k", "anti"),
    "null_keys_left": _join("nk_l", "nk_r", "k", "k", "left"),
    # bool and int8 build columns under the NULL padding keep their type
    "left_narrow_build_columns": _join("lr_l", "bl_r", "k", "k", "left"),
    "left_bool_build_one_to_many": _join("lr_l", "bl_dup", "k", "k",
                                         "left"),
    "string_key": _join("sk_l", "sk_r", "s", "s"),
    "string_key_anti": _join("sk_l", "sk_r", "s", "s", "anti"),
    "residual": _join("join_l", "join_r", "k", "k",
                      cond=lambda l, r: l["v"] > r["w"].cast("fp64") / 100.0),
    "join_then_groupby": _join_then_groupby,
    "no_match_inner": _join("ej_l", "ej_r", "k", "k"),
    "no_match_left": _join("ej_l", "ej_r", "k", "k", "left"),
    "empty_build_inner": _empty_build("inner"),
    "empty_build_left": _empty_build("left"),
    "empty_build_semi": _empty_build("semi"),
    "empty_build_anti": _empty_build("anti"),
    **{f"perfect_dense_{how}": _join("pj_l", "pj_r", "k", "k", how)
       for how in ("inner", "left", "semi", "anti")},
    "perfect_falls_back_on_duplicates": _join("pjd_l", "pjd_r", "k", "k"),
    "left_residual_on": _join("lr_l", "lr_r", "k", "k", "left",
                              cond=lambda l, r: r["w"] > 50),
    "semi_residual": _join("sr_l", "sr_r", "k", "k", "semi",
                           cond=lambda l, r: l["v"] > r["w"]),
    "anti_residual": _join("sr_l", "sr_r", "k", "k", "anti",
                           cond=lambda l, r: l["v"] > r["w"]),
    "mixed_numeric_keys": _join("mix_l", "mix_r", "k", "kf"),
    "mixed_numeric_keys_no_match": _join("mix_l", "mix_r2", "k", "kf"),
    **{f"filtered_{how}": _filtered(how)
       for how in ("inner", "left", "semi", "anti")},
    **{f"masked_build_cache_g{g}": _cache_filter(g) for g in (0, 1, 2)},
    # tests/test_outer_joins.py
    "right_join_sql": _sql("SELECT l.k, l.a, r.x FROM oj_l l "
                           "RIGHT JOIN oj_r r ON l.k = r.k"),
    "right_outer_join_residual": _sql(
        "SELECT l.k, l.a, r.x FROM oj_l l RIGHT OUTER JOIN "
        "oj_r r ON l.k = r.k AND l.a < 40"),
    "full_outer_join_sql": _sql(
        "SELECT l.k, l.a, r.k AS rk, r.x FROM oj_l l "
        "FULL OUTER JOIN oj_r r ON l.k = r.k"),
    "full_join_residual": _sql(
        "SELECT l.k, l.a, r.x FROM oj_l l FULL JOIN oj_r r "
        "ON l.k = r.k AND r.x > 5"),
    "right_join_larger_dup_keys": _sql(
        "SELECT l.k, l.a, r.x FROM oj_bl l RIGHT JOIN oj_br r ON l.k = r.k"),
    "full_join_larger_dup_keys": _sql(
        "SELECT l.k, l.a, r.x FROM oj_bl l "
        "FULL OUTER JOIN oj_br r ON l.k = r.k"),
    "builder_right": _join("oj_l", "oj_r", "k", "k", "right"),
    "builder_full": _join("oj_l", "oj_r", "k", "k", "full"),
    "left_join_residual_on_sql": _sql(
        "SELECT l.k, l.a, r.x FROM oj_l l LEFT JOIN oj_r r "
        "ON l.k = r.k AND r.x > 5"),
    "full_join_string_keys": _sql(
        "SELECT l.v, r.w FROM oj_sl l FULL JOIN oj_sr r ON l.s = r.s"),
    # tests/test_loop_join.py
    "explicit_cross_join": _sql(
        "SELECT x, y FROM a CROSS JOIN b WHERE x = 3 AND w = 1"),
    "comma_from_product": _sql("SELECT COUNT(*) AS c FROM a, b"),
    "comma_from_filtered": _sql(
        "SELECT x, y, w FROM a, b WHERE x + 1 = y AND u > 0"),
    "non_equi_on": _sql("SELECT x, y FROM a JOIN b ON x < y WHERE w = 2"),
    "cross_join_all_columns": _sql("SELECT * FROM a CROSS JOIN b"),
}

# the query orders its rows: compare them in order
ORDERED = {
    "right_join_aggregate_above": _sql(
        "SELECT r.x, COUNT(l.a) AS c FROM oj_l l RIGHT JOIN oj_r r "
        "ON l.k = r.k GROUP BY r.x ORDER BY r.x"),
    "join_order_limit": _sql(
        "SELECT l.k, l.v, r.w FROM join_l l JOIN join_r r ON l.k = r.k "
        "ORDER BY l.v DESC LIMIT 25"),
}


def _route(s):
    """The route label of the session's last equi-join, exactly: the
    perfect route's variants ("spread", "perfect(recycled)",
    "perfect(spread-demoted:f64)") included."""
    return s._executor._join_route


def _run_both(sessions, make):
    jx, pt = sessions
    jx._executor._join_route = pt._executor._join_route = None
    want, got = make(jx), make(pt)
    return want, got, _route(jx), _route(pt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_join(sessions, name):
    want, got, route_jx, route_pt = _run_both(sessions, CASES[name])
    assert route_pt == route_jx
    assert_same(want, got, ordered=False)


@pytest.mark.parametrize("name", sorted(ORDERED))
def test_join_ordered(sessions, name):
    want, got, route_jx, route_pt = _run_both(sessions, ORDERED[name])
    assert route_pt == route_jx
    assert_same(want, got)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(ORDERED))
def test_demand_safety_sweep(sessions, spread_port, name):
    """Every query again in the port with the spread route admitted at any
    size: none pulls a column outside a spread output's demand set (those
    raise), and each equals the reference at its default settings.  The
    routes may differ: the perfect table's range guard also reads
    ``spread_join_min_rows``."""
    make = CASES.get(name) or ORDERED[name]
    want = make(sessions[0])
    got = make(spread_port)
    assert_same(want, got, ordered=name in ORDERED)


def test_demand_safety_sweep_took_the_spread_route(sessions, spread_port):
    """The sweep reaches the spread route: an FK join whose consumer reads
    build columns only takes it at any size."""
    got = _sql("SELECT g, COUNT(*) AS c, SUM(w) AS s FROM cp_l JOIN cp_r "
               "ON cp_l.k = cp_r.k GROUP BY g ORDER BY g")
    want = got(sessions[0])
    res = got(spread_port)
    assert spread_port._executor._join_route == "spread"
    assert_same(want, res)


def test_routes_taken():
    """The route each kind of build takes on its first run, in a fresh
    port session (the cases above hold the reference to the same); a
    filtered build side is recycled from its second run on."""
    pt = hdk_tpu_torch.HDK(device="cpu")
    for name, data in _tables().items():
        pt.import_pydict(data, name=name)
    for name, route in (("inner_unique_build", "perfect"),
                        ("inner_one_to_many", "hash"),
                        ("multikey", "hash"),
                        ("string_key", "perfect"),
                        ("mixed_numeric_keys", "hash"),
                        ("filtered_inner", "perfect"),
                        ("filtered_inner", "perfect(recycled)")):
        pt._executor._join_route = None
        CASES[name](pt).to_arrow()
        assert pt._executor._join_route == route, name


def test_warm_run_builds_nothing(sessions):
    """A repeated join reads its build tables from the caches, the
    filtered build side's (a fresh row mask every run) too."""
    _, pt = sessions
    ex = pt._executor
    for name in ("inner_one_to_many", "filtered_inner", "semi",
                 "masked_build_cache_g1"):
        CASES[name](pt).to_arrow()
        before = ex._join_builds
        CASES[name](pt).to_arrow()
        assert ex._join_builds == before, name


ERRORS = {
    "inner_cap_enforced": ("SELECT COUNT(*) AS c FROM a, big",
                           "loop_join_inner_table_max"),
    "builder_non_equi_left_raises": ("SELECT x FROM a LEFT JOIN b ON x < y",
                                     "equality"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_join_errors(sessions, name):
    sql, match = ERRORS[name]
    for s in sessions:
        with pytest.raises(Exception, match=match):
            s.sql(sql).to_arrow()


def test_loop_join_disabled():
    for mod in (hdk_tpu, hdk_tpu_torch):
        kw = {"device": "cpu"} if mod is hdk_tpu_torch else {}
        s = mod.HDK(**kw, **{"exec.join.enable_loop_join": False})
        s.import_pydict({"x": [1, 2]}, name="p")
        s.import_pydict({"y": [3]}, name="q")
        with pytest.raises(Exception, match="enable_loop_join"):
            s.sql("SELECT * FROM p, q").to_arrow()


def _filtered_left_join_empty_build(s):
    tl, tr = s.scan("mj_l"), s.scan("ej_r")
    empty = tr.filter(tr["w"] > 100).run().scan
    return tl.filter(tl["f"] == 1).join(empty, "k", "k", how="left").run()


# faults of the reference the port does not share (ROADMAP C)
REFERENCE_FAULTS = {
    # a filtered probe side LEFT JOIN an empty build: the reference pads
    # every probe row, the filter-dead ones too
    "filtered_left_join_empty_build": _filtered_left_join_empty_build,
    # a float probe key against an integer build key on the perfect
    # route: the reference truncates the float, so 2.5 matches 2
    "float_probe_int_build": lambda s: s.scan("mix_r2").join(
        s.scan("mix_l"), "kf", "k").run(),
}


@pytest.mark.parametrize("package", [
    pytest.param("hdk_tpu", marks=pytest.mark.xfail(
        strict=True, reason="reference fault, ROADMAP C")),
    "hdk_tpu_torch"])
@pytest.mark.parametrize("name", sorted(REFERENCE_FAULTS))
def test_reference_faults(sessions, name, package):
    """The port against a numpy oracle where the reference goes wrong."""
    jx, pt = sessions
    s = jx if package == "hdk_tpu" else pt
    out = REFERENCE_FAULTS[name](s).to_arrow().to_pydict()
    if name == "filtered_left_join_empty_build":
        data = s._schema.get("mj_l")
        keep = data.column("f").data == 1
        assert sorted(out["k"]) == sorted(data.column("k").data[keep])
        assert all(w is None for w in out["w"])
    else:
        # no half-integral kf equals an integer k
        assert out["kf"] == []


class _Stop(Exception):
    pass


class _Recorder:
    """Stands in for a session in bench_suite.py's join benches: keeps
    the tables they import and stops them at their first query."""

    def __init__(self):
        from types import SimpleNamespace

        self.tables = {}
        self.query = None
        self._executor = SimpleNamespace(code_cache=SimpleNamespace(misses=0))

    def import_pydict(self, data, name=None, schema=None):
        self.tables[name] = data

    def scan(self, name):
        raise _Stop

    def sql(self, query):
        self.query = query
        raise _Stop


@pytest.mark.parametrize("bench", ["bench_join", "bench_zipf_join",
                                   "bench_tpch_q3"])
def test_smoke_join_generators_match_bench_suite(bench):
    """chip_smoke.py's own copies of the join benches' tables equal
    bench_suite.py's, value and dtype (and Q3's SQL is the bench's)."""
    import bench_suite
    import chip_smoke as cs

    rec = _Recorder()
    with pytest.raises(_Stop):
        getattr(bench_suite, bench)(rec, 1e-4)
    if bench == "bench_tpch_q3":
        ours = dict(zip(("customer3", "orders3", "lineitem3"),
                        cs.gen_tpch_q3(1e-4)))
        assert rec.query == cs.TPCH_Q3
    else:
        names = (("trips_j", "payments_j") if bench == "bench_join"
                 else ("trips_z", "payments_z"))
        ours = dict(zip(names, cs.gen_join(1e-4, seed=11 if bench ==
                                           "bench_join" else 17)))
    assert list(ours) == list(rec.tables)
    for name, cols in ours.items():
        theirs = rec.tables[name]
        assert list(cols) == list(theirs), name
        for c in cols:
            assert cols[c].dtype == theirs[c].dtype, (name, c)
            assert np.array_equal(cols[c], theirs[c]), (name, c)
