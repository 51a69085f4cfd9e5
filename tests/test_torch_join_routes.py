"""The perfect join's value-table and delta-spread routes and the measured
join route A/B, the port against the JAX package: the cases of
tests/test_spread_join.py and the two join cases of tests/test_feedback.py,
each run through ``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device="cpu")``
over the same seeded numpy tables, with the route label of both packages
compared exactly; and ``build_value_table`` / ``spread_inner_fk`` against
the JAX functions on the same inputs.  ``spread_join_min_rows`` is 50 so
that a few hundred probe rows take the spread route.  Integers and counts
compare exactly, floats to rtol 1e-9 (tests/torch_twin.py)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from hdk_tpu.exec import join as jj
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu_torch.exec import join as tj
from hdk_tpu_torch.exec.masked import MaskedCol as TCol
from torch_twin import assert_same, twin_sessions

SPREAD = {"exec.join.spread_join_min_rows": 50}


def _fk(seed, n_probe=400, n_build=64, **build_cols):
    """An FK join the spread route takes: unique build keys filling
    [0, n_build), every probe key among them."""
    rng = np.random.default_rng(seed)
    lhs = {"k": rng.integers(0, n_build, n_probe),
           "lv": rng.normal(size=n_probe).astype(np.float32)}
    rhs = {"k": rng.permutation(n_build),
           **{c: (f(rng, n_build) if callable(f) else f)
              for c, f in build_cols.items()}}
    return lhs, rhs


def _run(tables, make, **config):
    """(reference result, port result, reference route, port route)."""
    jx, pt = twin_sessions(tables, **{**SPREAD, **config})
    want, got = make(jx), make(pt)
    return want, got, jx._executor._join_route, pt._executor._join_route


def _join_agg(*aggs, keys=()):
    def make(s):
        q = s.scan("sp_l").join(s.scan("sp_r"), "k", "k").agg(list(keys),
                                                                *aggs)
        return q.sort(*keys).run() if keys else q.run()
    return make


def _f32(rng, n):
    return rng.normal(size=n).astype(np.float32)


def test_spread_route_taken_and_correct():
    lhs, rhs = _fk(1, w=_f32)
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(w)", "count"))
    assert rj == rp == "spread"
    assert_same(want, got)
    assert got.to_numpy()["count"][0] == 400


@pytest.mark.parametrize("dtype,gen", [
    ("f32", _f32),
    ("i32", lambda rng, n: rng.integers(-2**31, 2**31, n, dtype=np.int32)),
    ("i64", lambda rng, n: rng.integers(-2**40, 2**40, n, dtype=np.int64)),
    ("i64_extremes", lambda rng, n: np.concatenate([
        np.asarray([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]),
        rng.integers(-2**62, 2**62, n - 4)])),
    ("i16", lambda rng, n: rng.integers(-2**15, 2**15, n, dtype=np.int16)),
    ("i8", lambda rng, n: rng.integers(-128, 128, n, dtype=np.int8)),
])
def test_spread_dtypes_exact(dtype, gen):
    """Each spreadable dtype comes back bit for bit through the deltas
    and prefix sums (int64 as two 32-bit words)."""
    lhs, rhs = _fk(2, w=gen)
    aggs = ("min(w)", "max(w)") + (() if dtype == "i64_extremes"
                                   else ("sum(w)",))
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs}, _join_agg(*aggs))
    assert rj == rp == "spread"
    assert_same(want, got)
    w = rhs["w"][np.argsort(rhs["k"])][lhs["k"]]
    out = got.to_numpy()
    assert out["w_min"][0] == w.min() and out["w_max"][0] == w.max()


def test_spread_bool_exact():
    """bool comes back exactly (grouped on the spread column)."""
    lhs, rhs = _fk(3, w=lambda rng, n: rng.integers(0, 2, n).astype(bool))
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("count", keys=("w",)))
    assert rj == rp == "spread"
    assert_same(want, got)


def test_spread_nullable_column():
    rng = np.random.default_rng(4)
    # a float32 column with NULLs (as Arrow holds one)
    w = pa.array(_f32(rng, 64), mask=np.arange(64) % 5 == 0)
    lhs, rhs = _fk(4, w=w)
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(w)", "count(w)", "count"))
    assert rj == rp == "spread"
    assert_same(want, got)


def test_f64_column_is_demoted():
    """float64 build columns take the value tables under a label that
    says so, in both packages."""
    lhs, rhs = _fk(5, w=lambda rng, n: rng.normal(size=n))
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(w)", "count"))
    assert rj == rp == "perfect(spread-demoted:f64)"
    assert_same(want, got)


def test_groupby_over_spread_join():
    lhs, rhs = _fk(6, g=lambda rng, n: rng.integers(0, 8, n),
                   w=lambda rng, n: rng.integers(0, 100, n).astype(
                       np.float32))
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(w)", "count", keys=("g",)))
    assert rj == rp == "spread"
    assert_same(want, got)


def test_spread_multi_column():
    """Several build columns of mixed dtypes spread through one sort."""
    lhs, rhs = _fk(7, a=_f32,
                   b=lambda rng, n: rng.integers(0, 1000, n, dtype=np.int64),
                   c=lambda rng, n: rng.integers(0, 2, n).astype(bool))
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(a)", "sum(b)", "count(c)"))
    assert rj == rp == "spread"
    assert_same(want, got)


def test_sort_over_join_declines():
    """A Sort straight over the join reads every column: the demand is
    all columns and the spread route declines."""
    lhs, rhs = _fk(8, n_probe=120, w=_f32)
    want, got, rj, rp = _run(
        {"sp_l": lhs, "sp_r": rhs},
        lambda s: s.scan("sp_l").join(s.scan("sp_r"), "k", "k").sort(
            "w", limit=2000).run())
    assert rj == rp == "perfect"
    assert_same(want, got, ordered=False)


def test_dead_project_expr_declines():
    """A Project expression no consumer reads still runs: its probe
    column is demanded, so the spread route declines."""
    lhs, rhs = _fk(9, w=_f32)

    def make(s):
        j = s.scan("sp_l").join(s.scan("sp_r"), "k", "k")
        return j.proj(w=j.ref("w"), dead=j.ref("lv")).agg([], "sum(w)").run()

    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs}, make)
    assert rj == rp == "perfect"
    assert_same(want, got)


def test_probe_columns_demanded_declines():
    lhs, rhs = _fk(10, w=_f32)
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(lv)", "sum(w)"))
    assert rj == rp == "perfect"
    assert_same(want, got)


def test_incomplete_table_declines():
    """Build keys with holes in [min, max]: matching reads the table's
    occupancy and the spread route declines."""
    lhs = {"k": np.repeat(np.arange(0, 64, 2), 10)}
    rhs = {"k": np.arange(0, 64, 2), "w": np.arange(32, dtype=np.float32)}
    want, got, rj, rp = _run({"sp_l": lhs, "sp_r": rhs},
                             _join_agg("sum(w)"))
    assert rj == rp == "perfect"
    assert_same(want, got)


def test_spread_column_outside_the_demand_raises():
    """An undemanded column of a spread output raises; it never gathers
    in silence."""
    from hdk_tpu_torch.exec.scalar import ExecError

    lhs, rhs = _fk(11, w=_f32)
    _, pt = twin_sessions({"sp_l": lhs, "sp_r": rhs}, **SPREAD)
    ex = pt._executor
    seen = []
    orig = ex._try_spread_join

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out)
        return out

    ex._try_spread_join = spy
    _join_agg("sum(w)")(pt)
    (out,) = seen
    assert out.columns[3].data.shape[0] == 64 + 400  # w, the demanded one
    with pytest.raises(ExecError, match="demand"):
        out.columns[1]  # lv


# -- the measured join route A/B ---------------------------------------------

def _feedback_tables(seed, dup_build=False):
    rng = np.random.default_rng(seed)
    n = 70_000  # over the A/B's 2^16 probe rows
    lhs = {"k": rng.integers(0, 64, n).astype(np.int64),
           "v": rng.normal(size=n).astype(np.float32)}
    if dup_build:
        rhs = {"k": np.concatenate([np.arange(64), np.arange(64)]),
               "w": np.ones(128, np.float32)}
    else:
        rhs = {"k": np.arange(64, dtype=np.int64),
               "w": rng.normal(size=64).astype(np.float32)}
    return {"fbj_l": lhs, "fbj_r": rhs}


def _fb_query(s):
    return s.scan("fbj_l").join(s.scan("fbj_r"), "k", "k").agg(
        [], "count", "sum(w)").run()


def _tune(sess):
    fb = sess._executor._feedback
    (sig,) = {s for s, _ in fb._t if s.endswith("|tunejoin")}
    return fb.measured(sig)


_LABEL = {"spread": "spread", "value": "perfect", "hash": "hash"}


def test_join_route_feedback_explores_and_settles():
    """The first three runs explore spread, value and hash in that order,
    each timed; the fourth runs the measured fastest.  Every run equals
    the reference's answer."""
    jx, pt = twin_sessions(_feedback_tables(12), **SPREAD)
    routes = {"jx": [], "pt": []}
    for _ in range(4):
        want = _fb_query(jx)
        routes["jx"].append(jx._executor._join_route)
        got = _fb_query(pt)
        routes["pt"].append(pt._executor._join_route)
        assert_same(want, got)
    assert routes["jx"][:3] == routes["pt"][:3] == ["spread", "perfect",
                                                   "hash"]
    for name, sess in (("jx", jx), ("pt", pt)):
        measured = _tune(sess)
        assert set(measured) == {"spread", "value", "hash"}
        assert all(0 < v < float("inf") for v in measured.values())
        winner = min(measured, key=measured.get)
        assert routes[name][3] == _LABEL[winner], (name, measured)


def test_join_route_feedback_inadmissible_poisoned():
    """Duplicate build keys refuse both perfect-table routes: each is
    recorded once as +inf, never explored again, and the runs settle on
    the hash route."""
    jx, pt = twin_sessions(_feedback_tables(13, dup_build=True))
    for _ in range(3):
        assert_same(_fb_query(jx), _fb_query(pt))
        assert (jx._executor._join_route == pt._executor._join_route
                == "hash")
    for sess in (jx, pt):
        m = _tune(sess)
        assert m["spread"] == m["value"] == float("inf")
        assert np.isfinite(m["hash"])
    ex = pt._executor
    tried = []
    orig = ex._try_perfect_join

    def spy(*a, route=None, **kw):
        tried.append(route)
        return orig(*a, route=route, **kw)

    ex._try_perfect_join = spy
    _fb_query(pt)
    assert tried == [] and ex._join_route == "hash"


# -- the building blocks against the JAX functions ---------------------------

def _cols(data, mask):
    return (JCol(jnp.asarray(data), None if mask is None
                 else jnp.asarray(mask)),
            TCol(torch.from_numpy(data),
                 None if mask is None else torch.from_numpy(mask)))


@pytest.mark.parametrize("masked", [False, True])
def test_build_value_table(masked):
    rng = np.random.default_rng(14)
    size, n = 300, 200
    keys = rng.permutation(size)[:n].astype(np.int64) + 17
    kmask = rng.random(n) > 0.1 if masked else None
    vals = rng.normal(size=n).astype(np.float32)
    vmask = rng.random(n) > 0.3 if masked else None
    kj, kt = _cols(keys, kmask)
    vj, vt = _cols(vals, vmask)
    sj = jj.build_slots(kj, 17, size)
    st = tj.build_slots(kt, 17, size)
    assert np.array_equal(np.asarray(sj), st.numpy())
    dj, mj = jj.build_value_table(vj, sj, size)
    dt, mt = tj.build_value_table(vt, st, size)
    assert np.array_equal(np.asarray(dj).view(np.int32),
                          dt.numpy().view(np.int32))
    assert (mj is None) == (mt is None)
    if mj is not None:
        assert np.array_equal(np.asarray(mj), mt.numpy())


def test_spread_inner_fk_against_jax():
    """Every spreadable dtype, masked and not, bit for bit, with the
    build rows dead in the same places."""
    rng = np.random.default_rng(15)
    size, npr = 97, 500
    probe = rng.integers(0, size, npr)
    cols = [
        (rng.normal(size=size).astype(np.float32), None),
        (rng.integers(-2**31, 2**31, size, dtype=np.int32),
         rng.random(size) > 0.2),
        (np.concatenate([[np.iinfo(np.int64).min, np.iinfo(np.int64).max],
                         rng.integers(-2**62, 2**62, size - 2)]), None),
        (rng.integers(-2**15, 2**15, size, dtype=np.int16), None),
        (rng.integers(-128, 128, size, dtype=np.int8),
         rng.random(size) > 0.5),
        (rng.random(size) > 0.5, None),
    ]
    pj, outj = jj.spread_inner_fk(
        jnp.asarray(probe.astype(np.int32)),
        [(jnp.asarray(d), None if m is None else jnp.asarray(m))
         for d, m in cols], size)
    pt_, outt = tj.spread_inner_fk(
        torch.from_numpy(probe),
        [(torch.from_numpy(d), None if m is None else torch.from_numpy(m))
         for d, m in cols], size)
    assert np.array_equal(np.asarray(pj), pt_.numpy())
    assert int(pt_.sum()) == npr
    for (dj, mj), (dt, mt), (d, _m) in zip(outj, outt, cols):
        a, b = np.asarray(dj), dt.numpy()
        assert a.dtype == b.dtype == d.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
        assert (mj is None) == (mt is None)
        if mj is not None:
            assert np.array_equal(np.asarray(mj), mt.numpy())
