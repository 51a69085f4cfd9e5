"""Multi-device sessions, the port against the JAX package (the twin of
tests/test_dist_engine.py): the same numpy data goes into
``hdk_tpu.HDK(**{"dist.enable": True, "dist.num_devices": 8})`` over JAX's
8 virtual CPU devices and ``hdk_tpu_torch.HDK(device="cpu", ...)`` with
the same settings, 8 shards on the CPU.  The main frame has 4001 rows,
not a multiple of 8, so the scans pad and mask.

Joins are in tests/test_torch_dist_join.py, window functions in
tests/test_torch_dist_window.py.  Each query's distributed GROUP BY
route (``_dist_agg_route``) and window
route (``_dist_window_route``) must be the JAX package's, and its result
equal (``torch_twin.assert_same``: keys, counts and integers exact,
float64 rtol 1e-9)."""

import numpy as np
import pytest

import jax

from torch_twin import assert_same, twin_sessions

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

DIST = {"dist.enable": True, "dist.num_devices": 8}


def _frame(seed=42, n=4001):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 6, n), "big": rng.integers(0, 10**8, n),
            "v": rng.normal(size=n) * 10,
            "s": rng.choice(["a", "b", "c"], n)}


def _skewed(rng, n, hot_share=0.8):
    return {"k": np.where(rng.random(n) < hot_share, 7,
                          rng.integers(100, 160, n)).astype(np.int64),
            "v": rng.integers(0, 500, n).astype(np.int64),
            "x": rng.normal(size=n)}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    n = 8 * 600
    hol = {"k": (rng.integers(0, 900, n) * 2**33 + 3).astype(np.int64),
           "v": rng.integers(0, 40, n).astype(np.int64),
           "f": rng.normal(size=n)}
    m = 8 * 350
    x = rng.normal(size=m)
    srt = {"x": [None if nul else float(v)
                 for v, nul in zip(x, rng.random(m) < 0.07)],
           "y": rng.integers(0, 9, m)}
    n2 = 8 * 600
    skew = {"k": np.where(rng.random(n2) < 0.9, 123456789,
                          rng.integers(0, 10**9, n2)),
            "v": rng.integers(0, 100, n2)}
    return twin_sessions({"t": _frame(), "hol": hol, "srt_n": srt,
                          "skew": skew}, **DIST)


def _both(sessions, q, ordered=False, agg=None, win=None):
    jx, pt = sessions
    a = jx.sql(q) if isinstance(q, str) else q(jx)
    b = pt.sql(q) if isinstance(q, str) else q(pt)
    assert_same(a, b, ordered=ordered)
    if agg is not None:
        assert jx._executor._dist_agg_route == agg
        assert pt._executor._dist_agg_route == agg
    if win is not None:
        assert jx._executor._dist_window_route == win
        assert pt._executor._dist_window_route == win
    return a, b


def test_session_has_a_mesh_of_8(pair):
    _, pt = pair
    mesh = pt._executor._mesh
    assert mesh is not None and mesh.size == 8
    assert all(str(d) == "cpu" for d in mesh.devices)


@pytest.mark.parametrize("q,route,ordered", [
    ("SELECT k, COUNT(*) AS c, SUM(v) AS sv, MIN(v) AS mn, MAX(v) AS mx "
     "FROM t GROUP BY k", "dense_psum", False),
    ("SELECT k, COUNT(*) AS c, AVG(v) AS av FROM t WHERE v > -5 "
     "GROUP BY k ORDER BY k", "dense_psum_fused_sort", True),
    ("SELECT s, COUNT(*) AS c FROM t GROUP BY s", "dense_psum", False),
    ("SELECT big, COUNT(*) AS c FROM t GROUP BY big", "two_phase", False),
    ("SELECT big, COUNT(*) AS c FROM t WHERE v > 0 GROUP BY big",
     "two_phase", False),
    ("SELECT k, COUNT(*) AS c, SUM(v) AS sv, MIN(v) AS mn FROM skew "
     "GROUP BY k", "two_phase", False),
    ("SELECT k, COUNT(*) AS c, COUNT(DISTINCT v) AS nd, "
     "MEDIAN(f) AS md FROM hol GROUP BY k", "shuffled", False),
    ("SELECT k, APPROX_QUANTILE(f, 0.5) AS aq, "
     "APPROX_COUNT_DISTINCT(v) AS acd FROM hol GROUP BY k", "two_phase",
     False),
    ("SELECT k, SUM(DISTINCT big) AS sd FROM t GROUP BY k ORDER BY k",
     "distinct_split", True),
])
def test_group_by_routes(pair, q, route, ordered):
    _both(pair, q, ordered=ordered, agg=route)


def test_scalar_aggregate(pair):
    _both(pair, "SELECT COUNT(*) AS c, SUM(v) AS s, STDDEV(v) AS sd FROM t")


def test_projection(pair):
    _both(pair, lambda s: (lambda t: t.proj(x=t["v"] * 2 + 1))(
        s.scan("t")).run(), ordered=True)


@pytest.mark.parametrize("q", [
    "SELECT v, k FROM t ORDER BY v DESC LIMIT 25",
    "SELECT k, v FROM t ORDER BY k DESC, v",
    "SELECT x, y FROM srt_n ORDER BY x, y DESC",
    "SELECT x, y FROM srt_n ORDER BY x DESC NULLS FIRST, y",
    "SELECT v FROM t WHERE v > 0 ORDER BY v OFFSET 13",
])
def test_sort(pair, q):
    _both(pair, q, ordered=True)


def test_merge_cap_retry():
    """~1000 keys over 8 shards with default_max_groups 256: the receiver
    group cap (64) overflows, the ladder widens and retries, and the
    result stays exact."""
    rng = np.random.default_rng(13)
    n = 8 * 500
    data = {"k": (rng.integers(0, 1000, n) * 2**33 + 5).astype(np.int64),
            "v": rng.integers(0, 100, n)}
    jx, pt = twin_sessions({"mo": data}, **DIST, **{
        "exec.group_by.default_max_groups": 256})
    _both((jx, pt), "SELECT k, COUNT(*) AS c, SUM(v) AS sv FROM mo "
          "GROUP BY k", agg="two_phase")
    assert pt._executor._dist_retries >= 1


@pytest.mark.parametrize("threshold,retries", [
    (None, 0), (0.0, 0), (1e9, 1)])
def test_distinct_under_skew_small_caps(threshold, retries):
    """COUNT and SUM DISTINCT with a hot key and small group caps: the
    hot-key probe picks the pair split; under a huge threshold the raw
    shuffle runs first, overflows on the hot key and the ladder moves to
    the pair split.  Exact either way."""
    rng = np.random.default_rng(14)
    cfg = {"exec.group_by.default_max_groups": 512}
    if threshold is not None:
        cfg["dist.heavy_hitter_threshold"] = threshold
    jx, pt = twin_sessions({"zipf": _skewed(rng, 8 * 700)}, **DIST, **cfg)
    _both((jx, pt), "SELECT k, COUNT(*) AS c, COUNT(DISTINCT v) AS nd, "
          "SUM(DISTINCT v) AS sd, SUM(x) AS sx, MAX(v) AS mv FROM zipf "
          "GROUP BY k", agg="distinct_split")
    assert pt._executor._dist_retries == retries


def test_distinct_raw_route_below_threshold():
    """Uniform keys under the hot-key threshold: the raw shuffle, one
    exchange, exact."""
    rng = np.random.default_rng(18)
    n = 8 * 400
    jx, pt = twin_sessions({"r": {"k": rng.integers(0, 64, n),
                                  "v": rng.integers(0, 30, n)}}, **DIST,
                           **{"dist.heavy_hitter_threshold": 1e9})
    _both((jx, pt), "SELECT k, COUNT(DISTINCT v) AS nd FROM r GROUP BY k",
          agg="shuffled")


def test_multi_operand_distinct_takes_the_raw_shuffle():
    rng = np.random.default_rng(15)
    n = 8 * 300
    jx, pt = twin_sessions({"m2": {"k": rng.integers(0, 40, n),
                                   "a": rng.integers(0, 25, n),
                                   "b": rng.integers(0, 90, n)}}, **DIST)
    _both((jx, pt), "SELECT k, COUNT(DISTINCT a) AS nda, "
          "COUNT(DISTINCT b) AS ndb FROM m2 GROUP BY k", agg="shuffled")


def test_fragment_pruning():
    n = 12_000
    rng = np.random.default_rng(16)
    jx, pt = twin_sessions({"pr_t": {"dt": np.arange(n, dtype=np.int64),
                                     "v": rng.normal(size=n)}}, **DIST,
                           **{"storage.fragment_size": 1000})
    _both((jx, pt), "SELECT COUNT(*) AS c, SUM(v) AS s FROM pr_t "
          "WHERE dt >= 3000 AND dt < 4000")
    got = pt._executor._frag_prune_stats
    assert got == jx._executor._frag_prune_stats
    assert got["selected"] < got["total"]


def test_fragment_streaming():
    n = 20_000
    rng = np.random.default_rng(17)
    jx, pt = twin_sessions({"fsd_t": {"g": rng.integers(0, 7, n),
                                      "v": rng.normal(size=n)}}, **DIST, **{
        "storage.fragment_size": 1000, "exec.scan_stream_bytes": 32_000})
    _both((jx, pt), "SELECT g, COUNT(*) AS c, SUM(v) AS s FROM fsd_t "
          "GROUP BY g")
    chunks = pt._executor._frag_stream_chunks
    assert chunks == jx._executor._frag_stream_chunks and chunks > 1


@pytest.mark.parametrize("dist", [False, True])
def test_null_sort_keys_tie(dist):
    """NULL sort keys tie whatever data lies under them, so the next key
    orders them (a masked column keeps its data under the mask): the
    port's sort, on one device and on 8 shards, against numpy."""
    import hdk_tpu_torch

    rng = np.random.default_rng(19)
    n = 8 * 300
    y = rng.integers(0, 50, n)
    null = rng.random(n) < 0.3
    g = rng.permutation(n)
    cfg = DIST if dist else {}
    pt = hdk_tpu_torch.HDK(device="cpu", **cfg)
    pt.import_pydict({"y": np.ma.MaskedArray(y, null), "g": g}, name="nt")
    out = pt.sql("SELECT y, g FROM nt ORDER BY y, g").to_numpy()
    key = np.where(null, np.iinfo(np.int64).max, y)
    order = np.lexsort((g, key))
    assert np.array_equal(out["g"], g[order])
    assert np.array_equal(np.ma.getmaskarray(out["y"]), null[order])
    if dist:
        assert pt._executor._dist_sort_route == "range"
