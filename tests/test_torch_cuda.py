"""The CUDA kernels on the card: each against its plain version, in both
the shared-memory and the global-atomic mode and over the sorted group
ids of the sort-based group-by, K1 at the shapes its design treats
apart, and the main path, the sort route, scalar subqueries, joins,
window functions, array columns, the executor's controls (fragment
streaming and skipping, the watchdog, route feedback, EXPLAIN ANALYZE)
and the facade (a stream, a UDF, a spilled result) on a CUDA session
against the same session on the CPU, and the device memory that an
offload and ``clear_device_mem`` free.  Skips where there is no card.  On the card, without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import hdk_tpu_torch
from hdk_tpu_torch.kernels import hist
from hdk_tpu_torch.ops import onehot

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _int_launches(n_slots, n_entries, dtype=None):
    """Launches of one K2/K3/K4 call as the wrapper plans it."""
    total = 0
    for s0 in range(0, n_slots, hist.INT_MAX_COLS):
        s = min(hist.INT_MAX_COLS, n_slots - s0)
        mode = hist._int_mode(s, n_entries, dtype)
        total += len(hist._int_ranges(mode, s, n_entries, dtype))
    return total


def _refuse_plain_versions(monkeypatch):
    """From here on, a CUDA tensor must never reach a plain version."""
    for k in hist.KERNELS:
        def refuse(*a, _n=k.__name__):
            raise AssertionError(f"{_n}_ref ran on a CUDA tensor")
        monkeypatch.setattr(hist, k.__name__ + "_ref", refuse)


# E=7: shared-memory partials; E=70000 at 8-byte slots: global atomics
@pytest.mark.parametrize("n_entries", [7, 2000, 70_000])
def test_kernels_match_plain_versions(cuda, n_entries):
    gen = torch.Generator(device=cuda).manual_seed(n_entries)
    n = 1_000_000
    gid = torch.randint(-3, n_entries + 3, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    flags = torch.rand((n, 3), device=cuda, generator=gen) < 0.5
    ints = torch.randint(-2**62, 2**62, (n, 2), device=cuda, generator=gen,
                         dtype=torch.int64)
    small = torch.randint(-128, 128, (n, 1), device=cuda, generator=gen,
                          dtype=torch.int8)
    f32 = [torch.rand((n,), device=cuda, generator=gen) * 100
           for _ in range(2)]
    f64 = [torch.rand((n,), device=cuda, generator=gen,
                      dtype=torch.float64) * 1e4 for _ in range(2)]
    refs = {k.__name__: getattr(hist, k.__name__ + "_ref")
            for k in hist.KERNELS}
    before = hist.launches()
    assert torch.equal(hist.count_hist(gid, n_entries),
                       refs["count_hist"](gid, n_entries))
    assert torch.equal(hist.groupby_sums2(gid, flags, n_entries),
                       refs["groupby_sums2"](gid, flags, n_entries))
    for v in (ints, small):
        assert torch.equal(hist.seg_sums_exact(gid, v, n_entries),
                           refs["seg_sums_exact"](gid, v, n_entries))
    for v in (f32, f64):
        # atomic float adds run in no fixed order
        torch.testing.assert_close(hist.groupby_sums(gid, v, n_entries),
                                   refs["groupby_sums"](gid, v, n_entries),
                                   rtol=1e-10, atol=0)
    after = hist.launches()
    assert {k: after[k] - before[k] for k in after} == {
        "count_hist": _int_launches(1, n_entries),
        "groupby_sums2": _int_launches(3, n_entries, torch.bool),
        "seg_sums_exact": (_int_launches(2, n_entries, torch.int64)
                           + _int_launches(1, n_entries, torch.int8)),
        "groupby_sums": 2}


def test_main_path_on_the_card(cuda, monkeypatch):
    rng = np.random.default_rng(3)
    n = 200_000
    x = rng.integers(-10**12, 10**12, n)
    data = {"g": rng.integers(0, 300, n),
            "q": rng.integers(1, 51, n).astype(np.int8),
            "x": np.ma.MaskedArray(x, rng.random(n) < 0.1),
            "y": rng.gamma(2.0, 10.0, n).astype(np.float32)}
    sql = ("SELECT g, COUNT(*), COUNT(x), SUM(x), SUM(q), AVG(y) FROM t "
           "WHERE q < 40 GROUP BY g ORDER BY g")
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device)
        hdk.import_pydict(data, name="t")
        hist.reset_launches()
        out.append(hdk.sql(sql).to_numpy())
    assert all(v > 0 for v in hist.launches().values())
    cpu, gpu = out
    for name in cpu:
        if cpu[name].dtype.kind == "f":
            np.testing.assert_allclose(gpu[name], cpu[name], rtol=1e-9)
        else:
            assert np.array_equal(gpu[name], cpu[name]), name


# the sort route's sorted dense ids, at entry counts above the dense
# layout's limit (2^22) up to ~2^25
@pytest.mark.parametrize("n_entries", [(1 << 22) + 1, (1 << 25) + 1])
def test_seg_sums_over_sorted_gid(cuda, n_entries):
    gen = torch.Generator(device=cuda).manual_seed(n_entries)
    n = 40_000_000
    gid = torch.sort(torch.randint(0, n_entries, (n,), device=cuda,
                                   generator=gen, dtype=torch.int32)).values
    cols = [torch.ones((n,), dtype=torch.bool, device=cuda),
            torch.rand((n,), device=cuda, generator=gen) < 0.7,
            torch.randint(-2**62, 2**62, (n,), device=cuda, generator=gen,
                          dtype=torch.int64),
            torch.randint(-128, 128, (n,), device=cuda, generator=gen,
                          dtype=torch.int8),
            torch.rand((n,), device=cuda, generator=gen,
                       dtype=torch.float64) * 1e4]
    before = hist.launches()
    got = onehot.seg_sums(cols, gid, n_entries, ones_ids=[0])
    after = hist.launches()
    assert {k: after[k] - before[k] for k in after} == {
        "count_hist": 1,
        "groupby_sums2": _int_launches(1, n_entries, torch.bool),
        "seg_sums_exact": 2, "groupby_sums": 1}
    assert torch.equal(got[0], hist.count_hist_ref(gid, n_entries))
    assert torch.equal(got[1], hist.groupby_sums2_ref(
        gid, cols[1][:, None], n_entries)[:, 0])
    for i in (2, 3):
        assert torch.equal(got[i], hist.seg_sums_exact_ref(
            gid, cols[i][:, None], n_entries)[0])
    torch.testing.assert_close(
        got[4], hist.groupby_sums_ref(gid, [cols[4]], n_entries)[:, 0],
        rtol=1e-10, atol=0)


# K1 at the shapes its design treats apart: one group (every lane a peer),
# E = 7 with 4 slots (warp-private copies), long sorted runs (runs merged
# in registers), ids beyond both ends, 9 columns (two launches), E past
# shared memory (global atomics); float32 and float64, positive values
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [
    "one_group", "e7_s4", "sorted_runs", "out_of_range", "s9",
    "global_atomics", "ragged"])
def test_groupby_sums_cols(cuda, case, dtype):
    n, n_entries, n_slots, pad = 3_000_000, 7, 4, 0
    if case == "one_group":
        n_entries = 1
    elif case == "sorted_runs":
        n_entries = 1000  # ~3000-row runs
    elif case == "out_of_range":
        pad = 5
    elif case == "s9":
        n_slots = 9
    elif case == "global_atomics":
        n_entries = 300_000
    elif case == "ragged":
        n = 1_000_004
    gen = torch.Generator(device=cuda).manual_seed(n + n_entries)
    gid = torch.randint(-pad, n_entries + pad, (n,), device=cuda,
                        generator=gen, dtype=torch.int32)
    if case == "sorted_runs":
        gid = torch.sort(gid).values
    cols = [torch.rand((n,), device=cuda, generator=gen, dtype=dtype) * 100
            for _ in range(n_slots)]
    if case == "ragged":
        # an odd row count, starting one row in: no 16-byte alignment
        gid, cols = gid[1:], [c[1:] for c in cols]
    before = hist.groupby_sums.launches
    got = hist.groupby_sums(gid, cols, n_entries)
    assert hist.groupby_sums.launches - before == (2 if n_slots > 8 else 1)
    want = hist.groupby_sums_ref(gid, cols, n_entries)
    torch.cuda.synchronize()
    assert got.shape == (n_entries, n_slots) and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)


# every mode K1's wrapper may pick: warp-private copies (2), one copy per
# block (1), global atomics (0); the last two match gids only where a run
# crosses lanes
@pytest.mark.parametrize("mode", [2, 1, 0])
@pytest.mark.parametrize("case", ["e7_s4", "sorted_runs", "out_of_range"])
def test_groupby_sums_cols_every_mode(cuda, monkeypatch, case, mode):
    n, n_entries, pad = 2_000_003, 7, 0
    if case == "sorted_runs":
        n_entries = 500
    elif case == "out_of_range":
        pad = 3
    gen = torch.Generator(device=cuda).manual_seed(mode)
    gid = torch.randint(-pad, n_entries + pad, (n,), device=cuda,
                        generator=gen, dtype=torch.int32)
    if case == "sorted_runs":
        gid = torch.sort(gid).values
    cols = [torch.rand((n,), device=cuda, generator=gen,
                       dtype=torch.float64) * 100 for _ in range(4)]
    monkeypatch.setattr(hist, "_k1_mode", lambda s, e: mode)
    got = hist.groupby_sums(gid, cols, n_entries)
    torch.testing.assert_close(got, hist.groupby_sums_ref(gid, cols,
                                                          n_entries),
                               rtol=1e-10, atol=0)


def test_scalar_subquery_on_the_card(cuda):
    """The binder reads the subquery's value from a CUDA tensor."""
    rng = np.random.default_rng(4)
    n = 100_000
    x = rng.integers(-10**6, 10**6, n)
    data = {"g": rng.integers(0, 40, n),
            "x": np.ma.MaskedArray(x, rng.random(n) < 0.1),
            "y": rng.gamma(3.0, 100.0, n)}
    sqls = ["SELECT COUNT(*), SUM(y) FROM t WHERE y > (SELECT AVG(y) FROM t)",
            "SELECT g, COUNT(*) FROM t WHERE x < (SELECT MAX(x) FROM t) "
            "GROUP BY g ORDER BY g",
            "SELECT COUNT(*) FROM t WHERE x > (SELECT MAX(x) FROM t "
            "WHERE g > 100)"]
    out = []
    for device in ("cpu", "cuda"):
        hdk = hdk_tpu_torch.HDK(device=device)
        hdk.import_pydict(data, name="t")
        out.append([hdk.sql(q).to_numpy() for q in sqls])
    for cpu, gpu in zip(*out):
        for name in cpu:
            if cpu[name].dtype.kind == "f":
                np.testing.assert_allclose(gpu[name], cpu[name], rtol=1e-9)
            else:
                assert np.array_equal(gpu[name], cpu[name]), name
    assert int(list(out[1][2].values())[0][0]) == 0  # MAX over no row: NULL


def test_sort_route_on_the_card(cuda, monkeypatch):
    rng = np.random.default_rng(8)
    n = 300_000
    data = {"k": rng.integers(0, 10**9, n) * 8,
            "g": rng.integers(0, 500, n),
            "x": np.ma.MaskedArray(rng.integers(-10**6, 10**6, n),
                                   rng.random(n) < 0.1),
            "y": np.round(rng.normal(50.0, 20.0, n) * 8) / 8}
    sqls = ["SELECT k, COUNT(*), SUM(x), AVG(y), STDDEV_SAMP(y), MIN(y) "
            "FROM t GROUP BY k ORDER BY k",
            "SELECT g, COUNT(DISTINCT x), SUM(DISTINCT x), MEDIAN(y), "
            "APPROX_COUNT_DISTINCT(x), APPROX_QUANTILE(y, 0.9) FROM t "
            "GROUP BY g ORDER BY g",
            "SELECT k, COUNT(*) AS c FROM t GROUP BY k ORDER BY c DESC "
            "LIMIT 50"]
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device)
        hdk.import_pydict(data, name="t")
        hist.reset_launches()
        out.append([hdk.sql(q).to_numpy() for q in sqls])
    assert all(v > 0 for v in hist.launches().values())
    for cpu, gpu in zip(*out):
        for name in cpu:
            if cpu[name].dtype.kind == "f":
                np.testing.assert_allclose(gpu[name], cpu[name], rtol=1e-9)
            else:
                assert np.array_equal(gpu[name], cpu[name]), name


# K2, K3 and K4 (csrc/int_hist.cu) in every mode the wrapper may pick: a copy
# per lane (2), per block (1, E split into ranges past shared memory) and
# global atomics (0); at E = 7 with 3 columns, sorted runs, ids beyond
# both ends, every row at the type's minimum over one entry (the 32-bit
# partials' row budget; every bool true), a misaligned odd-length view, 9
# columns (two launches), E = 70000 (ranges or global atomics) and sorted
# ids of ~2 rows an entry with ids beyond both ends (the sort route's
# buffers: many entries a warp step, runs across lanes).  Values span each
# type's range (int8 negatives; int64 sums that wrap).
_INT_CASES = [(c, m) for c in ("e7_s3", "sorted_runs", "out_of_range",
                               "extreme", "ragged", "s9")
              for m in (2, 1, 0)] + [(c, m) for c in ("split", "sorted_short")
                                     for m in (1, 0)]


@pytest.mark.parametrize("dtype", [None, torch.bool, torch.int8, torch.int16,
                                   torch.int32, torch.int64],
                         ids=["count", "bool", "i8", "i16", "i32", "i64"])
@pytest.mark.parametrize("case,mode", _INT_CASES)
def test_int_hist_every_mode(cuda, monkeypatch, case, mode, dtype):
    n, n_entries, pad, n_cols = 2_000_003, 7, 0, 3
    if case == "sorted_runs":
        n_entries, n_cols = 100, 1  # ~20000-row runs
    elif case == "out_of_range":
        pad = 3
    elif case == "extreme":
        n, n_entries, n_cols = 3_000_000, 1, 1
    elif case == "s9":
        n_cols = 9
    elif case == "split":
        n_entries, n_cols = 70_000, 1
    elif case == "sorted_short":
        n_entries, n_cols, pad = 1_000_000, 2, 50_000
    gen = torch.Generator(device=cuda).manual_seed(mode * 100 + len(case))
    gid = torch.randint(-pad, n_entries + pad, (n,), device=cuda,
                        generator=gen, dtype=torch.int32)
    if case in ("sorted_runs", "sorted_short"):
        gid = torch.sort(gid).values
    cols = []
    if dtype == torch.bool:
        for _ in range(n_cols):
            cols.append(torch.ones((n,), dtype=dtype, device=cuda)
                        if case == "extreme"
                        else torch.rand((n,), device=cuda, generator=gen) < 0.5)
    elif dtype is not None:
        lo, hi = ((-2**62, 2**62) if dtype == torch.int64
                  else (torch.iinfo(dtype).min, torch.iinfo(dtype).max))
        for _ in range(n_cols):
            cols.append(torch.full((n,), torch.iinfo(dtype).min, dtype=dtype,
                                   device=cuda) if case == "extreme"
                        else torch.randint(lo, hi, (n,), device=cuda,
                                           generator=gen, dtype=dtype))
    if case == "ragged":
        gid, cols = gid[1:], [c[1:] for c in cols]
    monkeypatch.setattr(hist, "_int_mode", lambda s, e, d=None: mode)
    before = hist.launches()
    if dtype is None:
        got = hist.count_hist(gid, n_entries)
        want = hist.count_hist_ref(gid, n_entries)
        launched = _int_launches(1, n_entries)
    elif dtype == torch.bool:
        got = hist.groupby_sums2(gid, cols, n_entries)
        want = hist.groupby_sums2_ref(gid, cols, n_entries)
        launched = _int_launches(n_cols, n_entries, dtype)
    else:
        got = hist.seg_sums_exact(gid, cols, n_entries)
        want = hist.seg_sums_exact_ref(gid, cols, n_entries)
        launched = _int_launches(n_cols, n_entries, dtype)
    torch.cuda.synchronize()
    name = {None: "count_hist", torch.bool: "groupby_sums2"}.get(
        dtype, "seg_sums_exact")
    assert hist.launches()[name] - before[name] == launched
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)


# K2 at the modes its own planner picks for two bool columns (the main
# path's layout): a copy per lane (E = 11), one block-shared copy (E =
# 1981) or three (E = 65536), global atomics (E = 300000); sorted ids
# with long runs and with ~2 rows an entry; a ragged row count, one
# column at an odd offset, and 9 columns (two launches)
@pytest.mark.parametrize("case,mode", [
    ("lane", 2), ("block", 1), ("block_3_ranges", 1), ("global", 0),
    ("sorted_runs", 1), ("sorted_short", 0), ("ragged", 1),
    ("misaligned", 1), ("s9", 1)])
def test_groupby_sums2_modes(cuda, case, mode):
    n, n_entries, n_cols = 4_000_000, 1981, 2
    n_entries = {"lane": 11, "block_3_ranges": 65536, "global": 300_000,
                 "sorted_runs": 100, "sorted_short": 2_000_000}.get(
                     case, n_entries)
    if case == "ragged":
        n = 4_000_037
    elif case == "s9":
        n_cols = 9
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    gid = torch.randint(-3, n_entries + 3, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    if case.startswith("sorted"):
        gid = torch.sort(gid).values
    cols = [torch.rand((n + 1,), device=cuda, generator=gen) < 0.7
            for _ in range(n_cols)]
    # a slice at offset 1 is misaligned: the wrapper copies it
    cols = [c[1:] if case == "misaligned" and i == 0 else c[:n]
            for i, c in enumerate(cols)]
    assert hist._int_mode(min(n_cols, 8), n_entries, torch.bool) == mode
    if case == "block_3_ranges":
        assert len(hist._int_ranges(mode, 2, n_entries, torch.bool)) == 3
    before = hist.groupby_sums2.launches
    got = hist.groupby_sums2(gid, cols, n_entries)
    want = hist.groupby_sums2_ref(gid, cols, n_entries)
    torch.cuda.synchronize()
    assert (hist.groupby_sums2.launches - before
            == _int_launches(n_cols, n_entries, torch.bool))
    assert got.dtype == torch.int64 and got.shape == (n_entries, n_cols)
    assert torch.equal(got, want)


def _same_results(queries, out, f32_rtol=1e-9):
    """Each query's CPU and CUDA results hold the same rows: integers
    equal, floats to rtol 1e-9, float32 to ``f32_rtol``."""
    for sql, cpu, gpu in zip(queries, *out):
        assert list(cpu) == list(gpu), sql
        for (cn, cv), (gn, gv) in zip(_rows(cpu), _rows(gpu)):
            assert np.array_equal(cn, gn), sql
            if cv.dtype.kind == "f":
                rtol = f32_rtol if cv.dtype == np.float32 else 1e-9
                np.testing.assert_allclose(gv, cv, rtol=rtol, err_msg=sql)
            else:
                assert np.array_equal(gv, cv), sql


def _rows(out):
    """(NULL flags, values) per column of a to_numpy result, rows in
    lexicographic order of both."""
    cols = []
    for name, v in out.items():
        null = np.ma.getmaskarray(v)
        data = np.where(null, 0, np.ma.getdata(v))
        cols.append((null, data))
    keys = [c for pair in cols for c in pair]
    order = np.lexsort(keys[::-1]) if keys and len(keys[0]) else []
    return [(n[order], d[order]) for n, d in cols]


def test_joins_on_the_card(cuda, monkeypatch):
    """The join routes (perfect, sorted-hash, loop), outer joins,
    subqueries and TPC-H Q3 on a CUDA session against a CPU session:
    the same rows and routes, no plain version on a CUDA tensor."""
    import chip_smoke as cs

    rng = np.random.default_rng(9)
    n = 200_000
    k = rng.integers(0, 30_000, n)
    tables = {
        "l": {"k": np.ma.MaskedArray(k, rng.random(n) < 0.05),
              "v": rng.gamma(2.0, 10.0, n), "g": rng.integers(0, 50, n)},
        "r": {"k": rng.permutation(40_000)[:25_000],
              "w": rng.integers(-100, 100, 25_000)},
        "d": {"k": rng.integers(0, 30_000, 20_000) * (1 << 30),
              "w": rng.integers(-100, 100, 20_000)},
        "s": {"y": rng.integers(0, 20, 300), "z": rng.integers(0, 9, 300)},
    }
    tables["l"]["kd"] = k * (1 << 30)
    q3 = dict(zip(("customer3", "orders3", "lineitem3"), cs.gen_tpch_q3(1e-3)))
    queries = [
        ("SELECT l.k, v, w FROM l JOIN r ON l.k = r.k WHERE v > 20", "perfect"),
        ("SELECT l.k, v, w FROM l LEFT JOIN r ON l.k = r.k", "perfect"),
        ("SELECT g, COUNT(*), SUM(w) FROM l JOIN r ON l.k = r.k "
         "GROUP BY g ORDER BY g", "perfect"),
        ("SELECT COUNT(*), SUM(v) FROM l WHERE k IN "
         "(SELECT k FROM r WHERE w > 0)", "perfect"),
        ("SELECT COUNT(*) FROM l WHERE NOT EXISTS "
         "(SELECT 1 FROM r WHERE r.k = l.k AND r.w > 50)", "perfect"),
        ("SELECT kd, v, w FROM l JOIN d ON l.kd = d.k", "hash"),
        ("SELECT kd, v, w FROM l LEFT JOIN d ON l.kd = d.k AND w > 0",
         "hash"),
        ("SELECT l.k, v, r.k AS rk, w FROM l FULL JOIN r ON l.k = r.k "
         "AND w > 90", "hash"),
        ("SELECT g, y, z FROM l, s WHERE v > 60 AND g < y AND z = 3", None),
        ("SELECT k FROM l WHERE g < 2 UNION ALL SELECT k FROM r "
         "WHERE w > 98", None),
        (cs.TPCH_Q3, "perfect"),
    ]
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device)
        for name, data in {**tables, **q3}.items():
            hdk.import_pydict(data, name=name,
                              schema=cs.q3_schema(hdk_tpu_torch.types, name))
        got = []
        for sql, route in queries:
            hdk._executor._join_route = None
            got.append(hdk.sql(sql).to_numpy())
            assert hdk._executor._join_route == route, sql
        out.append(got)
    _same_results([sql for sql, _ in queries], out)


def test_windows_and_arrays_on_the_card(cuda, monkeypatch):
    """chip_smoke.py phase 8 (W1-W4) at a small size on a CUDA session
    against a CPU session: the same rows, W3 through K1 and K4, an integer
    SUM OVER (PARTITION BY) through K3, no plain version on a CUDA
    tensor."""
    import chip_smoke as cs

    taxi = cs.gen_taxi(300_000)
    lineitem = cs.gen_tpch_q3(0.003)[2]
    values, alive = cs.gen_arrays(50_000)
    ts = {"pickup_datetime": hdk_tpu_torch.types.timestamp(
        hdk_tpu_torch.types.TimeUnit.SECOND, False)}

    def unnest_topk(hdk):
        ht = hdk.scan("trips")
        res = ht.agg("passenger_count",
                     ht["total_amount"].top_k(5).name("tk"),
                     ht["trip_distance"].bottom_k(5).name("bk")).run()
        return res.scan.unnest("tk").unnest("bk").run()

    def arrays(hdk):
        ha = hdk.scan("arrs")
        return ha.proj(n=ha["xs"].cardinality(), x1=ha["xs"].at(1)).run()

    # an integer SUM over each order's rows: K3 on the window path
    int_sum = ("SELECT l_orderkey, SUM(l_orderkey) OVER (PARTITION BY "
               "l_orderkey) AS s, COUNT(*) OVER (PARTITION BY l_orderkey) "
               "AS n FROM lineitem3")
    queries = [cs.W1, cs.W1_RANKS, cs.W2, cs.W3, int_sum, unnest_topk,
               arrays, lambda hdk: hdk.scan("arrs").unnest("xs").agg(
                   "xs", "count").run()]
    want = {cs.W3: cs.WINDOW_KERNELS,
            int_sum: ("seg_sums_exact", "count_hist")}
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device)
        hdk.import_pydict(dict(taxi), name="trips", schema=ts)
        hdk.import_pydict(lineitem, name="lineitem3",
                          schema=cs.q3_schema(hdk_tpu_torch.types,
                                              "lineitem3"))
        hdk.import_pydict({"xs": np.ma.MaskedArray(values, ~alive)},
                          name="arrs")
        got = []
        for q in queries:
            before = hist.launches()
            got.append((hdk.sql(q) if isinstance(q, str) else q(hdk))
                       .to_numpy())
            if device == "cuda" and q in want:
                used = {k: hist.launches()[k] - before[k] for k in before}
                assert all(used[k] > 0 for k in want[q]), (q, used)
        out.append(got)
    # FLOAT window sums are float64 sums rounded to float32 (the
    # tolerance of FLOAT outputs in tests/test_torch_window.py)
    _same_results([q if isinstance(q, str) else q.__name__
                   for q in queries], out, f32_rtol=1e-6)


def test_controls_on_the_card(cuda, monkeypatch):
    """chip_smoke.py phase 9 at a small size on a CUDA session against a
    CPU session: TPC-H Q1 and Q6 streamed in chunks (Q1 through K1, K3
    and K4), Q1 under a watchdog time limit, a month of time-ordered taxi
    rows over one fragment of three, taxi Q3 on the stats-bounded year,
    and a GROUP BY whose two routes are both timed: the same rows, no
    plain version on a CUDA tensor."""
    import chip_smoke as cs

    lineitem = cs.gen_lineitem(400_000)
    taxi = cs.gen_taxi(300_000)
    taxi["pickup_datetime"].sort()
    nulls = cs.gen_nulls(100_000)
    ts = hdk_tpu_torch.types.timestamp(hdk_tpu_torch.types.TimeUnit.SECOND,
                                       False)
    config = {"storage.fragment_size": 100_000,
              "exec.scan_stream_bytes": 35 * 150_000}

    def year_q3(hdk):
        ht = hdk.scan("trips_sorted")
        return ht.agg(["passenger_count",
                       ht["pickup_datetime"].extract("year").name("y")],
                      "count").run()

    queries = [cs.TPCH_Q1, cs.TPCH_Q6, cs.MONTH_Q, year_q3,
               cs.NULLS_GROUP_Q, cs.NULLS_GROUP_Q]
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device, **config)
        ex = hdk._executor
        hdk.import_pydict(lineitem, name="lineitem",
                          schema={"l_shipdate": ts})
        hdk.import_pydict(dict(taxi), name="trips_sorted",
                          schema={"pickup_datetime": ts})
        hdk.import_pydict(nulls, name="t")
        got = []
        for q in queries:
            before = hist.launches()
            got.append((hdk.sql(q) if isinstance(q, str) else q(hdk))
                       .to_numpy())
            used = {k: hist.launches()[k] - before[k] for k in before}
            if q == cs.TPCH_Q1:
                assert ex._frag_stream_chunks == 4
                if device == "cuda":
                    assert all(used[k] > 0 for k in cs.STREAM_KERNELS), used
            if q == cs.TPCH_Q6:
                assert ex._frag_stream_chunks == 2
            if q == cs.MONTH_Q:
                assert ex._frag_prune_stats == {"selected": 1, "total": 3}
        res = hdk.sql(cs.TPCH_Q1, watchdog_time_limit_ms=600_000)
        assert ex._frag_stream_chunks == 4
        got.append(res.to_numpy())
        with pytest.raises(hdk_tpu_torch.exec.scalar.ExecError,
                           match="watchdog"):
            hdk.sql(cs.TPCH_Q1, watchdog_time_limit_ms=1).block()
        sig = next(g for g, _ in ex._feedback._t)
        assert set(ex._feedback.measured(sig)) == {"perfect", "sort"}
        text = hdk.explain(cs.TPCH_Q1, analyze=True)
        assert text.splitlines()[0].endswith(", 6 rows]")
        out.append(got)
    _same_results(queries + ["watchdog"], out)


def test_facade_on_the_card(cuda, monkeypatch):
    """chip_smoke.py phase 10 at a small size on a CUDA session against a
    CPU session: S1's stream of taxi batches (through K1, K3 and K4), U1's
    UDF in taxi Q2's GROUP BY (K1 and K4) and P1's projection offloaded
    and read back: the same rows, no plain version on a CUDA tensor."""
    import chip_smoke as cs

    data = cs.gen_taxi(200_000)
    t = hdk_tpu_torch.types
    udf_q = ("SELECT passenger_count, AVG(fare_per_mile(total_amount, "
             "trip_distance)) AS fpm FROM trips GROUP BY passenger_count")
    out = []
    for device in ("cpu", "cuda"):
        if device == "cuda":
            _refuse_plain_versions(monkeypatch)
        hdk = hdk_tpu_torch.HDK(device=device)
        got = []
        before = hist.launches()
        st = hdk.create_stream(cs.STREAM_SCHEMA, ["passenger_count"],
                               cs.STREAM_AGGS)
        for b in range(4):
            st.push({c: data[c][b * 50_000:(b + 1) * 50_000]
                     for c in cs.STREAM_SCHEMA})
        got.append(st.finish().to_numpy())
        used = {k: hist.launches()[k] - before[k] for k in before}
        if device == "cuda":
            assert all(used[k] > 0 for k in cs.FACADE_STREAM_KERNELS), used
        hdk.register_udf(
            "fare_per_mile",
            lambda a, b: a.to(torch.float64)
            / torch.clamp(b.to(torch.float64), min=0.1),
            arg_types=[t.fp64(), t.fp64()], ret_type=t.fp64())
        ht = hdk.import_pydict(dict(data), name="trips")
        before = hist.launches()
        got.append(hdk.sql(udf_q).to_numpy())
        used = {k: hist.launches()[k] - before[k] for k in before}
        if device == "cuda":
            assert all(used[k] > 0 for k in cs.FACADE_UDF_KERNELS), used
        res = ht.proj(d=ht["trip_distance"].cast("fp64") + 1,
                      a=ht["total_amount"] * 2).run()
        res.offload()
        assert res._table is None
        got.append(res.to_numpy())
        out.append(got)
    _same_results(["stream", "udf", "spill"], out, f32_rtol=1e-6)


def test_offload_and_clear_free_device_memory(cuda):
    """``offload`` frees at least the result's bytes on the card and
    ``clear_device_mem`` the table columns' bytes; a stream leaves at
    most one batch's bytes behind; everything reads back equal."""
    import gc

    def allocated():
        gc.collect()
        return torch.cuda.memory_allocated()

    hdk = hdk_tpu_torch.HDK(device="cuda")
    rng = np.random.default_rng(3)
    k = rng.integers(0, 9, 2_000_000)
    v = rng.normal(size=2_000_000)
    ht = hdk.import_pydict({"k": k, "v": v}, name="mem_t")
    res = ht.proj(a=ht["k"] * 3, b=ht["v"] + 1).run().block()
    nbytes = res._nbytes()
    m0 = allocated()
    res.offload()
    assert m0 - allocated() >= nbytes
    out = res.to_numpy()
    assert np.array_equal(out["a"], k * 3)
    assert np.array_equal(out["b"], v + 1)
    del res, out
    col_bytes = sum(x.nbytes for c in hdk._schema.get("mem_t").columns
                    for pair in c._device.values() for x in pair
                    if x is not None)
    assert col_bytes >= k.nbytes + v.nbytes
    m0 = allocated()
    hdk.clear_device_mem()
    assert m0 - allocated() >= col_bytes
    m0 = allocated()
    st = hdk.create_stream({"k": "int64", "v": "fp64"}, ["k"],
                           ["count", "sum(v)"])
    for b in range(4):
        st.push({"k": k[b::4], "v": v[b::4]})
    fin = st.finish().to_numpy()
    assert fin["count"].sum() == len(k)
    assert allocated() - m0 <= (k.nbytes + v.nbytes) // 4


def test_dist_session_on_one_card(cuda, monkeypatch):
    """A 4-shard session on one card gives the single-device session's
    answers: a dense GROUP BY (K1 and K4 once per shard), a shuffled
    GROUP BY, a sort and a partitioned join, no plain version on a CUDA
    tensor."""
    rng = np.random.default_rng(21)
    n = 400_003  # not a multiple of 4: the scans pad
    tables = {
        "f": {"k": rng.integers(0, 60, n), "big": rng.integers(0, 10**9, n),
              "v": rng.normal(size=n), "j": rng.integers(0, 50_000, n)},
        "d": {"j": rng.permutation(60_000)[:40_000],
              "w": rng.integers(-100, 100, 40_000)},
    }
    queries = [
        ("SELECT k, COUNT(*), SUM(v), MIN(big) FROM f GROUP BY k",
         "dense_psum"),
        ("SELECT k, COUNT(DISTINCT big % 1000), MEDIAN(v) FROM f GROUP BY k",
         None),
        ("SELECT big, COUNT(*) FROM f GROUP BY big", "two_phase"),
        ("SELECT big, v FROM f ORDER BY v DESC, big", None),
        ("SELECT f.k, COUNT(*), SUM(w) FROM f JOIN d ON f.j = d.j "
         "GROUP BY f.k", "dense_psum"),
    ]
    out = []
    for dist in (False, True):
        cfg = ({"dist.enable": True, "dist.num_devices": 4,
                "dist.broadcast_join_threshold": 1000} if dist else {})
        if dist:
            _refuse_plain_versions(monkeypatch)
            hist.reset_launches()
        hdk = hdk_tpu_torch.HDK(device="cuda", **cfg)
        for name, data in tables.items():
            hdk.import_pydict(data, name=name)
        got = []
        for sql, route in queries:
            got.append(hdk.sql(sql).to_numpy())
            if dist:
                assert route is None or (
                    hdk._executor._dist_agg_route == route), sql
        if dist:
            mesh = hdk._executor._mesh
            assert [d.type for d in mesh.devices] == ["cuda"] * 4
            assert hdk._executor._dist_join_route == "partitioned"
            launched = hist.launches()
            assert launched["count_hist"] >= 4
            assert launched["groupby_sums"] >= 4
        out.append(got)
    _same_results([sql for sql, _ in queries], out)


def test_benchtime_synchronizes_every_shards_card(cuda, monkeypatch):
    """``benchtime`` on a 4-shard session: every card the shards live on
    is synchronized (all four, where the host has four cards), after
    the join's lazy columns are gathered."""
    from hdk_tpu_torch.utils import benchtime

    rng = np.random.default_rng(3)
    hdk = hdk_tpu_torch.HDK(device="cuda", **{
        "dist.enable": True, "dist.num_devices": 4})
    f = hdk.import_pydict({"k": rng.integers(0, 1000, 200_000),
                           "v": rng.normal(size=200_000)}, name="f")
    d = hdk.import_pydict({"k": np.arange(1000),
                           "w": rng.normal(size=1000)}, name="d")
    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: (synced.append(dev), real(dev)))
    mesh = hdk._executor._mesh
    for q in (lambda: f.agg("k", "count", "sum(v)").run(),
              lambda: f.join(d, "k", "k").run()):
        synced.clear()
        res = benchtime.sync(q())
        assert set(synced) == set(mesh.devices)
        assert type(res._table.columns) is list or all(
            list.__getitem__(res._table.columns, i) is not None
            for i in range(len(res._table.columns)))
    assert len(set(mesh.devices)) == min(4, torch.cuda.device_count())


def test_dist_cuda_session_without_a_card_raises(monkeypatch):
    """``device="cuda"`` with no card raises: a distributed session never
    builds a CPU mesh in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hdk_tpu_torch.HDK(device="cuda", **{"dist.enable": True,
                                            "dist.num_devices": 4})


def test_multi_host_session_on_one_card(cuda):
    """Two ranks of a multi-host session share the card, joined over
    gloo with operands staged through pinned host memory
    (tests/test_torch_multihost.py is the worker): the reference
    worker's checks, each even-split query on its route and equal to a
    one-process 4-shard session on the card, the reference shapes over a
    process-local table equal to one device, and K1 and K4 launched
    inside both ranks."""
    import test_torch_multihost as mh

    ranks = mh.run_ranks(device="cuda", timeout=900)
    one = hdk_tpu_torch.HDK(device="cuda", **mh.CONFIG)
    mh.load_global(one)
    single = hdk_tpu_torch.HDK(device="cuda")
    rt, inner = mh.shapes_data()
    single.import_pydict(rt, name="rt")
    single.import_pydict(inner, name="rt_inner")
    for r, got in enumerate(ranks):
        assert got["devices"] == ["cuda:0", "cuda:0"]
        assert got["mesh"] == [4, 2, 2 * r, 2]
        assert got["perfect"] == [[4, 4, 4, 4], [24, 28, 32, 36]]
        assert got["launches"]["count_hist"] > 0
        assert got["launches"]["groupby_sums"] > 0
        assert got["transport_stats"]["staged_bytes"] > 0
    for label, q, attr, route in mh.PARITY:
        want = mh.payload(one.sql(q))
        assert getattr(one._executor, attr) == route, label
        for got in ranks:
            assert got["parity"][label]["routes"][attr] == route, label
            mh.same(got["parity"][label]["result"], want, label,
                    ordered="ORDER BY" in q)
    for label, q in mh.E2E.items():
        want = mh.payload(one.sql(q))
        for got in ranks:
            mh.same(got["e2e"][label], want, label, ordered=True)
    for i, q in enumerate(mh.QUERIES):
        want = mh.payload(single.sql(q))
        for got in ranks:
            mh.same(got["shapes"][i], want, q)
