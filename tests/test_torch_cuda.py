"""The CUDA kernels on the card: each against its plain version, in both
the shared-memory and the global-atomic mode and over the sorted group
ids of the sort-based group-by, K1 at the shapes its design treats
apart, and the main path, the sort route and scalar subqueries on a CUDA
session against the same session on the CPU.  Skips where there
is no card.  On the card, without jax:

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
        "count_hist": 1, "groupby_sums2": 1, "seg_sums_exact": 2,
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
        "count_hist": 1, "groupby_sums2": 1, "seg_sums_exact": 2,
        "groupby_sums": 1}
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
