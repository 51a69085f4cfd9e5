"""The histogram kernels' plain versions (hdk_tpu_torch/kernels/hist.py)
against the Pallas kernels they replace, run in interpret mode as
tests/test_pallas_hist.py and tests/test_pallas_kernel.py run them, and
against numpy over the port's wider domain; plus the device dispatch.
The CUDA kernels themselves are checked in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import hdk_tpu  # noqa: F401  (64-bit mode for the Pallas kernels)
import jax.numpy as jnp
from hdk_tpu.ops import pallas_groupby, pallas_hist, pallas_hist2

from hdk_tpu_torch.kernels import hist
from hdk_tpu_torch.ops import onehot


def _gid(rng, n_rows, n_entries):
    # rows outside [0, E) at both ends must drop out
    return rng.integers(-3, n_entries + 3, n_rows).astype(np.int32)


def _columns(vals):
    """K1's input: one contiguous 1-D tensor per column of ``vals``."""
    return [torch.from_numpy(np.ascontiguousarray(vals[:, s]))
            for s in range(vals.shape[1])]


# -- against the Pallas kernels, on their domain: exact for K2-K4 ---------

@pytest.mark.parametrize("n", [100, 1504, 2381])
def test_count_hist_matches_pallas(n):
    rng = np.random.default_rng(n)
    gid = _gid(rng, 30_000, n)
    want = np.asarray(pallas_hist2.count_hist(jnp.asarray(gid), n,
                                              interpret=True))
    got = hist.count_hist(torch.from_numpy(gid), n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_entries,n_slots", [(50, 1), (1000, 2),
                                               (4096, 4)])
def test_groupby_sums2_matches_pallas(n_entries, n_slots):
    """Both interfaces, an (N, S) tensor and a list of S 1-D columns,
    equal the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n_entries)
    gid = _gid(rng, 30_000, n_entries)
    vals = rng.random((30_000, n_slots)) < 0.7
    want = np.asarray(pallas_groupby.groupby_sums2(
        jnp.asarray(gid), jnp.asarray(vals, jnp.float32), n_entries,
        interpret=True)).astype(np.int64)
    g = torch.from_numpy(gid)
    got = hist.groupby_sums2(g, torch.from_numpy(vals), n_entries)
    assert got.dtype == torch.int64 and got.shape == (n_entries, n_slots)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        hist.groupby_sums2(g, _columns(vals), n_entries).numpy(), want)


@pytest.mark.parametrize("n_entries", [500, 3000])  # direct, factored
def test_seg_sums_exact_matches_pallas(n_entries):
    rng = np.random.default_rng(n_entries)
    gid = _gid(rng, 30_000, n_entries)
    slots = rng.integers(-255, 256, (30_000, 3)).astype(np.int16)
    want = np.asarray(pallas_hist.seg_sums_exact(
        jnp.asarray(gid), jnp.asarray(slots, jnp.float32), n_entries,
        interpret=True))
    got = hist.seg_sums_exact(torch.from_numpy(gid), torch.from_numpy(slots),
                              n_entries)
    assert got.dtype == torch.int64 and got.shape == (3, n_entries)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_groupby_sums_matches_pallas():
    rng = np.random.default_rng(11)
    n, e = 4096, 50
    gid = rng.integers(0, e, n).astype(np.int32)
    gid[::11] = e + 3  # dead rows
    vals = rng.normal(size=(n, 2)).astype(np.float32)
    want = np.asarray(pallas_groupby.groupby_sums(
        jnp.asarray(gid), jnp.asarray(vals), e, interpret=True))
    got = hist.groupby_sums(torch.from_numpy(gid), _columns(vals), e)
    assert got.dtype == torch.float64 and got.shape == (e, 2)
    # the JAX test's own tolerance: the TPU kernel accumulates in float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)


# -- against numpy over the port's wider domain ---------------------------

def _add_at(gid, vals, n, dtype):
    live = (gid >= 0) & (gid < n)
    out = np.zeros((n,) + vals.shape[1:], dtype)
    np.add.at(out, gid[live], vals[live].astype(dtype))
    return out


@pytest.mark.parametrize("n_entries", [1, 7, 5000, 70_000])
def test_wide_domain_against_numpy(n_entries):
    rng = np.random.default_rng(n_entries)
    n = 40_000
    gid = _gid(rng, n, n_entries)
    g = torch.from_numpy(gid)
    live = gid[(gid >= 0) & (gid < n_entries)]
    assert np.array_equal(hist.count_hist(g, n_entries).numpy(),
                          np.bincount(live, minlength=n_entries))
    flags = rng.random((n, 2)) < 0.5
    assert np.array_equal(
        hist.groupby_sums2(g, torch.from_numpy(flags), n_entries).numpy(),
        _add_at(gid, flags, n_entries, np.int64))
    # full-range int64: sums wrap like int64 addition
    big = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                       (n, 2), dtype=np.int64)
    with np.errstate(over="ignore"):
        want = _add_at(gid, big, n_entries, np.int64).T
    assert np.array_equal(
        hist.seg_sums_exact(g, torch.from_numpy(big), n_entries).numpy(),
        want)
    for dt in (np.int8, np.int32):
        small = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, (n, 1),
                             dtype=dt)
        assert np.array_equal(
            hist.seg_sums_exact(g, torch.from_numpy(small), n_entries).numpy(),
            _add_at(gid, small, n_entries, np.int64).T)
    for dt in (np.float32, np.float64):
        vals = rng.gamma(2.0, 10.0, (n, 3)).astype(dt)
        np.testing.assert_allclose(
            hist.groupby_sums(g, _columns(vals), n_entries).numpy(),
            _add_at(gid, vals, n_entries, np.float64), rtol=1e-12)


@pytest.mark.parametrize("n_entries", [500, 3000])  # direct, factored
def test_seg_sums_exact_columns_match_pallas(n_entries):
    """K3 takes its columns where they lie: a list of 1-D columns, or the
    columns of an (N, L) tensor as views (no copy), each at its own
    width; both equal the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n_entries + 1)
    gid = _gid(rng, 30_000, n_entries)
    slots = rng.integers(-255, 256, (30_000, 3)).astype(np.int16)
    want = np.asarray(pallas_hist.seg_sums_exact(
        jnp.asarray(gid), jnp.asarray(slots, jnp.float32), n_entries,
        interpret=True)).astype(np.int64)
    g = torch.from_numpy(gid)
    wide = torch.from_numpy(slots)
    views = hist._slot_columns("seg_sums_exact", g, wide, "int8..int64",
                               hist._INT_SUFFIX)
    assert [c.data_ptr() for c in views] == [
        wide.data_ptr() + 2 * s for s in range(3)]
    assert np.array_equal(hist.seg_sums_exact(g, views, n_entries).numpy(),
                          want)
    cols = [torch.from_numpy(slots[:, s].astype(np.int32)) for s in range(3)]
    got = hist.seg_sums_exact(g, cols, n_entries)
    assert got.dtype == torch.int64 and got.shape == (3, n_entries)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("slots,match", [
    ([], "at least one"),
    ([torch.zeros(8)], "int8..int64"),
    ([torch.zeros(8, dtype=torch.int8), torch.zeros(8, dtype=torch.int16)],
     "one dtype"),
    ([torch.zeros(7, dtype=torch.int64)], "does not match"),
    (torch.zeros((7, 2), dtype=torch.int64), "do not match"),
    (torch.zeros((8, 2), dtype=torch.bool), "int8..int64"),
], ids=["empty", "float", "mixed", "short", "2-D short", "bool"])
def test_seg_sums_exact_rejects_columns(slots, match):
    gid = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        hist.seg_sums_exact(gid, slots, 4)


# -- K2 takes bool columns where they lie ---------------------------------

@pytest.mark.parametrize("n_cols", [1, 2, 9])
def test_groupby_sums2_columns(n_cols):
    """A list of 1-D bool columns equals the (N, S) tensor and numpy, with
    gids beyond both ends; 9 columns take two chunks on the card, and a
    column at an odd offset is read as it lies."""
    rng = np.random.default_rng(n_cols)
    n, e = 20_000, 37
    gid = _gid(rng, n, e)
    flags = rng.random((n, n_cols)) < 0.6
    want = _add_at(gid, flags, e, np.int64)
    g = torch.from_numpy(gid)
    wide = torch.from_numpy(flags)
    assert np.array_equal(hist.groupby_sums2(g, wide, e).numpy(), want)
    cols = [wide[:, s] for s in range(n_cols)]
    got = hist.groupby_sums2(g, cols, e)
    assert got.dtype == torch.int64 and got.shape == (e, n_cols)
    assert np.array_equal(got.numpy(), want)
    shifted = torch.from_numpy(np.concatenate([[False], flags[:, 0]]))[1:]
    assert np.array_equal(hist.groupby_sums2(g, [shifted], e).numpy(),
                          want[:, :1])


@pytest.mark.parametrize("slots,match", [
    ([], "at least one"),
    ([torch.zeros(8, dtype=torch.int8)], "bool"),
    ([torch.zeros(8, dtype=torch.bool), torch.zeros(8, dtype=torch.uint8)],
     "one dtype"),
    ([torch.zeros(7, dtype=torch.bool)], "does not match"),
    ([torch.zeros((8, 1), dtype=torch.bool)], "does not match"),
    (torch.zeros((7, 2), dtype=torch.bool), "do not match"),
    (torch.zeros((8, 2)), "bool"),
], ids=["empty", "int8", "mixed", "short", "2-D", "2-D short", "float"])
def test_groupby_sums2_rejects_columns(slots, match):
    gid = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        hist.groupby_sums2(gid, slots, 4)


@pytest.mark.parametrize("n_cols,n_entries", [(2, 11), (2, 1001), (9, 7),
                                              (2, 65536), (1, 50_000_002)])
def test_groupby_sums2_launch_plan(monkeypatch, n_cols, n_entries):
    """K2 launches the integer kernel's bool entry point: up to 8 columns
    a launch, the mode and entry ranges of 4-byte partials, each launch
    writing from its first column's and entry's sum of the (S, E)
    output that it returns transposed."""
    gid = torch.zeros(64, dtype=torch.int32)
    cols = [torch.zeros(64, dtype=torch.bool) for _ in range(n_cols)]
    calls = _record_launches(monkeypatch)
    before = hist.groupby_sums2.launches
    out = hist.groupby_sums2(gid, cols, n_entries)
    assert out.shape == (n_entries, n_cols)
    plan = []
    for s0 in range(0, n_cols, 8):
        s = min(8, n_cols - s0)
        mode = hist._int_mode(s, n_entries, torch.bool)
        plan += [(s0, s, lo, hi, mode)
                 for lo, hi in hist._int_ranges(mode, s, n_entries,
                                                torch.bool)]
    assert all(name == "hdk_groupby_sums2_b8" for name, _ in calls)
    assert [(a[3], a[4], a[4] + a[5], a[8]) for _, a in calls] == [
        (s, lo, hi, mode) for _, s, lo, hi, mode in plan]
    assert [a[6] for _, a in calls] == [n_entries] * len(plan)
    base = out.t().data_ptr()
    assert [a[7] for _, a in calls] == [base + 8 * (s0 * n_entries + lo)
                                        for s0, _, lo, _, _ in plan]
    assert [a[1][:a[3]] for _, a in calls] == [
        [c.data_ptr() for c in cols[s0:s0 + s]] for s0, s, *_ in plan]
    assert hist.groupby_sums2.launches - before == len(plan)
    if (n_cols, n_entries) == (2, 65536):
        assert [p[4] for p in plan] == [1, 1, 1]  # 3 ranges, block-shared


def test_seg_sums_passes_bool_columns_unstacked(monkeypatch):
    rng = np.random.default_rng(4)
    n, e = 1000, 9
    gid = torch.from_numpy(_gid(rng, n, e))
    cols = [torch.from_numpy(rng.random(n) < 0.5),                    # bool
            torch.from_numpy(rng.integers(-9, 9, n)),                 # i64
            torch.from_numpy(rng.random(n) < 0.2)]                    # bool
    seen = []
    real = hist.groupby_sums2

    def spy(g, bool_cols, n_entries):
        seen.append(bool_cols)
        return real(g, bool_cols, n_entries)

    monkeypatch.setattr(hist, "groupby_sums2", spy)
    got = onehot.seg_sums(cols, gid, e)
    # one call, with a list of the caller's own tensors
    assert len(seen) == 1 and isinstance(seen[0], list)
    assert [id(c) for c in seen[0]] == [id(cols[0]), id(cols[2])]
    g = gid.numpy()
    for i in (0, 2):
        assert np.array_equal(
            got[i].numpy(), _add_at(g, cols[i].numpy()[:, None], e,
                                    np.int64)[:, 0])


# -- seg_sums hands K1 and K3 the caller's columns ----------------------------

def test_seg_sums_passes_int_columns_unstacked(monkeypatch):
    rng = np.random.default_rng(3)
    n, e = 1000, 9
    gid = torch.from_numpy(_gid(rng, n, e))
    cols = [torch.from_numpy(rng.integers(-9, 9, n)),                 # i64
            torch.from_numpy(rng.random(n) < 0.5),                    # bool
            torch.from_numpy(rng.integers(-100, 100, n).astype(np.int8)),
            torch.from_numpy(rng.integers(-2**40, 2**40, n)),         # i64
            torch.from_numpy(rng.random(n))]                          # f64
    seen = []
    real = hist.seg_sums_exact

    def spy(g, int_cols, n_entries):
        seen.append(int_cols)
        return real(g, int_cols, n_entries)

    monkeypatch.setattr(hist, "seg_sums_exact", spy)
    got = onehot.seg_sums(cols, gid, e)
    # one call per int dtype, each with a list of the caller's own tensors
    assert len(seen) == 2 and all(isinstance(c, list) for c in seen)
    by_dtype = {c[0].dtype: c for c in seen}
    assert [id(c) for c in by_dtype[torch.int64]] == [id(cols[0]),
                                                      id(cols[3])]
    assert [id(c) for c in by_dtype[torch.int8]] == [id(cols[2])]
    g = gid.numpy()
    for i in (0, 2, 3):
        assert np.array_equal(
            got[i].numpy(), _add_at(g, cols[i].numpy()[:, None], e,
                                    np.int64)[:, 0])


# -- what the wrappers launch on the card, read from their plan ------------

def _record_launches(monkeypatch):
    """Route CPU tensors down the kernel path and record each launch's
    entry point and arguments instead of calling the library."""
    calls = []
    monkeypatch.setattr(hist, "_route", lambda gid, *others: True)
    monkeypatch.setattr(hist, "_launch",
                        lambda name, gid, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("n_cols", [1, 8, 9, 17])
def test_seg_sums_exact_many_columns_take_several_launches(monkeypatch,
                                                           n_cols):
    gid = torch.zeros(64, dtype=torch.int32)
    cols = [torch.zeros(64, dtype=torch.int64) for _ in range(n_cols)]
    calls = _record_launches(monkeypatch)
    before = hist.seg_sums_exact.launches
    out = hist.seg_sums_exact(gid, cols, 5)
    chunks = [min(8, n_cols - s0) for s0 in range(0, n_cols, 8)]
    assert [a[3] for _, a in calls] == chunks  # columns a launch
    assert all(name == "hdk_seg_sums_exact_i64" for name, _ in calls)
    assert hist.seg_sums_exact.launches - before == len(chunks)
    # each launch writes from its first column's row of the (L, E) output
    row = out.stride(0) * out.element_size()
    assert [a[7] for _, a in calls] == [out.data_ptr() + row * s0
                                        for s0 in range(0, n_cols, 8)]


def test_int_ranges_split_block_shared_copies(monkeypatch):
    """E past one block-shared copy: one launch per range of entries, each
    writing from its first entry; the ranges cover E once."""
    n = 70_000  # 280 KB of 32-bit counters; 560 KB of int64 partials
    gid = torch.zeros(64, dtype=torch.int32)
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(hist, "_int_mode", lambda s, e, d=None: 1)
    out = hist.count_hist(gid, n)
    spans = [(a[2], a[2] + a[3]) for _, a in calls]
    assert spans == hist._int_ranges(1, 1, n) and len(spans) == 2
    assert [a[4] for _, a in calls] == [out.data_ptr() + 8 * lo
                                        for lo, _ in spans]
    calls.clear()
    hist.seg_sums_exact(gid, [torch.zeros(64, dtype=torch.int64)], n)
    spans = [(a[4], a[4] + a[5]) for _, a in calls]
    assert len(spans) == 3 and spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert max(hi - lo for lo, hi in spans) <= hist._int_span(1, torch.int64)


@pytest.mark.parametrize("name", [k.__name__ for k in hist.KERNELS])
def test_dense_keys_launch_args(monkeypatch, name):
    """A key source reaches every entry point as a DenseKeys struct in
    place of the gid pointer: each key's pointer, width, min, size and
    stride, the validity and row-mask pointers, E; a misaligned key is
    copied first; each launch counts under its wrapper's name."""
    n = 64
    keys = (torch.zeros(n + 1, dtype=torch.int16)[1:],  # misaligned view
            torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int64))
    valid = (None, torch.ones(n, dtype=torch.bool), None)
    rm = torch.ones(n, dtype=torch.bool)
    src = hist.DenseKeys(keys, valid, (-3, 0, 2009), (7, 3, 7), rm, n, "cpu")
    assert src.n_entries == 147 and src.strides() == [21, 7, 1]
    calls = _record_launches(monkeypatch)
    structs = []
    monkeypatch.setattr(hist, "_launch", lambda entry, gid, *args: (
        calls.append((entry, args)), structs.append(args[-1]._obj)))
    before = hist.launches()
    slots = {"count_hist": (), "groupby_sums2": ([rm],),
             "seg_sums_exact": ([keys[2]],),
             "groupby_sums": ([torch.zeros(n, dtype=torch.float64)],)}[name]
    getattr(hist, name)(src, *slots, 147)
    assert hist.launches()[name] - before[name] == len(calls) == 1
    (_entry, args), (c,) = calls[0], structs
    assert args[0] is None  # no gid array
    assert (c.n_keys, c.n_entries) == (3, 147)
    assert list(c.width)[:3] == [2, 1, 8]
    assert list(c.min)[:3] == [-3, 0, 2009]
    assert list(c.size)[:3] == [7, 3, 7]
    assert list(c.stride)[:3] == [21, 7, 1]
    assert c.key[0] % 16 == 0 and c.key[0] != keys[0].data_ptr()
    assert c.key[1:3] == [keys[1].data_ptr(), keys[2].data_ptr()]
    assert c.valid[0] is None and c.valid[1] == valid[1].data_ptr()
    assert c.row_mask == rm.data_ptr()


def test_dense_keys_the_kernels_do_not_take(monkeypatch):
    """Five keys or a key type the kernels do not read: the plain version
    still takes the source, a launch refuses it."""
    n = 16
    five = hist.DenseKeys((torch.zeros(n, dtype=torch.int8),) * 5,
                          (None,) * 5, (0,) * 5, (2,) * 5, None, n, "cpu")
    wide = hist.DenseKeys((torch.zeros(n, dtype=torch.uint8),), (None,),
                          (0,), (4,), None, n, "cpu")
    for src in (five, wide):
        assert not src.kernel_ready()
        assert int(hist.count_hist(src, src.n_entries).sum()) == n
    _record_launches(monkeypatch)
    with pytest.raises(ValueError, match="no kernel takes keys"):
        hist.count_hist(five, five.n_entries)
    with pytest.raises(ValueError, match="rows"):
        hist.DenseKeys((torch.zeros(n, dtype=torch.int8),), (None,), (0,),
                       (2,), torch.ones(n + 1, dtype=torch.bool), n, "cpu")


# -- seg_sums hands K1 the caller's columns ---------------------------------

def test_seg_sums_passes_float_columns_unstacked(monkeypatch):
    rng = np.random.default_rng(2)
    n, e = 1000, 9
    gid = torch.from_numpy(_gid(rng, n, e))
    cols = [torch.from_numpy(rng.random(n)),                  # f64
            torch.from_numpy(rng.random(n) < 0.5),            # bool
            torch.from_numpy(rng.random(n).astype(np.float32)),
            torch.from_numpy(rng.random(n)),                  # f64
            torch.from_numpy(rng.integers(0, 9, n))]          # int64
    seen = []
    real = hist.groupby_sums

    def spy(g, float_cols, n_entries):
        seen.append(list(float_cols))
        return real(g, float_cols, n_entries)

    monkeypatch.setattr(hist, "groupby_sums", spy)
    got = onehot.seg_sums(cols, gid, e)
    # one call per float dtype, each with the caller's own tensors
    by_dtype = {c[0].dtype: c for c in seen}
    assert len(seen) == 2
    assert [id(c) for c in by_dtype[torch.float64]] == [id(cols[0]),
                                                        id(cols[3])]
    assert [id(c) for c in by_dtype[torch.float32]] == [id(cols[2])]
    g = gid.numpy()
    for i in (0, 2, 3):
        np.testing.assert_allclose(
            got[i].numpy(),
            _add_at(g, cols[i].numpy()[:, None], e, np.float64)[:, 0],
            rtol=1e-12)


# -- dispatch ---------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    calls = []
    for k in hist.KERNELS:
        ref = getattr(hist, k.__name__ + "_ref")
        monkeypatch.setattr(hist, k.__name__ + "_ref",
                            lambda *a, _r=ref, _n=k.__name__: (
                                calls.append(_n), _r(*a))[1])
    hist.reset_launches()
    gid = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    ones = torch.ones((4, 1), dtype=torch.bool)
    hist.count_hist(gid, 3)
    hist.groupby_sums2(gid, ones, 3)
    hist.seg_sums_exact(gid, ones.to(torch.int64), 3)
    hist.groupby_sums(gid, [ones[:, 0].to(torch.float32)], 3)
    assert calls == [k.__name__ for k in hist.KERNELS]
    assert set(hist.launches().values()) == {0}


@pytest.mark.parametrize("name", [k.__name__ for k in hist.KERNELS])
def test_other_device_raises(name):
    gid = torch.zeros(8, dtype=torch.int32, device="meta")
    slots = {"count_hist": None,
             "groupby_sums2": torch.zeros((8, 1), dtype=torch.bool),
             "seg_sums_exact": torch.zeros((8, 1), dtype=torch.int64),
             "groupby_sums": torch.zeros((8, 1), dtype=torch.float64)}[name]
    if slots is None:
        args = (gid, 4)
    elif name == "groupby_sums":  # a list of columns
        args = (gid, [slots[:, 0].to("meta")], 4)
    else:
        args = (gid, slots.to("meta"), 4)
    with pytest.raises(ValueError, match="device"):
        getattr(hist, name)(*args)


def test_rejects_wrong_inputs():
    gid = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        hist.count_hist(gid, 4)
    gid = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="bool"):
        hist.groupby_sums2(gid, torch.zeros((8, 1), dtype=torch.int8), 4)
    with pytest.raises(ValueError, match="rows"):
        hist.groupby_sums(gid, [torch.zeros(7, dtype=torch.float32)], 4)


@pytest.mark.parametrize("cols,match", [
    ([], "at least one"),
    ([torch.zeros(8, dtype=torch.int32)], "float32/float64"),
    ([torch.zeros((8, 1))], "does not match"),
    ([torch.zeros(8), torch.zeros(8, dtype=torch.float64)], "one dtype"),
], ids=["empty", "int", "2-D", "mixed"])
def test_groupby_sums_rejects_columns(cols, match):
    gid = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        hist.groupby_sums(gid, cols, 4)


@pytest.mark.parametrize("n_cols", [1, 8, 9, 17])
def test_groupby_sums_many_columns(n_cols):
    """Column lists past one launch's 8 (two or three launches on the
    card), each column a view of its own: a strided one, one at an odd
    offset, and a float32 list."""
    rng = np.random.default_rng(n_cols)
    n, e = 5000, 13
    gid = _gid(rng, n, e)
    vals = rng.gamma(2.0, 10.0, (n, n_cols))
    want = _add_at(gid, vals, e, np.float64)
    g = torch.from_numpy(gid)
    wide = torch.from_numpy(vals)
    got = hist.groupby_sums(g, [wide[:, s] for s in range(n_cols)], e)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    shifted = torch.from_numpy(np.concatenate([[0.0], vals[:, 0]]))[1:]
    np.testing.assert_allclose(
        hist.groupby_sums(g, [shifted], e).numpy()[:, 0], want[:, 0],
        rtol=1e-12)
    f32 = [torch.from_numpy(np.ascontiguousarray(vals[:, s], np.float32))
           for s in range(n_cols)]
    np.testing.assert_allclose(
        hist.groupby_sums(g, f32, e).numpy(),
        _add_at(gid, vals.astype(np.float32), e, np.float64), rtol=1e-12)


@pytest.mark.parametrize("n_slots,n_entries,mode", [
    (4, 7, 2), (1, 10, 2), (8, 16, 2), (1, 17, 1), (1, 1001, 1),
    (4, 1981, 1), (1, 25_600, 1), (1, 25_601, 0), (4, 50_000_002, 0)])
def test_k1_mode(n_slots, n_entries, mode):
    """Warp-private copies up to 16 entries, one copy per block while it
    fits in 200 KB, global atomics beyond."""
    assert hist._k1_mode(n_slots, n_entries) == mode


@pytest.mark.parametrize("n_slots,n_entries,dtype,mode", [
    (2, 11, torch.bool, 2), (2, 32, torch.bool, 2), (2, 33, torch.bool, 1),
    (2, 1001, torch.bool, 1), (2, 65536, torch.bool, 1),
    (2, 76_800, torch.bool, 1), (2, 76_801, torch.bool, 0),
    (1, 7, None, 2), (1, 64, None, 2), (1, 65, None, 1), (1, 1981, None, 1),
    (1, 65536, None, 1), (1, 153_600, None, 1), (1, 153_601, None, 0),
    (1, 50_000_002, None, 0), (1, 7, torch.int8, 2), (1, 37, torch.int8, 2),
    (1, 1001, torch.int16, 1), (1, 64, torch.int64, 2),
    (1, 65, torch.int64, 1), (1, 65536, torch.int64, 1),
    (1, 76_800, torch.int64, 1), (1, 76_801, torch.int64, 0),
    (2, 32, torch.int64, 2), (2, 33, torch.int64, 1), (8, 8, torch.int32, 2),
    (8, 9, torch.int32, 1)])
def test_int_mode(n_slots, n_entries, dtype, mode):
    """A copy per lane up to 64 cells (S x E), one copy per block while E
    fits in 3 ranges of 200 KB (32-bit partials for counts, bool, int8,
    int16; 64-bit for int32, int64), global atomics beyond."""
    assert hist._int_mode(n_slots, n_entries, dtype) == mode


@pytest.mark.parametrize("n_entries,dtype,ranges", [
    (65536, torch.bool, 2),
    (1981, None, 1), (51_200, None, 1), (51_201, None, 2), (65536, None, 2),
    (65536, torch.int64, 3), (153_600, None, 3)])
def test_int_ranges(n_entries, dtype, ranges):
    got = hist._int_ranges(1, 1, n_entries, dtype)
    assert len(got) == ranges and got[0][0] == 0 and got[-1][1] == n_entries
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert max(hi - lo for lo, hi in got) <= hist._int_span(1, dtype)
    assert hist._int_ranges(0, 1, n_entries, dtype) == [(0, n_entries)]
