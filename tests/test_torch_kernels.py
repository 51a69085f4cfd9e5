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
    rng = np.random.default_rng(n_entries)
    gid = _gid(rng, 30_000, n_entries)
    vals = rng.random((30_000, n_slots)) < 0.7
    want = np.asarray(pallas_groupby.groupby_sums2(
        jnp.asarray(gid), jnp.asarray(vals, jnp.float32), n_entries,
        interpret=True))
    got = hist.groupby_sums2(torch.from_numpy(gid), torch.from_numpy(vals),
                             n_entries)
    assert got.dtype == torch.int64 and got.shape == (n_entries, n_slots)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


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
