"""The port's sketches (hdk_tpu_torch/ops/sketches.py) against the JAX
package's (hdk_tpu/ops/sketches.py) on the same numpy inputs.

Tolerances: the bit helpers, HLL registers and HLL estimates are exact
(integers); t-digest weights exact (counts); t-digest means and
quantiles rtol 1e-9 (float64 sums in another order)."""

import numpy as np
import pytest
import torch

import hdk_tpu  # noqa: F401  (64-bit mode)
import jax.numpy as jnp
from hdk_tpu.ops import sketches as jsk

from hdk_tpu_torch.ops import sketches as tsk

I64 = np.iinfo(np.int64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ints(rng, n):
    """int64 values over the whole range, the extremes included."""
    v = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    v[:4] = [I64.min, I64.max, 0, -1]
    return v


def test_bit_helpers_match():
    v = _ints(np.random.default_rng(0), 20_000)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    for k in (4, 11, 14, 27, 30, 31, 60):
        assert np.array_equal(_np(tsk._lsr(tv, k)), _np(jsk._lsr(jv, k)))
    assert np.array_equal(_np(tsk._mix64(tv)), _np(jsk._mix64(jv)))
    w = np.abs(v[v != I64.min])
    assert np.array_equal(_np(tsk._bitlen(torch.from_numpy(w))),
                          _np(jsk._bitlen(jnp.asarray(w))))


@pytest.mark.parametrize("n_groups,p_cfg,budget", [
    (1, 11, 1 << 24), (500, 14, 1 << 24), (70_000, 11, 1 << 24),
    (3, 30, 1 << 10), (10**9, 11, 1 << 24)])
def test_effective_sizes_match(n_groups, p_cfg, budget):
    assert (tsk.effective_hll_p(p_cfg, n_groups, budget)
            == jsk.effective_hll_p(p_cfg, n_groups, budget))
    assert (tsk.effective_td_c(300, n_groups, budget >> 3)
            == jsk.effective_td_c(300, n_groups, budget >> 3))


def _values(rng, n, dtype):
    if dtype == "int64":
        return _ints(rng, n)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if dtype == "bool":
        return rng.random(n) < 0.5
    v = rng.normal(0, 1e3, n).astype(dtype)
    v[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    return v


@pytest.mark.parametrize("p", [4, 11, 14])
@pytest.mark.parametrize("dtype", ["int64", "int32", "float64", "float32",
                                   "bool"])
def test_hll_registers_and_estimates_match(dtype, p):
    rng = np.random.default_rng(p)
    rows, n = 30_000, 40
    # group sizes from a few rows to thousands; gid n: dead rows
    gid = np.minimum(rng.geometric(0.15, rows) - 1, n).astype(np.int32)
    data = _values(rng, rows, dtype)
    valid = rng.random(rows) >= 0.1
    want = jsk.hll_registers(jnp.asarray(data), jnp.asarray(valid),
                             jnp.asarray(gid), n, p)
    got = tsk.hll_registers(torch.from_numpy(data), torch.from_numpy(valid),
                            torch.from_numpy(gid), n, p)
    assert got.dtype == torch.int8 and got.shape == (n, 1 << p)
    assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(_np(tsk.hll_estimate(got)),
                          _np(jsk.hll_estimate(want)))


def _digest_inputs(seed, rows=20_000, n=60):
    rng = np.random.default_rng(seed)
    gid = np.minimum(rng.geometric(0.05, rows) - 1, n).astype(np.int32)
    data = rng.gamma(2.0, 30.0, rows)
    data[rng.random(rows) < 0.2] = 7.25  # ties
    valid = rng.random(rows) >= 0.1
    return gid, data, valid, n


@pytest.mark.parametrize("c", [8, 37, 300])
def test_tdigest_build_and_quantile_match(c):
    gid, data, valid, n = _digest_inputs(c)
    jm, jw = jsk.tdigest_build(jnp.asarray(data), jnp.asarray(valid),
                               jnp.asarray(gid), n, c)
    tm, tw = tsk.tdigest_build(torch.from_numpy(data),
                               torch.from_numpy(valid),
                               torch.from_numpy(gid), n, c)
    assert tm.shape == (n, c) and tw.dtype == torch.float64
    assert np.array_equal(_np(tw), _np(jw))
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-9, atol=0)
    for q in (0.0, 0.01, 0.5, 0.9, 1.0):
        np.testing.assert_allclose(
            _np(tsk.tdigest_quantile(tm, tw, q)),
            _np(jsk.tdigest_quantile(jm, jw, q)), rtol=1e-9, atol=0)


def test_tdigest_without_mask_and_empty_groups():
    gid, data, _valid, n = _digest_inputs(5, rows=3000, n=200)
    jm, jw = jsk.tdigest_build(jnp.asarray(data), None, jnp.asarray(gid),
                               n, 16)
    tm, tw = tsk.tdigest_build(torch.from_numpy(data), None,
                               torch.from_numpy(gid), n, 16)
    assert np.array_equal(_np(tw), _np(jw))
    assert (_np(tw).sum(axis=1) == 0).any()  # some groups are empty
    np.testing.assert_allclose(_np(tsk.tdigest_quantile(tm, tw, 0.3)),
                               _np(jsk.tdigest_quantile(jm, jw, 0.3)),
                               rtol=1e-9, atol=0)
