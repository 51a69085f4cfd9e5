"""The port's segment reductions and dense group-by against the JAX
package's, on the same numpy inputs: ``ops/onehot.seg_sums``/``seg_min``/
``seg_max``, ``perfect_gid``, ``groupby_perfect`` and ``nogroup_agg``.
Integer results are exact; float64 sums agree to 1e-12 relative (only the
summation order differs); float32 inputs to 1e-6 (the JAX package adds
float32 within blocks)."""

import numpy as np
import pytest
import torch

import hdk_tpu
import jax.numpy as jnp
from hdk_tpu.exec import groupby as jgb
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu.ops import onehot as jonehot

import hdk_tpu_torch
from hdk_tpu_torch.exec import groupby as tgb
from hdk_tpu_torch.exec.masked import from_numpy
from hdk_tpu_torch.ops import onehot as tonehot


def _jcol(data, mask=None):
    return JCol(jnp.asarray(data), None if mask is None else jnp.asarray(mask))


def _tcol(data, mask=None):
    return from_numpy(data, mask, "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, rtol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [3, 9, 700, 5000])
def test_seg_sums(n):
    rng = np.random.default_rng(n)
    rows = 20_000
    gid = rng.integers(0, n + 1, rows).astype(np.int32)  # n: discard
    cols = [np.ones(rows, np.bool_),
            rng.integers(-10**15, 10**15, rows),
            rng.random(rows) < 0.3,
            rng.integers(-100, 100, rows).astype(np.int8),
            rng.gamma(2.0, 5.0, rows).astype(np.float32),
            rng.gamma(2.0, 5.0, rows)]
    want = jonehot.seg_sums([jnp.asarray(c) for c in cols],
                            jnp.asarray(gid), n, ones_ids=[0])
    got = tonehot.seg_sums([torch.from_numpy(c) for c in cols],
                           torch.from_numpy(gid), n, ones_ids=[0])
    for i in range(4):
        assert got[i].dtype == torch.int64
        _same(got[i], want[i])
    _same(got[4], want[4], rtol=1e-6)
    _same(got[5], want[5], rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.int8, np.int64, np.float32,
                                   np.float64])
def test_seg_min_max(dtype):
    rng = np.random.default_rng(3)
    n, rows = 300, 10_000
    gid = rng.integers(0, n + 1, rows).astype(np.int32)
    vals = (rng.integers(-100, 100, rows) * 1.5).astype(dtype)
    for is_min in (True, False):
        ident_j = jgb._minmax_identity(jnp.dtype(dtype), is_min)
        ident_t = tgb._minmax_identity(torch.from_numpy(vals).dtype, is_min,
                                       "cpu")
        jf = jonehot.seg_min if is_min else jonehot.seg_max
        tf = tonehot.seg_min if is_min else tonehot.seg_max
        _same(tf(torch.from_numpy(vals), torch.from_numpy(gid), n, ident_t),
              jf(jnp.asarray(vals), jnp.asarray(gid), n, ident_j))


def _keys(rng, rows):
    a = rng.integers(-2, 5, rows)
    b = rng.integers(10, 14, rows).astype(np.int8)
    bmask = rng.random(rows) >= 0.2
    return [(a, None), (b, bmask)]


def _layouts(keys):
    ranges = [(int(d.min()), int(d.max()), m is not None) for d, m in keys]
    types_j = [hdk_tpu.types.int64(False), hdk_tpu.types.int8(True)]
    types_t = [hdk_tpu_torch.types.int64(False), hdk_tpu_torch.types.int8(True)]
    return (jgb.choose_perfect_layout(types_j, ranges, 1 << 20),
            tgb.choose_perfect_layout(types_t, ranges, 1 << 20))


def test_perfect_gid():
    rng = np.random.default_rng(1)
    rows = 5000
    keys = _keys(rng, rows)
    rm = rng.random(rows) < 0.8
    lj, lt = _layouts(keys)
    assert (lj.mins, lj.sizes) == (lt.mins, lt.sizes)
    gj, inj = jgb.perfect_gid([_jcol(d, m) for d, m in keys], lj,
                              jnp.asarray(rm))
    gt, intt = tgb.perfect_gid([_tcol(d, m) for d, m in keys], lt,
                               torch.from_numpy(rm))
    assert gt.dtype == torch.int32
    _same(gt, gj)
    _same(intt, inj)


def _specs(mod, gbmod, col, x, y):
    t = mod.types
    k = mod.ir.expr.AggKind
    cx, cy = col(*x), col(*y)
    return [
        gbmod.AggSpec(k.COUNT, None, t.int64(False)),
        gbmod.AggSpec(k.COUNT, cx, t.int64(False)),
        gbmod.AggSpec(k.SUM, cx, t.int64(True)),
        gbmod.AggSpec(k.AVG, cy, t.fp64(True)),
        gbmod.AggSpec(k.MIN, cx, t.int64(True)),
        gbmod.AggSpec(k.MAX, cy, t.fp64(True)),
        gbmod.AggSpec(k.VAR_SAMP, cy, t.fp64(True)),
        gbmod.AggSpec(k.STDDEV_SAMP, cx, t.fp64(True)),
        gbmod.AggSpec(k.CORR, cx, t.fp64(True), operand2=cy),
        gbmod.AggSpec(k.SUM, cy, t.fp32(True)),
    ]


def _inputs(rng, rows):
    x = (rng.integers(-10**9, 10**9, rows), rng.random(rows) >= 0.1)
    y = (rng.gamma(2.0, 5.0, rows), rng.random(rows) >= 0.1)
    return x, y


def _same_cols(got, want, exact_upto):
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.mask is None) == (w.mask is None), i
        if g.mask is not None:
            _same(g.mask, w.mask)
            live = _np(g.mask)
        else:
            live = np.ones(_np(g.data).shape, bool)
        gd, wd = _np(g.data)[live], _np(w.data)[live]
        assert gd.dtype == wd.dtype, (i, gd.dtype, wd.dtype)
        _same(gd, wd, rtol=0.0 if i < exact_upto else 1e-9)


def test_groupby_perfect():
    rng = np.random.default_rng(2)
    rows = 8000
    keys = _keys(rng, rows)
    x, y = _inputs(rng, rows)
    rm = rng.random(rows) < 0.9
    lj, lt = _layouts(keys)
    kj, aj, ej = jgb.groupby_perfect(
        [_jcol(d, m) for d, m in keys], lj,
        _specs(hdk_tpu, jgb, _jcol, x, y), jnp.asarray(rm))
    kt, at, et = tgb.groupby_perfect(
        [_tcol(d, m) for d, m in keys], lt,
        _specs(hdk_tpu_torch, tgb, _tcol, x, y), torch.from_numpy(rm))
    _same(et, ej)
    _same_cols(kt, kj, exact_upto=len(kt))
    # COUNT, COUNT(x), SUM(x), then float aggregates; MIN(x) is exact too
    _same_cols(at[:3], aj[:3], exact_upto=3)
    _same_cols(at[4:5], aj[4:5], exact_upto=1)
    _same_cols(at[3:4] + at[5:], aj[3:4] + aj[5:], exact_upto=0)


@pytest.mark.parametrize("masked", [False, True])
def test_nogroup_agg(masked):
    rng = np.random.default_rng(4)
    rows = 6000
    x, y = _inputs(rng, rows)
    rm = (rng.random(rows) < 0.5) if masked else None
    oj = jgb.nogroup_agg(_specs(hdk_tpu, jgb, _jcol, x, y), rows,
                         None if rm is None else jnp.asarray(rm))
    ot = tgb.nogroup_agg(_specs(hdk_tpu_torch, tgb, _tcol, x, y), rows,
                         None if rm is None else torch.from_numpy(rm), "cpu")
    _same_cols(ot[:3], oj[:3], exact_upto=3)
    _same_cols(ot[4:5], oj[4:5], exact_upto=1)
    _same_cols(ot[3:4] + ot[5:], oj[3:4] + oj[5:], exact_upto=0)


def test_unported_aggregates_raise():
    col = _tcol(np.arange(10))
    k = hdk_tpu_torch.ir.expr.AggKind
    spec = tgb.AggSpec(k.COUNT_DISTINCT, col, hdk_tpu_torch.types.int64(False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgb.nogroup_agg([spec], 10, None, "cpu")
