"""The port's join building blocks (hdk_tpu_torch/exec/join.py) against
the JAX package's (hdk_tpu/exec/join.py), function by function, on the
same seeded keys with duplicates, NULLs and filter-dead rows: the hashes
are equal bit for bit, the hash tables and probe ranges equal, the
candidate and verified pair sets equal; the perfect tables agree on
uniqueness and occupancy (which duplicate wins a scatter is unspecified
on both platforms) and, where the build keys are unique, slot by slot.
Also the executor's build-table caches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdk_tpu.exec import join as jj
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu_torch.exec import join as tj
from hdk_tpu_torch.exec.masked import MaskedCol as TCol

from torch_twin import assert_same, twin_sessions


def _cols(data, mask):
    """The same key column in each package."""
    return (JCol(jnp.asarray(data), None if mask is None
                 else jnp.asarray(mask)),
            TCol(torch.from_numpy(np.ascontiguousarray(data)),
                 None if mask is None else torch.from_numpy(mask)))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _keys(rng, n, kind, null_frac=0.15):
    """(data, mask or None): int64/int32 with duplicates, float64 with
    -0.0 and NaN, float32, bool."""
    if kind == "int64":
        data = rng.integers(-40, 40, n).astype(np.int64)
    elif kind == "int32":
        data = rng.integers(0, 25, n).astype(np.int32)
    elif kind == "float64":
        data = rng.integers(-6, 6, n).astype(np.float64) / 2
        data[rng.random(n) < 0.1] = -0.0
        data[rng.random(n) < 0.05] = np.nan
    elif kind == "float32":
        data = (rng.integers(-6, 6, n) / 4).astype(np.float32)
    else:
        data = rng.random(n) < 0.5
    mask = rng.random(n) >= null_frac if null_frac else None
    return data, mask


KINDS = ["int64", "int32", "float64", "float32", "bool"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nullable", [False, True])
def test_hash_keys(kind, nullable):
    rng = np.random.default_rng(51)
    data, mask = _keys(rng, 500, kind, 0.2 if nullable else 0)
    jc, tc = _cols(data, mask)
    for jn_null, tn_null in ((jj._BUILD_NULL, tj._BUILD_NULL),
                             (jj._PROBE_NULL, tj._PROBE_NULL)):
        assert int(jn_null) == tn_null
        assert np.array_equal(_np(jj.hash_keys([jc], jn_null)),
                              _np(tj.hash_keys([tc], tn_null)))


def test_hash_keys_multi_column():
    rng = np.random.default_rng(52)
    cols = [_cols(*_keys(rng, 400, kind)) for kind in ("int64", "float64")]
    want = jj.hash_keys([c[0] for c in cols], jj._BUILD_NULL)
    got = tj.hash_keys([c[1] for c in cols], tj._BUILD_NULL)
    assert np.array_equal(_np(want), _np(got))


def _tables(rng, kind, n_build=300, n_probe=700):
    """(build, probe) key columns of both packages."""
    bj, bt = _cols(*_keys(rng, n_build, kind))
    pj, pt = _cols(*_keys(rng, n_probe, kind))
    return bj, bt, pj, pt


def _pairs(l_idx, r_idx, ok=None):
    l, r = _np(l_idx).astype(np.int64), _np(r_idx).astype(np.int64)
    if ok is not None:
        keep = _np(ok).astype(bool)
        l, r = l[keep], r[keep]
    return sorted(zip(l.tolist(), r.tolist()))


@pytest.mark.parametrize("kind", KINDS)
def test_build_probe_expand_verify(kind):
    rng = np.random.default_rng(53)
    bj, bt, pj, pt = _tables(rng, kind)
    tab_j, tab_t = jj.build([bj]), tj.build([bt])
    assert np.array_equal(_np(tab_j.perm), _np(tab_t.perm))
    assert np.array_equal(_np(tab_j.sorted_hash), _np(tab_t.sorted_hash))
    lo_j, hi_j = jj.probe_ranges(tab_j, [pj])
    lo_t, hi_t = tj.probe_ranges(tab_t, [pt])
    assert np.array_equal(_np(lo_j), _np(lo_t))
    assert np.array_equal(_np(hi_j), _np(hi_t))
    total = int(_np(hi_t - lo_t).sum())
    lj, rj = jj.expand_pairs(tab_j, lo_j, hi_j, total)
    lt, rt = tj.expand_pairs(tab_t, lo_t, hi_t, total)
    assert _pairs(lj, rj) == _pairs(lt, rt)
    ok_j = jj.verify_pairs([bj], [pj], lj, rj)
    ok_t = tj.verify_pairs([bt], [pt], lt, rt)
    assert _pairs(lj, rj, ok_j) == _pairs(lt, rt, ok_t)
    # the verified pairs are exactly the equal, non-NULL key pairs
    pk, pm = _np(pt.data), _np(pt.mask)
    bk, bm = _np(bt.data), _np(bt.mask)
    eq = (pk[:, None] == bk[None, :]) & pm[:, None] & bm[None, :]
    assert _pairs(lt, rt, ok_t) == sorted(
        zip(*[a.tolist() for a in np.nonzero(eq)]))


def test_verify_drops_every_false_candidate(monkeypatch):
    """With every key hashed to one value, each probe row's candidates
    are all build rows; verification keeps only the true matches."""
    rng = np.random.default_rng(54)
    _, bt, _, pt = _tables(rng, "int64", 60, 90)
    monkeypatch.setattr(tj, "hash_keys",
                        lambda cols, null: torch.zeros(
                            cols[0].data.shape, dtype=torch.int64))
    tab = tj.build([bt])
    lo, hi = tj.probe_ranges(tab, [pt])
    total = int((hi - lo).sum())
    assert total == 60 * 90
    l_idx, r_idx = tj.expand_pairs(tab, lo, hi, total)
    ok = tj.verify_pairs([bt], [pt], l_idx, r_idx)
    pk, pm = _np(pt.data), _np(pt.mask)
    bk, bm = _np(bt.data), _np(bt.mask)
    eq = (pk[:, None] == bk[None, :]) & pm[:, None] & bm[None, :]
    assert _pairs(l_idx, r_idx, ok) == sorted(
        zip(*[a.tolist() for a in np.nonzero(eq)]))


def test_hash_route_with_colliding_hashes(monkeypatch):
    """A hash join through the executor with every hash colliding equals
    the JAX package's join (INNER, LEFT, SEMI, ANTI)."""
    rng = np.random.default_rng(55)
    l_k = rng.integers(0, 30, 200).tolist()
    l_k[::7] = [None] * len(l_k[::7])
    tables = {"l": {"k": l_k, "v": rng.normal(size=200)},
              "r": {"k": rng.integers(0, 40, 80), "w": rng.normal(size=80)}}
    jx, pt = twin_sessions(tables)
    monkeypatch.setattr(tj, "hash_keys",
                        lambda cols, null: torch.zeros(
                            cols[0].data.shape, dtype=torch.int64))
    for how in ("inner", "left", "semi", "anti"):
        want = jx.scan("l").join(jx.scan("r"), "k", "k", how=how).run()
        got = pt.scan("l").join(pt.scan("r"), "k", "k", how=how).run()
        assert pt._executor._join_route == "hash"
        assert_same(want, got, ordered=False)


def _perfect_inputs(rng, unique, masked):
    n = 200
    data = (rng.permutation(400)[:n] if unique
            else rng.integers(0, 150, n)).astype(np.int64) + 1000
    mask = rng.random(n) >= 0.2 if masked else None
    return data, mask


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_build_perfect(unique, masked):
    rng = np.random.default_rng(56)
    data, mask = _perfect_inputs(rng, unique, masked)
    jc, tc = _cols(data, mask)
    # a range that cuts off the top keys: out-of-range rows drop out
    lo, size = 1000, 350
    tab_j, uq_j, ns_j = jj.build_perfect(jc, min_key=lo, range_size=size)
    tab_t, uq_t, ns_t, slots_t = tj.build_perfect(tc, min_key=lo,
                                                  range_size=size)
    assert bool(uq_j) == bool(uq_t)
    assert int(ns_j) == int(ns_t)
    assert np.array_equal(_np(jj.build_slots(jc, lo, size)),
                          _np(tj.build_slots(tc, lo, size)))
    assert np.array_equal(_np(slots_t), _np(tj.build_slots(tc, lo, size)))
    occupied_j, occupied_t = _np(tab_j.rows) >= 0, _np(tab_t.rows) >= 0
    assert np.array_equal(occupied_j, occupied_t)
    if unique:
        assert np.array_equal(_np(tab_j.rows), _np(tab_t.rows))
    pdata = rng.integers(900, 1500, 600).astype(np.int64)
    pj, pt = _cols(pdata, rng.random(600) >= 0.1)
    for complete in (False, True):
        sj, mj = jj.perfect_match(tab_j, pj, range_size=size,
                                  complete=complete)
        st, mt = tj.perfect_match(tab_t, pt, range_size=size,
                                  complete=complete)
        assert np.array_equal(_np(sj), _np(st))
        assert np.array_equal(_np(mj), _np(mt))
    sj, ij = jj.perfect_slots(pj, lo, size)
    st, it = tj.perfect_slots(pt, lo, size)
    assert np.array_equal(_np(sj), _np(st))
    assert np.array_equal(_np(ij), _np(it))
    if unique:  # the build row of each probe row, read from the table
        st, mt = tj.perfect_match(tab_t, pt, range_size=size, complete=False)
        rows_t = torch.where(mt, tab_t.rows[st], -1)
        assert np.array_equal(_np(jj.probe_perfect(tab_j, pj, size)),
                              _np(rows_t))


# the executor's build-table caches (the cases of
# tests/test_advice_fixes.py on the JAX package's identity cache)

def test_identity_cache_rejects_reused_ids():
    import gc

    from hdk_tpu_torch.exec.common import _IdentityKeyedCache

    cache = _IdentityKeyedCache(8)
    a = torch.arange(4)
    cache.put("sig", [a], "value-for-a")
    assert cache.get("sig", [a]) == "value-for-a"
    # CPython reuses ids: a dies, and a new tensor takes its id
    b = torch.arange(8)
    ent = cache._d.pop(("sig", (id(a),)))
    cache._d[("sig", (id(b),))] = ent  # a stale weakref to a
    del a
    gc.collect()
    assert cache.get("sig", [b]) is None, "a stale entry must miss"


def test_identity_cache_none_members():
    from hdk_tpu_torch.exec.common import _IdentityKeyedCache

    cache = _IdentityKeyedCache(8)
    a = torch.arange(4)
    cache.put("s", [a, None], 42)
    assert cache.get("s", [a, None]) == 42


def test_caches_count_tensor_bytes():
    """Both caches size a value by its tensors' bytes; the plan-keyed one
    evicts its oldest entries past the byte budget."""
    from hdk_tpu_torch.exec.common import (_IdentityKeyedCache,
                                           _PlanArtifactCache)

    tab = tj.build([TCol(torch.arange(1000))])
    nbytes = tab.perm.nbytes + tab.sorted_hash.nbytes
    ident = _IdentityKeyedCache(8)
    ident.put("s", [tab.perm], tab)
    assert ident._bytes == nbytes
    plan = _PlanArtifactCache(limit=8, byte_budget=2 * nbytes)
    for i in range(3):
        plan.put(("bp", i), (tab, None, 7))
    assert plan.get(("bp", 0)) is None  # evicted: 3 tables exceed 2
    assert plan.get(("bp", 2))[0] is tab
    assert plan._bytes == 2 * nbytes
