"""The port's multi-device building blocks (hdk_tpu_torch/parallel/*,
``exec/join.expand_pairs_capped``, ``ops/sketches.tdigest_merge_*``)
against the JAX package's on the same numpy inputs: an 8-shard CPU mesh
against JAX's 8 virtual CPU devices (tests/conftest.py).

Tolerances: hashes, destinations, send buffers, overflow counts, group
keys, counts and integer aggregates exact, and every output buffer
position for position (the shuffle places each row where the JAX
package's does); float64 aggregates and t-digest means rtol 1e-9."""

import numpy as np
import pytest
import torch

import hdk_tpu  # noqa: F401  (64-bit mode)
import jax
import jax.numpy as jnp
from hdk_tpu import types as jt
from hdk_tpu.exec import groupby as jgb
from hdk_tpu.exec import join as jjoin
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu.ir.expr import AggKind as JKind
from hdk_tpu.ops import sketches as jsk
from hdk_tpu.parallel import dist_groupby as jdg
from hdk_tpu.parallel import mesh as jmesh
from hdk_tpu.parallel import shuffle as jshf
from hdk_tpu.parallel.dist_sort import dist_sort as jdist_sort

from hdk_tpu_torch import types as tt
from hdk_tpu_torch.exec import groupby as tgb
from hdk_tpu_torch.exec import join as tjoin
from hdk_tpu_torch.exec.masked import MaskedCol as TCol
from hdk_tpu_torch.ir.expr import AggKind as TKind
from hdk_tpu_torch.ops import sketches as tsk
from hdk_tpu_torch.parallel import dist_groupby as tdg
from hdk_tpu_torch.parallel import mesh as tmesh
from hdk_tpu_torch.parallel import shuffle as tshf
from hdk_tpu_torch.parallel.dist_sort import dist_sort as tdist_sort

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

P = 8
RTOL = 1e-9


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(P), tmesh.make_mesh(P, torch.device("cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cols(data, mask=None):
    """(JAX column, port column) of one numpy column."""
    return (JCol(jnp.asarray(data),
                 None if mask is None else jnp.asarray(mask)),
            TCol(torch.from_numpy(np.ascontiguousarray(data)),
                 None if mask is None else torch.from_numpy(mask)))


# -- shuffle ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int64", "int32", "float64", "float32",
                                  "multi"])
def test_key_hash_and_destination_match(kind):
    rng = np.random.default_rng(1)
    n = 5000
    if kind == "multi":
        datas = [rng.integers(-2**62, 2**62, n),
                 rng.normal(size=n), rng.integers(0, 5, n).astype(np.int32)]
    elif kind.startswith("float"):
        v = rng.normal(size=n).astype(kind)
        v[:4] = [0.0, -0.0, np.inf, -np.inf]
        v[4] = np.nan
        datas = [v]
    else:
        datas = [rng.integers(np.iinfo(kind).min, np.iinfo(kind).max, n,
                              endpoint=True).astype(kind)]
    masks = [rng.random(n) > 0.1 if i % 2 == 0 else None
             for i in range(len(datas))]
    pairs = [_cols(d, m) for d, m in zip(datas, masks)]
    hj = jshf.key_hash([a for a, _ in pairs])
    ht = tshf.key_hash([b for _, b in pairs])
    assert np.array_equal(_np(hj), _np(ht))
    for shards in (2, 3, 8):
        assert np.array_equal(_np(jshf.bucket_for_shards(hj, shards)),
                              _np(tshf.bucket_for_shards(ht, shards)))
    dest = _np(tshf.bucket_for_shards(ht, 8))
    assert dest.min() >= 0 and dest.max() < 8


@pytest.mark.parametrize("cap", [400, 60])
def test_build_send_buffers_match(cap):
    """Buffers, validity and the overflow count; with cap 60 rows beyond a
    destination's cap are dropped and counted."""
    rng = np.random.default_rng(2)
    n = 2000
    dest = rng.integers(0, P, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    pay = [rng.integers(0, 10**9, n), rng.normal(size=n),
           rng.random((n, 3)) > 0.5]
    bj, vj, oj = jshf.build_send_buffers(
        jnp.asarray(dest), [jnp.asarray(p) for p in pay],
        jnp.asarray(valid), P, cap)
    bt, vt, ot = tshf.build_send_buffers(
        torch.from_numpy(dest), [torch.from_numpy(p) for p in pay],
        torch.from_numpy(valid), P, cap)
    assert int(oj) == int(ot)
    assert (int(ot) > 0) == (cap == 60)
    assert np.array_equal(_np(vj), _np(vt))
    for a, b in zip(bj, bt):
        live = _np(vt)
        assert np.array_equal(_np(a)[live], _np(b)[live])


# -- group-by routes -------------------------------------------------------

def _specs(kinds, operand_pairs, types_j, types_t):
    js, ts = [], []
    for k, ops, tj_, tt_ in zip(kinds, operand_pairs, types_j, types_t):
        oj, ot = ops if ops is not None else (None, None)
        q = 0.5 if k in ("QUANTILE", "APPROX_QUANTILE") else None
        js.append(jgb.AggSpec(getattr(JKind, k), oj, tj_, arg1=q))
        ts.append(tgb.AggSpec(getattr(TKind, k), ot, tt_, arg1=q))
    return js, ts


def _jit_specs(run, keys, specs):
    """``run(keys, specs)`` as one jitted JAX program (shard_map without
    jit dispatches every primitive apart); the specs' operands are its
    arguments."""
    import dataclasses

    ops = [(s.operand, s.operand2) for s in specs]

    def fn(keys_, ops_):
        return run(keys_, [dataclasses.replace(s, operand=o, operand2=o2)
                           for s, (o, o2) in zip(specs, ops_)])

    return jax.jit(fn)(keys, ops)


def _shard_spec(mesh, spec):
    import dataclasses

    return dataclasses.replace(
        spec, operand=None if spec.operand is None
        else mesh.split_col(spec.operand),
        operand2=None if spec.operand2 is None
        else mesh.split_col(spec.operand2))


def _same_outputs(out_j, out_t, rtol=RTOL):
    kj, aj, ej = out_j[:3]
    kt, at, et = out_t[:3]
    live = _np(ej)
    assert np.array_equal(live, _np(et))
    for a, b in zip(list(kj) + list(aj), list(kt) + list(at)):
        ma = None if a.mask is None else _np(a.mask)[live]
        mb = None if b.mask is None else _np(b.mask)[live]
        assert (ma is None) == (mb is None)
        valid = np.ones(live.sum(), bool) if ma is None else ma
        if ma is not None:
            assert np.array_equal(ma, mb)
        x, y = _np(a.data)[live][valid], _np(b.data)[live][valid]
        if x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=rtol, atol=0)
        else:
            assert np.array_equal(x, y)
    if len(out_j) == 4:
        assert int(out_j[3]) == int(out_t[3])


def test_dist_groupby_perfect_matches(meshes):
    mj, mt = meshes
    rng = np.random.default_rng(3)
    n = P * 1000
    k = rng.integers(0, 7, n)
    km = rng.random(n) > 0.05
    v = rng.normal(size=n)
    w = rng.integers(-50, 50, n)
    kj, kt = _cols(k, km)
    vj, vt = _cols(v)
    wj, wt = _cols(w, rng.random(n) > 0.3)
    kinds = ["COUNT", "SUM", "MIN", "MAX", "AVG", "SUM", "STDDEV_SAMP",
             "APPROX_QUANTILE"]
    ops = [None, (vj, vt), (vj, vt), (wj, wt), (wj, wt), (wj, wt), (vj, vt),
           (vj, vt)]
    tys = ["int64", "fp64", "fp64", "int64", "fp64", "int64", "fp64", "fp64"]
    js, ts = _specs(kinds, ops, [getattr(jt, t)() for t in tys],
                    [getattr(tt, t)() for t in tys])
    layout_j = jgb.choose_perfect_layout([jt.int64()], [(0, 6, True)], 1 << 20)
    layout_t = tgb.choose_perfect_layout([tt.int64()], [(0, 6, True)], 1 << 20)
    oj = _jit_specs(lambda keys, specs: jdg.dist_groupby_perfect(
        mj, keys, layout_j, specs), [kj], js)
    ot = tdg.dist_groupby_perfect(mt, [mt.split_col(kt)], layout_t,
                                  [_shard_spec(mt, s) for s in ts])
    _same_outputs(oj, ot)


def _run_shuffled(meshes, fn_name, keys_np, kinds, ops_np, tys,
                  rows_per_shard, group_cap, slack, masks=None):
    mj, mt = meshes
    pairs = [_cols(k, None if masks is None else masks[i])
             for i, k in enumerate(keys_np)]
    ops = [None if o is None else _cols(*o) for o in ops_np]
    js, ts = _specs(kinds, ops, [getattr(jt, t)() for t in tys],
                    [getattr(tt, t)() for t in tys])
    oj = _jit_specs(lambda keys, specs: getattr(jdg, fn_name)(
        mj, keys, specs, rows_per_shard, group_cap, slack=slack),
        [a for a, _ in pairs], js)
    ot = getattr(tdg, fn_name)(mt, [mt.split_col(b) for _, b in pairs],
                               [_shard_spec(mt, s) for s in ts],
                               rows_per_shard, group_cap, slack=slack)
    return oj, ot


def test_dist_groupby_shuffled_matches(meshes):
    rng = np.random.default_rng(4)
    n = P * 512
    oj, ot = _run_shuffled(
        meshes, "dist_groupby_shuffled", [rng.integers(0, 1000, n)],
        ["COUNT", "SUM", "COUNT_DISTINCT", "QUANTILE"],
        [None, (rng.integers(0, 100, n),), (rng.integers(0, 9, n),),
         (rng.normal(size=n),)],
        ["int64", "int64", "int64", "fp64"], n // P, n // P + 8, 4.0)
    assert int(ot[3]) == 0
    _same_outputs(oj, ot)


def test_shuffle_overflow_detection_matches(meshes):
    """One key: every row to one shard, a tiny cap overflows by the same
    count in both packages."""
    n = P * 64
    oj, ot = _run_shuffled(meshes, "dist_groupby_shuffled",
                           [np.zeros(n, np.int64)], ["COUNT"], [None],
                           ["int64"], n // P, 16, 1.0)
    assert int(ot[3]) > 0
    assert int(oj[3]) == int(ot[3])


def test_null_keys_group_together(meshes):
    rng = np.random.default_rng(5)
    n = P * 128
    keys = rng.integers(0, 5, n)
    mask = rng.random(n) > 0.3
    oj, ot = _run_shuffled(meshes, "dist_groupby_shuffled", [keys],
                           ["COUNT"], [None], ["int64"], n // P, 64, 4.0,
                           masks=[mask])
    _same_outputs(oj, ot)
    live = _np(ot[2])
    km = _np(ot[0][0].mask)[live]
    assert (~km).sum() == 1
    assert _np(ot[1][0].data)[live][~km][0] == (~mask).sum()


@pytest.mark.parametrize("slack", [4.0, 1.0])
def test_two_phase_skew(meshes, slack):
    """90% of the rows share one key: phase 1 collapses it, so small caps
    hold; both packages agree on the result and on the overflow."""
    rng = np.random.default_rng(6)
    n = P * 512
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 50, n))
    oj, ot = _run_shuffled(
        meshes, "dist_groupby_two_phase", [keys],
        ["COUNT", "SUM", "MIN", "AVG", "APPROX_COUNT_DISTINCT"],
        [None, (rng.integers(0, 100, n),), (rng.integers(0, 100, n),),
         (rng.normal(size=n),), (rng.integers(0, 300, n),)],
        ["int64", "int64", "int64", "fp64", "int64"], n // P, 64, slack)
    assert int(ot[3]) == 0
    _same_outputs(oj, ot)


def test_raw_shuffle_overflows_on_same_skew(meshes):
    rng = np.random.default_rng(6)
    n = P * 512
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 50, n))
    oj, ot = _run_shuffled(meshes, "dist_groupby_shuffled", [keys],
                           ["COUNT"], [None], ["int64"], n // P, 64, 1.0)
    assert int(ot[3]) > 0 and int(oj[3]) == int(ot[3])


def test_distinct_split_matches(meshes):
    """COUNT/SUM/AVG DISTINCT over one operand beside algebraic
    aggregates, a hot key and NULL values."""
    rng = np.random.default_rng(7)
    n = P * 400
    keys = np.where(rng.random(n) < 0.7, 3, rng.integers(0, 40, n))
    v = rng.integers(0, 60, n)
    vm = rng.random(n) > 0.1
    x = rng.normal(size=n)
    mj, mt = meshes
    kj, kt = _cols(keys)
    vj, vt = _cols(v, vm)
    xj, xt = _cols(x)
    js = [jgb.AggSpec(JKind.COUNT_DISTINCT, vj, jt.int64(False)),
          jgb.AggSpec(JKind.SUM, vj, jt.int64(), True),
          jgb.AggSpec(JKind.AVG, vj, jt.fp64(), True),
          jgb.AggSpec(JKind.COUNT, None, jt.int64(False)),
          jgb.AggSpec(JKind.SUM, xj, jt.fp64()),
          jgb.AggSpec(JKind.MAX, xj, jt.fp64())]
    vsh, xsh = mt.split_col(vt), mt.split_col(xt)
    ts = [tgb.AggSpec(TKind.COUNT_DISTINCT, vsh, tt.int64(False)),
          tgb.AggSpec(TKind.SUM, vsh, tt.int64(), True),
          tgb.AggSpec(TKind.AVG, vsh, tt.fp64(), True),
          tgb.AggSpec(TKind.COUNT, None, tt.int64(False)),
          tgb.AggSpec(TKind.SUM, xsh, tt.fp64()),
          tgb.AggSpec(TKind.MAX, xsh, tt.fp64())]
    oj = _jit_specs(lambda keys, specs: jdg.dist_groupby_distinct_split(
        mj, keys, specs, n // P, 64), [kj], js)
    ot = tdg.dist_groupby_distinct_split(mt, [mt.split_col(kt)], ts,
                                         n // P, 64)
    assert int(ot[3]) == 0
    _same_outputs(oj, ot)


# -- sort ------------------------------------------------------------------

@pytest.mark.parametrize("desc,nulls_first", [(False, False), (True, True)])
def test_dist_sort_matches(meshes, desc, nulls_first):
    mj, mt = meshes
    rng = np.random.default_rng(8)
    n = P * 256
    vals = rng.integers(0, 10_000, n).astype(np.float64)
    vm = rng.random(n) > 0.05
    pay = rng.integers(0, 1000, n)
    valid = rng.random(n) > 0.1
    sj, st = _cols(vals, vm)
    pj, pt = _cols(pay)
    oj = jax.jit(lambda a, b, rv: jdist_sort(
        mj, [a], [desc], [nulls_first], [a, b], rows_per_shard=n // P,
        row_valid=rv, slack=3.0))(sj, pj, jnp.asarray(valid))
    ot = tdist_sort(mt, [mt.split_col(st)], [desc], [nulls_first],
                    [mt.split_col(st), mt.split_col(pt)], n // P,
                    row_valid=mt.split(torch.from_numpy(valid)), slack=3.0)
    assert int(oj[2]) == int(ot[2]) == 0
    lj, lt = _np(oj[1]), _np(ot[1])
    assert lj.sum() == lt.sum() == valid.sum()
    for a, b in zip(oj[0], ot[0]):
        assert np.array_equal(_np(a.data)[lj], _np(b.data)[lt])
        if a.mask is not None:
            assert np.array_equal(_np(a.mask)[lj], _np(b.mask)[lt])
    keys = np.where(_np(ot[0][0].mask)[lt], _np(ot[0][0].data)[lt],
                    -np.inf if nulls_first else np.inf)
    d = np.diff(keys[np.isfinite(keys)])
    assert (d <= 0).all() if desc else (d >= 0).all()


def test_dist_sort_overflow_reported(meshes):
    """A slack too small for one destination's rows counts an overflow
    (never a short result without one)."""
    _, mt = meshes
    n = P * 64
    col = TCol(torch.zeros(n, dtype=torch.int64))
    _, valid, ov = tdist_sort(mt, [mt.split_col(col)], [False], [False],
                              [mt.split_col(col)], n // P, slack=0.5)
    assert int(ov) > 0
    assert int(valid.sum()) + int(ov) == n


# -- A2d: the capped pair expansion ----------------------------------------

@pytest.mark.parametrize("cap", [4096, 300, 64])
def test_expand_pairs_capped_matches(cap):
    """Duplicate build keys (OneToMany) and NULLs; cap 300 and 64 leave
    total > cap, which both report."""
    rng = np.random.default_rng(9)
    bk = np.concatenate([rng.integers(0, 200, 400),
                         rng.integers(0, 200, 100)])
    pk = rng.integers(0, 260, 700)
    pm = rng.random(700) > 0.1
    bj, bt = _cols(bk)
    pj, pt = _cols(pk, pm)
    tabj, tabt = jjoin.build([bj]), tjoin.build([bt])
    loj, hij = jjoin.probe_ranges(tabj, [pj])
    lot, hit = tjoin.probe_ranges(tabt, [pt])
    out_j = jjoin.expand_pairs_capped(tabj, loj, hij, cap)
    out_t = tjoin.expand_pairs_capped(tabt, lot, hit, cap)
    total = int(out_t[3])
    assert int(out_j[3]) == total
    assert (total > cap) == (cap < 4096)
    live = _np(out_t[2])
    assert np.array_equal(_np(out_j[2]), live)
    assert live.sum() == min(total, cap)
    for a, b in zip(out_j[:2], out_t[:2]):
        assert np.array_equal(_np(a)[live], _np(b)[live])
    # the live pairs are the synced expansion's first ones
    l2, r2 = tjoin.expand_pairs(tabt, lot, hit, total)
    assert np.array_equal(_np(out_t[0])[live], _np(l2)[:live.sum()])
    assert np.array_equal(_np(out_t[1])[live], _np(r2)[:live.sum()])


def test_expand_pairs_capped_empty_probe():
    tab = tjoin.build([TCol(torch.arange(5))])
    lo = hi = torch.zeros(0, dtype=torch.int64)
    l_idx, r_idx, live, total = tjoin.expand_pairs_capped(tab, lo, hi, 64)
    assert int(total) == 0 and not bool(live.any())


# -- t-digest merges ---------------------------------------------------------

def _digests(rng, n_rows, c):
    data = rng.normal(size=n_rows)
    gid = rng.integers(0, 6, n_rows)
    mj, wj = jsk.tdigest_build(jnp.asarray(data), None, jnp.asarray(gid),
                               6, c)
    mt, wt = tsk.tdigest_build(torch.from_numpy(data), None,
                               torch.from_numpy(gid), 6, c)
    return (mj, wj), (mt, wt)


def _same_digest(a, b):
    np.testing.assert_array_equal(_np(b[1]), _np(a[1]))
    np.testing.assert_allclose(_np(b[0]), _np(a[0]), rtol=RTOL, atol=1e-12)


def test_tdigest_merge_gathered_matches():
    rng = np.random.default_rng(10)
    c = 16
    parts = [_digests(rng, 3000, c) for _ in range(4)]
    gm_j = jnp.concatenate([p[0][0] for p in parts], axis=1)
    gw_j = jnp.concatenate([p[0][1] for p in parts], axis=1)
    gm_t = torch.cat([p[1][0] for p in parts], dim=1)
    gw_t = torch.cat([p[1][1] for p in parts], dim=1)
    _same_digest(jsk.tdigest_merge_gathered(gm_j, gw_j, c),
                 tsk.tdigest_merge_gathered(gm_t, gw_t, c))


def test_tdigest_merge_rows_and_flat_match():
    rng = np.random.default_rng(11)
    c = 16
    (mj, wj), (mt, wt) = _digests(rng, 4000, c)
    # rows grouped contiguously: 6 digest rows into 3 groups, one dead
    gid = np.array([0, 0, 1, 1, 2, 3])
    wmask = np.where(gid[:, None] < 3, 1.0, 0.0)
    starts = np.array([0, 2, 4])
    ends = np.array([2, 4, 5])
    out_j = jsk.tdigest_merge_rows(mj, wj * jnp.asarray(wmask),
                                   jnp.asarray(gid), jnp.asarray(starts),
                                   jnp.asarray(ends), 3)
    out_t = tsk.tdigest_merge_rows(mt, wt * torch.from_numpy(wmask),
                                   torch.from_numpy(gid),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(ends), 3)
    _same_digest(out_j, out_t)
    # the flat merge: six digests into three contiguous groups of two
    order = np.argsort(gid % 3, kind="stable")
    g_sorted = np.repeat((gid % 3)[order], c)
    m_s = mj[jnp.asarray(order)].reshape(-1)
    w_s = wj[jnp.asarray(order)].reshape(-1)
    st = np.array([0, 2 * c, 4 * c])
    en = np.array([2 * c, 4 * c, 6 * c])
    flat_j = jsk.tdigest_merge_flat(m_s, w_s, jnp.asarray(g_sorted),
                                    jnp.asarray(st), jnp.asarray(en), 3, 8)
    flat_t = tsk.tdigest_merge_flat(
        mt[torch.from_numpy(order)].reshape(-1),
        wt[torch.from_numpy(order)].reshape(-1), torch.from_numpy(g_sorted),
        torch.from_numpy(st), torch.from_numpy(en), 3, 8)
    _same_digest(flat_j, flat_t)
    q = 0.3
    np.testing.assert_allclose(
        _np(tsk.tdigest_quantile(*flat_t, q)),
        _np(jsk.tdigest_quantile(*flat_j, q)), rtol=RTOL, atol=1e-12)


# -- the mesh --------------------------------------------------------------

def test_mesh_split_views_and_gather_copy_nothing():
    from hdk_tpu_torch.utils import commlog

    mesh = tmesh.make_mesh(4, torch.device("cpu"))
    x = torch.arange(40, dtype=torch.int64)
    shards = mesh.split(x)
    assert all(s.untyped_storage().data_ptr() == x.untyped_storage()
               .data_ptr() for s in shards)
    with commlog.capture() as rec:
        g = mesh.gather(shards)
        v = mesh.view(x)
    assert v is x
    assert g.data_ptr() == x.data_ptr() and torch.equal(g, x)
    assert [r["op"] for r in rec] == ["all_gather", "all_gather"]
    assert all(r.get("gather") and r["bytes_per_device"] == 80
               for r in rec)
    padded = tmesh.pad_rows(torch.arange(10), 4, -1)
    assert padded.shape[0] == 12 and int(padded[-1]) == -1
    assert tmesh.pad_rows(x, 4) is x
    with pytest.raises(ValueError):
        mesh.split(torch.arange(10))


def test_mesh_on_cuda_never_falls_back_to_cpu(monkeypatch):
    """A CUDA mesh bigger than the card count repeats the cards; it never
    builds a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = tmesh.make_mesh(4, torch.device("cuda", 0))
    assert [str(d) for d in mesh.devices] == ["cuda:0"] * 4
