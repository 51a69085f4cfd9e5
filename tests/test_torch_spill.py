"""Result spill to host memory under the device budget: every case of
tests/test_spill.py on the JAX package and on the port, the spilled
results read back equal to the package's own first reading and to each
other; also a result with NULL masks, one with a lazy row mask (a
Filter's output, not yet compacted), a result with lazy columns that
stays untracked, and the manager's accounting of an offload."""

import numpy as np
import pytest

import hdk_tpu
import hdk_tpu_torch
from hdk_tpu.storage.memory import device_cache_manager as jax_manager
from hdk_tpu_torch.storage.memory import device_cache_manager
from torch_twin import assert_same


@pytest.fixture()
def twins():
    return hdk_tpu.HDK(), hdk_tpu_torch.HDK(device="cpu")


def _columns(res):
    """Each column's values and NULL flags, from Arrow (both packages)."""
    return {name: col.to_pylist()
            for name, col in zip(res.to_arrow().column_names,
                                 res.to_arrow().columns)}


def test_explicit_offload_roundtrip(twins):
    res = []
    for hdk in twins:
        ht = hdk.import_pydict({"k": [1, 2, 1, 3], "v": [1., 2., 3., 4.]},
                               name="sp_t")
        r = ht.agg("k", "count", "sum(v)").run()
        first = r.to_arrow()
        r.offload()
        assert r._table is None and r._host_spill is not None
        assert r.to_arrow().equals(first)
        # chaining off a spilled result restores and queries it
        r.offload()
        s = r.scan
        out = s.filter(s["count"] > 1).run()
        assert out.to_arrow().column("k").to_pylist() == [1]
        res.append(r)
    assert_same(*res, ordered=False)


def test_budget_evicts_lru_results(twins):
    rng = np.random.default_rng(2)
    data = {"k": rng.integers(0, 50_000, 200_000),
            "v": rng.normal(size=200_000)}
    got = []
    for hdk, mgr in zip(twins, (jax_manager(), device_cache_manager())):
        old_budget = mgr.budget
        ht = hdk.import_pydict(data, name="sp_big")
        try:
            results = []
            before = mgr.evictions
            mgr.set_budget(1 << 20)  # 1 MiB: a few results must spill
            for i in range(6):
                r = ht.proj(a=ht["k"] + i, b=ht["v"] * 2).run()
                r.block()
                results.append(r)
            assert mgr.evictions > before
            assert any(r._table is None for r in results[:3])
            # spilled results still read back correctly
            for i, r in enumerate(results):
                out = r.to_arrow()
                assert out.column("a").to_numpy().tolist()[:3] == \
                    (data["k"][:3] + i).tolist()
            got.append(results)
        finally:
            mgr.set_budget(old_budget)
    for jx, pt in zip(*got):
        assert_same(jx, pt)


def test_spilled_schema_visible(twins):
    for hdk in twins:
        ht = hdk.import_pydict({"x": [1, 2]}, name="sp_s")
        res = ht.proj(y=ht["x"] * 10).run()
        res.offload()
        assert [n for n, _ in res.schema] == ["y"]
        assert res.row_count == 2


def test_spill_keeps_null_masks(twins):
    res = []
    for hdk in twins:
        ht = hdk.import_pydict({"k": [1, 2, None, 2, 1],
                                "s": ["a", None, "b", "a", None],
                                "v": [1.5, None, 2.5, 3.0, None]},
                               name="sp_n")
        r = ht.proj(k=ht["k"], s=ht["s"], w=ht["v"] * 2).run()
        first = _columns(r)
        r.offload()
        assert r._table is None
        assert _columns(r) == first
        res.append(r)
    assert_same(*res)


def test_spill_of_a_lazy_row_mask():
    """A Filter's result carries a row mask until it is read: the mask
    spills with the columns, the row count is read from the host copy
    without a reload, and the reload reads the filtered rows."""
    hdk = hdk_tpu_torch.HDK(device="cpu")
    ht = hdk.import_pydict({"k": np.arange(20), "v": np.arange(20) * 0.5},
                           name="sp_m")
    r = ht.proj(k=ht["k"], w=ht["v"] + 1).filter(ht["k"] % 3 == 0).run()
    assert r._table.row_mask is not None
    r.offload()
    assert r._host_spill[4] is not None
    assert r.row_count == 7 and r._table is None
    out = r.to_numpy()
    assert out["k"].tolist() == list(range(0, 20, 3))
    np.testing.assert_array_equal(out["w"], np.arange(0, 20, 3) * 0.5 + 1)
    jx = hdk_tpu.HDK()
    jt = jx.import_pydict({"k": np.arange(20), "v": np.arange(20) * 0.5},
                          name="sp_m")
    assert_same(jt.proj(k=jt["k"], w=jt["v"] + 1)
                .filter(jt["k"] % 3 == 0).run(), r)


def test_offload_accounting():
    """A result counts its bytes in the manager until it is offloaded;
    lazy scan columns stay untracked; a collected result leaves it."""
    import gc

    mgr = device_cache_manager()
    hdk = hdk_tpu_torch.HDK(device="cpu")
    ht = hdk.import_pydict({"k": np.arange(1000),
                            "v": np.ones(1000)}, name="sp_a")
    ht.proj(a=ht["k"] * 2, b=ht["v"] + 1).run()  # caches the columns
    gc.collect()
    base = mgr.resident_bytes
    r = ht.proj(a=ht["k"] * 2, b=ht["v"] + 1).run()
    assert mgr.resident_bytes - base == 16_000
    r.offload()
    assert mgr.resident_bytes == base
    r.to_numpy()  # reloads and counts again
    assert mgr.resident_bytes - base == 16_000
    del r
    gc.collect()
    assert mgr.resident_bytes == base
    lazy = ht.run()  # the scan's own columns, not yet read
    assert type(lazy._table.columns) is not list
    assert mgr.resident_bytes == base


def test_offload_races_readers():
    """Threads that offload a result while others read it (as the ingest
    worker's eviction may): every read sees the whole result and its row
    count, under a switch interval short enough to interleave them."""
    import sys
    import threading

    hdk = hdk_tpu_torch.HDK(device="cpu")
    ht = hdk.import_pydict({"k": np.arange(500)}, name="sp_r")
    res = ht.proj(a=ht["k"] * 2).filter(ht["k"] % 2 == 0).run()
    want = np.arange(0, 500, 2) * 2
    errors = []

    def reader():
        try:
            for _ in range(400):
                if not np.array_equal(res.to_numpy()["a"], want):
                    errors.append("rows")
                if res.row_count != 250:
                    errors.append("row count")
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(repr(err))

    def offloader():
        for _ in range(4000):
            res.offload()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=reader) for _ in range(6)]
                   + [threading.Thread(target=offloader) for _ in range(4)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
