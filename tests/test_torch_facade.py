"""The rest of the facade, each call through the JAX package and the port
on the same data: ``create_table``, CSV (one file and a list), Parquet
and JSON ingest (the cases of tests/test_storage.py), ``head``/``tail``,
``HDK.call`` of builtins, the TIME literal, ``refragmented_view``,
``clear_device_mem`` and ``drop_table`` (which leave no device copy in
the cache), and ``import_arrow`` with the device prefetch on and off:
the same storage and the same results, the copies made on the ingest
worker, and a copy that fails there raised by the query."""

import json

import numpy as np
import pyarrow as pa
import pytest

import hdk_tpu
import hdk_tpu_torch
from hdk_tpu_torch.storage import table as port_table
from hdk_tpu_torch.storage.memory import device_cache_manager
from torch_twin import assert_same, assert_same_storage, twin_sessions


@pytest.fixture()
def pair():
    return hdk_tpu.HDK(), hdk_tpu_torch.HDK(device="cpu")


def _drain_ingest_worker():
    port_table._ingest_pool().submit(lambda: None).result(timeout=60)


def test_create_empty_table(pair):
    for hdk in pair:
        ht = hdk.create_table("empty_t", {"a": "int64", "s": "text"})
        assert ht.run().row_count == 0
    assert_same_storage(*pair)
    assert [str(t) for _, t in pair[0].scan("empty_t").schema] == \
        [str(t) for _, t in pair[1].scan("empty_t").schema]


def test_csv_parquet_import(pair, tmp_path):
    import pyarrow.parquet as pq

    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,x\n2,y\n")
    csv2 = tmp_path / "t2.csv"
    csv2.write_text("a,b\n3,x\n4,z\n")
    pq.write_table(pa.table({"v": [1.0, 2.0]}), tmp_path / "t.parquet")
    for hdk in pair:
        hdk.import_csv(str(csv), name="csv_t")
        hdk.import_csv([str(csv), str(csv2)], name="csv_two")
        hdk.import_parquet(str(tmp_path / "t.parquet"), name="pq_t")
    assert_same_storage(*pair)
    for name in ("csv_t", "csv_two", "pq_t"):
        assert_same(*[hdk.scan(name).run() for hdk in pair])
    assert pair[1].scan("csv_two").run().to_numpy()["a"].tolist() == \
        [1, 2, 3, 4]


def test_import_json(pair, tmp_path):
    rows = [{"a": int(i), "b": float(i) / 2, "s": f"v{i % 3}"}
            for i in range(50)]
    paths = [tmp_path / "t.json", tmp_path / "t2.json"]
    paths[0].write_text("\n".join(json.dumps(r) for r in rows[:30]))
    paths[1].write_text("\n".join(json.dumps(r) for r in rows[30:]))
    for hdk in pair:
        hdk.import_json(str(paths[0]), name="jt")
        hdk.import_json([str(p) for p in paths], name="jt_all")
    assert_same_storage(*pair)
    res = [hdk.scan("jt_all").agg("s", "count", "sum(a)").sort("s").run()
           for hdk in pair]
    assert_same(*res)
    out = res[1].to_numpy()
    assert out["count"].tolist() == [17, 17, 16]
    assert out["a_sum"].tolist() == [
        sum(i for i in range(50) if i % 3 == g) for g in range(3)]


def test_head_and_tail():
    data = {"k": np.arange(25), "s": [f"s{i % 4}" for i in range(25)]}
    jx, pt = twin_sessions({"ht": data})
    res = [hdk.sql("SELECT k, s FROM ht ORDER BY k") for hdk in (jx, pt)]
    for n in (0, 3, 10, 40):
        for pick in ("head", "tail"):
            a, b = [getattr(r, pick)(n) for r in res]
            assert a.equals(b), (pick, n)
    assert res[1].head(3).column("k").to_pylist() == [0, 1, 2]
    assert res[1].tail(2).column("k").to_pylist() == [23, 24]
    assert res[1].tail().num_rows == 10


@pytest.mark.parametrize("fn,args", [
    ("abs", ["x"]), ("sign", ["x"]), ("sqrt", ["y"]), ("round", ["x"]),
    ("floor", ["x"]), ("lower", ["s"]), ("upper", ["s"]),
    ("greatest", ["x", "y"]), ("power", ["y", 2.0]), ("ln", ["y"]),
])
def test_call_builtins(fn, args):
    data = {"x": [-2.5, 1.25, None, 3.0, -0.5],
            "y": [4.0, 9.0, 2.25, None, 1.0],
            "s": ["Ab", "cD", None, "Ab", "eF"]}
    jx, pt = twin_sessions({"cb": data})
    res = []
    for hdk in (jx, pt):
        ht = hdk.scan("cb")
        e = hdk.call(fn, *[ht[a] if isinstance(a, str) else a for a in args])
        res.append(ht.proj(r=e).run())
    assert [str(t) for _, t in res[0].schema] == \
        [str(t) for _, t in res[1].schema]
    assert_same(*res)


def test_time_literal():
    jx, pt = twin_sessions({"tt": {"k": [1, 2]}})
    for value in ("10:11:12", "23:59", "7"):
        a, b = jx.time(value).expr, pt.time(value).expr
        assert (str(a.type), a.value) == (str(b.type), b.value)
    res = [hdk.scan("tt").proj("k", t=hdk.time("01:02:03")).run()
           for hdk in (jx, pt)]
    assert_same(*res)


def test_refragmented_view():
    rng = np.random.default_rng(5)
    data = {"k": rng.integers(0, 7, 1000), "v": rng.normal(size=1000)}
    jx, pt = twin_sessions({"rf": data})
    res = []
    for hdk in (jx, pt):
        hdk.refragmented_view("rf", "rf_view", 64)
        view = hdk._schema.get("rf_view")
        assert len(view.fragments) == 16 and view.nrows == 1000
        assert view.column_names() == ["k", "v"]
        q = "SELECT k, COUNT(*) AS n, SUM(v) AS s FROM {} GROUP BY k ORDER BY k"
        whole, part = hdk.sql(q.format("rf")), hdk.sql(q.format("rf_view"))
        assert_same(whole, part)
        res.append(part)
    assert_same(*res)


def test_clear_device_mem_and_drop_table():
    """Both leave no device copy of the table's columns, and the manager
    forgets them; the next query copies again and gives the same rows."""
    mgr = device_cache_manager()
    data = {"k": np.arange(100) % 5, "v": np.arange(100) * 1.0}
    jx, pt = twin_sessions({"cm": data, "cm2": data})
    q = "SELECT k, SUM(v) AS s FROM cm GROUP BY k ORDER BY k"
    first = pt.sql(q)
    cols = pt._schema.get("cm").columns
    assert all(c._device for c in cols if not c.info.is_rowid)
    before = mgr.resident_bytes
    pt.clear_device_mem()
    assert not any(c._device for c in cols)
    assert mgr.resident_bytes <= before - 1600
    jx.clear_device_mem()
    assert_same(jx.sql(q), pt.sql(q))
    assert_same(first, pt.sql(q))
    pt.sql("SELECT SUM(v) FROM cm2")
    dropped = pt._schema.get("cm2").columns
    before = mgr.resident_bytes
    pt.drop_table("cm2")
    assert not any(c._device for c in dropped)
    assert mgr.resident_bytes == before - 800
    with pytest.raises(KeyError):
        pt.scan("cm2")


def _arrow_data():
    rng = np.random.default_rng(11)
    n = 5000
    return pa.table({
        "k": pa.array(rng.integers(0, 9, n)),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{i % 13}" for i in range(n)]),
        "c": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
    })


def test_import_arrow_prefetch_on_and_off():
    """With the prefetch on (the default, None) every column is on the
    device once the ingest worker is done; on and off hold the same
    storage as the JAX package and answer the same."""
    at = _arrow_data()
    jx = hdk_tpu.HDK(**{"storage.fragment_size": 1000})
    jx.import_arrow(at, name="pf")
    q = ("SELECT k, COUNT(*) AS n, SUM(v) AS sv, SUM(c) AS sc, "
         "COUNT(DISTINCT s) AS ds FROM pf GROUP BY k ORDER BY k")
    want = jx.sql(q)
    for prefetch in (None, True, False):
        pt = hdk_tpu_torch.HDK(device="cpu", **{
            "storage.fragment_size": 1000,
            "storage.prefetch_device": prefetch})
        pt.import_arrow(at, name="pf")
        _drain_ingest_worker()
        table = pt._schema.get("pf")
        copied = [bool(c._device) for c in table.columns]
        assert copied == [prefetch is not False] * 4, (prefetch, copied)
        assert len(table._stats) == (20 if prefetch is not False else 0)
        assert_same_storage(jx, pt)
        assert_same(want, pt.sql(q))


def test_prefetch_failure_is_raised_by_the_query(monkeypatch):
    """A copy that fails on the ingest worker leaves no cache entry; the
    query's own copy fails again and raises there (nothing falls back to
    another device)."""
    def broken(arr, device):
        raise RuntimeError("device copy failed")

    monkeypatch.setattr(port_table, "to_device", broken)
    pt = hdk_tpu_torch.HDK(device="cpu")
    pt.import_arrow(pa.table({"k": [1, 2, 3]}), name="pf_err")
    _drain_ingest_worker()
    assert not pt._schema.get("pf_err").columns[0]._device
    with pytest.raises(RuntimeError, match="device copy failed"):
        pt.sql("SELECT SUM(k) FROM pf_err").to_numpy()
