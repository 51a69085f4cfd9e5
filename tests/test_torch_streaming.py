"""Streaming aggregation: every case of tests/test_streaming.py pushed
batch by batch through the JAX package's and the port's
``create_stream`` on the same data, the finished results compared column
by column (and with a numpy oracle where the reference test has one);
also APPROX_COUNT_DISTINCT's pair grain, a batch whose values are all
NULL, an int8 SUM whose type holds across pushes, and a stream that
leaves no table behind."""

import numpy as np
import pytest

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same


@pytest.fixture()
def twins():
    return hdk_tpu.HDK(), hdk_tpu_torch.HDK(device="cpu")


def _stream(twins, schema, keys, aggs, batches):
    out = []
    for hdk in twins:
        st = hdk.create_stream(schema, keys, aggs)
        for b in batches:
            st.push(b)
        out.append(st.finish())
    return out


def test_streaming_matches_batch(twins):
    rng = np.random.default_rng(42)
    n = 3000
    k = rng.integers(0, 20, n)
    v = rng.normal(size=n) * 10
    batches = [{"k": k[idx], "v": v[idx]}
               for idx in np.array_split(np.arange(n), 5)]
    res = _stream(twins, {"k": "int64", "v": "fp64"}, ["k"],
                  ["count", "sum(v)", "avg(v)", "min(v)", "max(v)",
                   "stddev(v)"], batches)
    assert_same(*res, ordered=False)
    out = res[1].to_numpy()
    order = np.argsort(out["k"])
    assert out["k"][order].tolist() == list(range(20))
    cnt = np.bincount(k, minlength=20)
    sums = np.bincount(k, weights=v, minlength=20)
    assert out["count"][order].tolist() == cnt.tolist()
    np.testing.assert_allclose(out["v_sum"][order], sums, rtol=1e-9)
    np.testing.assert_allclose(out["v_avg"][order], sums / cnt, rtol=1e-9)
    for g in range(20):
        sel = v[k == g]
        i = order[g]
        assert out["v_min"][i] == sel.min() and out["v_max"][i] == sel.max()
        np.testing.assert_allclose(out["v_stddev"][i], sel.std(ddof=1),
                                   rtol=1e-9)


def test_streaming_global_agg(twins):
    res = _stream(twins, {"x": "fp64"}, [], ["count", "sum(x)"],
                  [{"x": [1.0, 2.0]}, {"x": [3.0]}])
    assert_same(*res)
    out = res[1].to_numpy()
    assert out["count"][0] == 3 and out["x_sum"][0] == 6.0


def test_streaming_rejects_holistic(twins):
    for hdk in twins:
        with pytest.raises(ValueError, match="not streamable"):
            hdk.create_stream({"x": "int64"}, [], ["count_distinct(x)"])


def test_streaming_needs_batches(twins):
    for hdk in twins:
        st = hdk.create_stream({"x": "int64"}, [], ["count"])
        with pytest.raises(ValueError, match="no batches"):
            st.finish()


def test_streaming_approx_count_distinct_pair_grain(twins):
    """APPROX_COUNT_DISTINCT keeps the distinct (key, value) pairs across
    pushes: at these sizes the HLL estimate equals the distinct count."""
    rng = np.random.default_rng(7)
    batches = [{"k": rng.integers(0, 4, 500), "v": rng.integers(0, 60, 500)}
               for _ in range(4)]
    res = _stream(twins, {"k": "int64", "v": "int64"}, ["k"],
                  ["count", "approx_count_distinct(v)", "sum(v)"], batches)
    assert_same(*res, ordered=False)
    out = res[1].to_numpy()
    k = np.concatenate([b["k"] for b in batches])
    v = np.concatenate([b["v"] for b in batches])
    for i, g in enumerate(out["k"]):
        exact = len(np.unique(v[k == g]))
        assert abs(int(out["v_approx_count_distinct"][i]) - exact) <= 2


def test_streaming_all_null_batch(twins):
    """A group whose every pushed value is NULL keeps NULL sums, averages,
    extremes and deviations; COUNT(x) of it is 0.  The last batch is all
    NULL (NaN ingests as NULL in both packages; a list of None alone has
    no type for either importer)."""
    nan = np.nan
    batches = [{"k": [1, 1, 2], "x": [None, None, 4.0]},
               {"k": [2, 3], "x": [None, 2.0]},
               {"k": np.asarray([1, 2]), "x": np.asarray([nan, nan])}]
    res = _stream(twins, {"k": "int64", "x": "fp64"}, ["k"],
                  ["count", "count(x)", "sum(x)", "avg(x)", "min(x)",
                   "stddev(x)"], batches)
    assert_same(*res, ordered=False)
    out = res[1].to_numpy()
    i = int(np.flatnonzero(out["k"] == 1)[0])
    assert out["count"][i] == 3 and out["x_count"][i] == 0
    for c in ("x_sum", "x_avg", "x_min", "x_stddev"):
        assert np.ma.getmaskarray(out[c])[i], c


def test_streaming_int8_sum_keeps_its_type(twins):
    """SUM over an int8 column through the union of partials: the same
    result type and exact sums in both packages."""
    rng = np.random.default_rng(3)
    batches = [{"k": rng.integers(0, 3, 400),
                "c": rng.integers(-128, 128, 400).astype(np.int8)}
               for _ in range(3)]
    res = _stream(twins, {"k": "int64", "c": "int8"}, ["k"],
                  ["sum(c)", "avg(c)"], batches)
    assert_same(*res, ordered=False)
    assert [str(t) for _, t in res[0].schema] == \
        [str(t) for _, t in res[1].schema]
    out = res[1].to_numpy()
    k = np.concatenate([b["k"] for b in batches])
    c = np.concatenate([b["c"] for b in batches]).astype(np.int64)
    for i, g in enumerate(out["k"]):
        assert int(out["c_sum"][i]) == int(c[k == g].sum())


def test_stream_leaves_only_its_running_table():
    """Each push drops its batch table and the result tables its merge
    scanned: the session holds one stream table (the finished partials'),
    however many batches were pushed."""
    hdk = hdk_tpu_torch.HDK(device="cpu")
    st = hdk.create_stream({"k": "int64", "v": "fp64"}, ["k"],
                           ["count", "sum(v)"])
    for i in range(6):
        st.push({"k": [i % 2, 1], "v": [1.0, 2.0]})
    out = st.finish().to_numpy()
    assert out["count"].tolist() == [3, 9]
    assert len(hdk.table_names()) == 1
