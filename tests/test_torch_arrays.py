"""Array columns, VALUES and TOP_K/BOTTOM_K of the port against the JAX
package: a twin of every case of tests/test_arrays.py (ingest round trip,
CARDINALITY, subscript, UNNEST, UNNEST then aggregate, TOP_K chained into
UNNEST, SQL UNNEST, Arrow and Parquet list ingest, NULL elements and
append, UNION ALL of arrays, mixed scalars rejected), TOP_K/BOTTOM_K on
the dense and the sort route with NULLs and groups shorter than k, array
columns through sorts, filters and joins, and VALUES; each through
``hdk_tpu`` and ``hdk_tpu_torch.HDK(device="cpu")`` on the same data,
compared by ``torch_twin.assert_same`` (list columns: element validity,
then NaN positions, then values)."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hdk_tpu
import hdk_tpu_torch

from torch_twin import assert_same, twin_sessions

ARR = {"id": [1, 2, 3, 4], "xs": [[1, 2, 3], [4], None, [5, 6]]}


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(5)
    n = 400
    vals = rng.integers(0, 1000, n).tolist()
    for i in np.flatnonzero(rng.random(n) < 0.15):
        vals[i] = None
    fv = np.round(rng.normal(0, 10, n), 3).tolist()
    for i in np.flatnonzero(rng.random(n) < 0.1):
        fv[i] = None
    return twin_sessions({
        "arr_t": ARR,
        "arr_src": {
            # g: a dense key; h: a float key (the sort route); q: groups of
            # one or two rows, shorter than k
            "g": rng.integers(0, 5, n),
            "h": rng.integers(0, 40, n) * 0.5,
            "q": np.arange(n) // 2 + (np.arange(n) % 7 == 0) * 100_000,
            "v": vals,
            "fv": fv,
            "f32": rng.normal(0, 1, n).astype(np.float32),
        },
        "arr_s1": {"id": [1], "xs": [[4, 5]]},
        "arr_s2": {"k": [1, 2]},
        "arr_u1": {"xs": [[1, 2, 3]]},
        "arr_u2": {"xs": [[9]]},
        "arr_j": {"k": [1, 2, 3, 4, 5], "ys": [[7, 8], [9], None,
                                               [1, 2, 3], [6]]},
    })


def _proj(t, cols):
    return t.proj(**cols(t)).run()


def _both(twins, make):
    jx, pt = twins
    return make(jx), make(pt)


def _cases():
    def at(h):
        t = h.scan("arr_t")
        return t.proj(a0=t["xs"].at(0), a2=t["xs"].at(2),
                      a9=t["xs"].at(9)).run()

    def topk_chain(h):
        t = h.scan("arr_src")
        res = t.agg("g", t["v"].top_k(3).name("t")).run()
        return res.scan.unnest("t").run()

    return {
        "ingest_roundtrip": lambda h: h.scan("arr_t").run(),
        "cardinality": lambda h: _proj(h.scan("arr_t"), lambda t: dict(
            id=t["id"], n=t["xs"].cardinality())),
        "cardinality_sql": lambda h: h.sql(
            "SELECT CARDINALITY(xs) AS n FROM arr_t"),
        "subscript": at,
        "unnest": lambda h: h.scan("arr_t").unnest("xs").run(),
        "unnest_then_aggregate": lambda h: h.scan("arr_t").unnest("xs").agg(
            "id", "count", "sum(xs)").run(),
        "topk_chain_unnest": topk_chain,
        "sql_unnest": lambda h: h.sql(
            "SELECT id, e FROM arr_t, UNNEST(xs) AS e ORDER BY id, e"),
        "sql_unnest_aggregate": lambda h: h.sql(
            "SELECT id, COUNT(*) AS n, SUM(e) AS s FROM arr_t, "
            "UNNEST(arr_t.xs) AS e GROUP BY id ORDER BY id"),
        "sql_unnest_scope": lambda h: h.sql(
            "SELECT k, e FROM arr_s1, arr_s2, UNNEST(arr_s1.xs) AS e "
            "WHERE id = 1 ORDER BY k, e"),
        "sql_unnest_alias": lambda h: h.sql(
            "SELECT id, xs, e FROM arr_s1, UNNEST(xs) AS e ORDER BY e"),
        "union_of_arrays": lambda h: h.scan("arr_u1").union_all(
            h.scan("arr_u2")).run(),
        # widths 1 and 3: the narrower pads with absent elements
        "union_of_widths": lambda h: h.scan("arr_u2").union_all(
            h.scan("arr_t").proj("xs")).run(),
        "empty_arrays": lambda h: h.sql("SELECT xs FROM arr_u1 WHERE 1 = 0"),
        # array columns through a filter, a sort and joins
        "filter_sort": lambda h: h.sql(
            "SELECT id, xs FROM arr_t WHERE id <> 2 ORDER BY id DESC"),
        "sort_limit": lambda h: h.scan("arr_t").sort(("id", "desc"),
                                                     limit=2).run(),
        "join_build_arrays": lambda h: h.sql(
            "SELECT arr_t.id, arr_j.ys FROM arr_t JOIN arr_j ON "
            "arr_t.id = arr_j.k ORDER BY arr_t.id"),
        "join_both_arrays": lambda h: h.sql(
            "SELECT arr_j.k, xs, ys FROM arr_j JOIN arr_t ON "
            "arr_j.k = arr_t.id ORDER BY arr_j.k"),
        "left_join_arrays": lambda h: h.sql(
            "SELECT arr_j.k, xs FROM arr_j LEFT JOIN arr_t ON "
            "arr_j.k = arr_t.id ORDER BY arr_j.k"),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_arrays(twins, name):
    assert_same(*_both(twins, _cases()[name]))


def _topk_queries():
    # no ORDER BY: the reference's fused aggregate -> sort cannot carry
    # an array column; both give the groups in key order
    def q(h, key, col, k, bottom=False):
        t = h.scan("arr_src")
        e = t[col].bottom_k(k) if bottom else t[col].top_k(k)
        return t.agg(key, e.name("t"), "count").run()

    def filtered(h):
        t = h.scan("arr_src")
        f = t.filter(t["v"] > 500)
        return f.agg("g", f["fv"].top_k(2).name("t")).run()

    return {
        "dense_top": lambda h: q(h, "g", "v", 4),
        "dense_bottom": lambda h: q(h, "g", "fv", 3, bottom=True),
        "dense_float32": lambda h: q(h, "g", "f32", 2),
        "sort_top": lambda h: q(h, "h", "v", 5),
        "sort_bottom": lambda h: q(h, "h", "fv", 4, bottom=True),
        # groups of one or two rows, some all-NULL, against k = 3
        "short_groups_top": lambda h: q(h, "q", "v", 3),
        "short_groups_bottom": lambda h: q(h, "q", "fv", 3, bottom=True),
        "filtered": filtered,
    }


@pytest.mark.parametrize("name", sorted(_topk_queries()))
def test_top_k_bottom_k(twins, name):
    assert_same(*_both(twins, _topk_queries()[name]))


def test_arrow_and_parquet_list_ingest(tmp_path):
    tbl = pa.table({"id": [1, 2, 3],
                    "xs": pa.array([[1.5, 2.5], None, [3.0]],
                                   type=pa.list_(pa.float64()))})
    path = str(tmp_path / "a.parquet")
    pq.write_table(tbl, path)
    out = []
    for sess in (hdk_tpu.HDK(), hdk_tpu_torch.HDK(device="cpu")):
        ht = sess.import_arrow(tbl, name="arr_pa")
        hp = sess.import_parquet(path, name="arr_pq")
        out.append((ht.run(),
                    sess.sql("SELECT id, CARDINALITY(xs) AS n FROM arr_pa "
                             "ORDER BY id"),
                    hp.unnest("xs").run()))
    for a, b in zip(*out):
        assert_same(a, b)


def test_null_elements_and_append():
    data = {"id": [1, 2], "xs": [[1, None, 3], None]}
    jx, pt = twin_sessions({"arr_n": data})
    for h in (jx, pt):
        h.append_pydict("arr_n", {"id": [3], "xs": [[7, 8, 9, 10]]})
    t_jx, t_pt = jx._schema.get("arr_n"), pt._schema.get("arr_n")
    for a, b in zip(t_jx.columns, t_pt.columns):
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.validity, b.validity)
    for make in (lambda h: h.scan("arr_n").run(),
                 lambda h: _proj(h.scan("arr_n"), lambda t: dict(
                     n=t["xs"].cardinality())),
                 lambda h: h.scan("arr_n").unnest("xs").run()):
        assert_same(make(jx), make(pt))
    assert pt.scan("arr_n").unnest("xs").run().to_numpy()["xs"].tolist() \
        == [1, 3, 7, 8, 9, 10]


def test_mixed_scalars_rejected():
    for sess in (hdk_tpu.HDK(), hdk_tpu_torch.HDK(device="cpu")):
        with pytest.raises(TypeError):
            sess.import_pydict({"xs": [5, [1, 2]]}, name="arr_bad")


def test_to_numpy_arrays(twins):
    """``to_numpy`` gives each row's valid elements."""
    _, pt = twins
    got = pt.scan("arr_t").run().to_numpy()["xs"]
    assert [r.tolist() for r in got] == [[1, 2, 3], [4], [], [5, 6]]


VALUES_SQL = {
    "int": "SELECT 1 + 1 AS a",
    "float_and_int": "SELECT 2.5 AS b, 7 AS c, 3 * 4 AS d",
    "null": "SELECT NULL AS n, 1 AS one",
    "expression": "SELECT CAST(10 AS DOUBLE) / 4 AS q, 10 / 4 AS r",
}


@pytest.mark.parametrize("name", sorted(VALUES_SQL))
def test_values(twins, name):
    jx, pt = twins
    assert_same(jx.sql(VALUES_SQL[name]), pt.sql(VALUES_SQL[name]))


@pytest.mark.parametrize("package", [
    pytest.param("hdk_tpu", marks=pytest.mark.xfail(
        strict=True, reason="reference fault, ROADMAP C")),
    "hdk_tpu_torch"])
def test_full_join_pads_array_columns(package):
    """FULL OUTER JOIN (LEFT UNION ALL ANTI) with array columns: the
    unmatched side's array is a NULL constant, which the union takes as
    rows without elements (the reference's union indexes its width and
    raises)."""
    sess = (hdk_tpu.HDK() if package == "hdk_tpu"
            else hdk_tpu_torch.HDK(device="cpu"))
    sess.import_pydict({"id": [1, 2, 3], "xs": [[1, 2, 3], [4], None]},
                       name="fa")
    sess.import_pydict({"k": [1, 5], "ys": [[7, 8], [9]]}, name="fb")
    out = sess.sql("SELECT id, k, xs, ys FROM fa FULL JOIN fb "
                   "ON fa.id = fb.k").to_arrow().to_pylist()
    rows = sorted((r["id"] or 0, r["k"] or 0, r["xs"], r["ys"]) for r in out)
    assert rows == [(0, 5, [], [9]), (1, 1, [1, 2, 3], [7, 8]),
                    (2, 0, [4], []), (3, 0, [], [])]
