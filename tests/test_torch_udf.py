"""Scalar UDFs: every case of tests/test_udf.py through the JAX package
(a ``jnp`` body) and the port (a torch body) on the same data, results
compared column by column; after re-registration the plans that call the
name run the new body (and build a new join build table where the build
side calls it), and the plans that do not are unaffected; a name that is neither a UDF nor a builtin raises
``ExecError`` in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same, twin_sessions

DATA = {
    "a": [3, 12, 25, 8, None],
    "b": [2, 8, 5, 3, 7],
    "x": [0.5, 1.5, -2.0, 3.25, 0.0],
}


@pytest.fixture()
def twins():
    return twin_sessions({"udf_t": DATA})


def _register(twins, name, jnp_fn, torch_fn, arg_types, ret_type,
              **kwargs):
    """The same UDF in both sessions: ``arg_types``/``ret_type`` take a
    package's types module."""
    for hdk, fn, mod in zip(twins, (jnp_fn, torch_fn),
                            (hdk_tpu, hdk_tpu_torch)):
        hdk.register_udf(name, fn, arg_types=arg_types(mod.types),
                         ret_type=ret_type(mod.types), **kwargs)


def _both(twins, sql):
    return [hdk.sql(sql) for hdk in twins]


def test_builder_udf(twins):
    _register(twins, "gcd", lambda a, b: jnp.gcd(a, b),
              lambda a, b: torch.gcd(a, b),
              lambda t: [t.int64(), t.int64()], lambda t: t.int64())
    jx, pt = [hdk.scan("udf_t") for hdk in twins]
    res = [ht.proj(g=hdk.call("gcd", ht["a"], ht["b"])).run()
           for hdk, ht in zip(twins, (jx, pt))]
    assert_same(*res)
    g = res[1].to_numpy()["g"]
    assert g[:4].tolist() == [1, 4, 5, 1] and g.mask[4]


def test_sql_udf(twins):
    _register(twins, "relu6", lambda x: jnp.clip(x, 0.0, 6.0),
              lambda x: torch.clamp(x, 0.0, 6.0),
              lambda t: [t.fp64()], lambda t: t.fp64(False))
    res = _both(twins, "SELECT relu6(x * 4) AS r FROM udf_t")
    assert_same(*res)
    np.testing.assert_allclose(res[1].to_numpy()["r"],
                               [2.0, 6.0, 0.0, 6.0, 0.0])


def test_udf_in_filter_and_groupby(twins):
    _register(twins, "parity", lambda a: a % 2, lambda a: a % 2,
              lambda t: [t.int64()], lambda t: t.int64())
    res = _both(twins,
                "SELECT parity(b) AS p, COUNT(*) AS n FROM udf_t "
                "WHERE parity(b) >= 0 GROUP BY parity(b) ORDER BY p")
    assert_same(*res)
    out = res[1].to_numpy()
    assert out["p"].tolist() == [0, 1] and out["n"].tolist() == [2, 3]


def test_udf_null_propagation(twins):
    _register(twins, "twice", lambda a: a * 2, lambda a: a * 2,
              lambda t: [t.int64()], lambda t: t.int64())
    res = _both(twins, "SELECT twice(a) AS d FROM udf_t")
    assert_same(*res)
    d = res[1].to_numpy()["d"]
    assert d[:4].tolist() == [6, 24, 50, 16] and d.mask[4]


def test_udf_custom_null_handling(twins):
    def jnp_zero_for_null(a, valid):
        return (jnp.where(valid, a, 0) if valid is not None else a), None

    def torch_zero_for_null(a, valid):
        return (torch.where(valid, a, torch.zeros_like(a))
                if valid is not None else a), None

    _register(twins, "znull", jnp_zero_for_null, torch_zero_for_null,
              lambda t: [t.int64()], lambda t: t.int64(False),
              null_propagation=False)
    res = _both(twins, "SELECT znull(a) AS d FROM udf_t")
    assert_same(*res)
    assert res[1].to_numpy()["d"].tolist() == [3, 12, 25, 8, 0]


def test_udf_rereg_invalidates_cache(twins):
    """The second body's answer after re-registration; a plan that calls
    no UDF gives the same answer across the registration."""
    types = lambda t: [t.int64()]
    ret = lambda t: t.int64()
    _register(twins, "f1", lambda a: a + 1, lambda a: a + 1, types, ret)
    sql = "SELECT f1(b) AS y FROM udf_t"
    plain = "SELECT b + 1 AS y FROM udf_t"
    first = _both(twins, sql)
    assert_same(*first)
    assert first[1].to_numpy()["y"].tolist() == [3, 9, 6, 4, 8]
    before = _both(twins, plain)
    assert_same(*before)
    _register(twins, "f1", lambda a: a + 100, lambda a: a + 100, types, ret)
    second = _both(twins, sql)
    assert_same(*second)
    assert second[1].to_numpy()["y"].tolist() == [102, 108, 105, 103, 107]
    after = _both(twins, plain)
    assert_same(*after)
    assert after[1].to_numpy()["y"].tolist() == \
        before[1].to_numpy()["y"].tolist() == [3, 9, 6, 4, 8]


def test_udf_rereg_in_join_build_side(twins):
    """A join whose build side filters through a UDF: re-registering the
    UDF must not reuse the build tables recycled from the first body."""
    for hdk in twins:
        hdk.import_pydict({"k": np.arange(6), "w": np.arange(6) * 10},
                          name="dim")
    types = lambda t: [t.int64()]
    ret = lambda t: t.int64()
    sql = ("SELECT COUNT(*) AS n, SUM(w) AS s FROM udf_t JOIN "
           "(SELECT k, w FROM dim WHERE keep(k) = 1) d ON udf_t.b = d.k")
    _register(twins, "keep", lambda a: (a % 2 == 0).astype(jnp.int64),
              lambda a: (a % 2 == 0).to(torch.int64), types, ret)
    first = _both(twins, sql)
    assert_same(*first)
    _register(twins, "keep", lambda a: (a % 2 == 1).astype(jnp.int64),
              lambda a: (a % 2 == 1).to(torch.int64), types, ret)
    second = _both(twins, sql)
    assert_same(*second)
    # b in {2, 8, 5, 3, 7}; dim keys 0..5: even keys match b = 2, odd keys
    # match b = 5 and b = 3
    assert first[1].to_numpy()["n"].tolist() == [1]
    assert second[1].to_numpy()["n"].tolist() == [2]


def test_udf_float64_groupby_against_builtins(twins):
    """A float64 UDF as an aggregate operand equals the same expression
    written with builtins, in both packages."""
    _register(twins, "per_unit",
              lambda a, b: a / jnp.maximum(b, 0.1),
              lambda a, b: a / torch.clamp(b, min=0.1),
              lambda t: [t.fp64(), t.fp64()], lambda t: t.fp64())
    udf = _both(twins, "SELECT b, SUM(per_unit(x, b * 1.0)) AS s FROM udf_t "
                       "GROUP BY b ORDER BY b")
    builtin = _both(twins,
                    "SELECT b, SUM(x / CASE WHEN b * 1.0 > 0.1 THEN b * 1.0 "
                    "ELSE 0.1 END) AS s FROM udf_t GROUP BY b ORDER BY b")
    assert_same(*udf)
    assert_same(udf[1], builtin[1])


def test_udf_wrong_arity_rejected(twins):
    from hdk_tpu.sql.binder import SqlError as JaxSqlError
    from hdk_tpu_torch.sql.binder import SqlError

    _register(twins, "one_arg", lambda a: a, lambda a: a,
              lambda t: [t.int64()], lambda t: t.int64())
    for hdk, err in zip(twins, (JaxSqlError, SqlError)):
        with pytest.raises(err):
            hdk.sql("SELECT one_arg(a, b) FROM udf_t")


def test_udf_listing(twins):
    for hdk in twins:
        hdk.register_udf("zz", lambda a: a,
                         arg_types=[hdk_tpu_torch.types.int64()],
                         ret_type=hdk_tpu_torch.types.int64())
        assert "zz" in hdk._udfs.names()
        hdk._udfs.unregister("zz")
        assert "zz" not in hdk._udfs.names()


@pytest.mark.parametrize("sql", [
    "SELECT nosuchfn(a) FROM udf_t",
    "SELECT SUBSTRING(s, 2, 3) FROM strs",
    "SELECT s || 'x' FROM strs",
])
def test_unknown_function_raises_exec_error(twins, sql):
    """A name that is neither a registered UDF nor a builtin: the JAX
    package's ``ExecError`` in both packages."""
    from hdk_tpu.exec.scalar import ExecError as JaxExecError
    from hdk_tpu_torch.exec.scalar import ExecError

    for hdk, err in zip(twins, (JaxExecError, ExecError)):
        hdk.import_pydict({"s": ["abc", "xdef"]}, name="strs")
        with pytest.raises(err, match="unknown function"):
            hdk.sql(sql).to_pandas()
