"""The port's ScalarCompiler against the JAX package's: the same
expression, built with each package's builder over twin tables, evaluated
by each compiler over the same columns.  Values and NULL masks must agree
exactly (floats to 1e-12 relative: transcendental functions may round
differently in the last bits)."""

import numpy as np
import pytest
import torch

import hdk_tpu
import jax.numpy as jnp
from hdk_tpu.exec.masked import MaskedCol as JCol
from hdk_tpu.exec.scalar import ScalarCompiler as JaxScalar

import hdk_tpu_torch
from hdk_tpu_torch.exec.masked import from_numpy
from hdk_tpu_torch.exec.scalar import ScalarCompiler as TorchScalar

from torch_twin import assert_same, twin_sessions

ROWS = 3000


def _nullable(rng, values):
    keep = rng.random(len(values)) >= 0.15
    return [v if k else None for v, k in zip(values.tolist(), keep)]


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(17)
    data = {
        "a": rng.integers(-20, 21, ROWS),
        "b": _nullable(rng, rng.integers(-5, 6, ROWS)),
        "f": (rng.normal(0.0, 3.0, ROWS)).astype(np.float32),
        "y": _nullable(rng, rng.normal(0.0, 40.0, ROWS)),
        # epoch seconds from 1875 to 2065
        "ts": rng.integers(-3 * 10**9, 3 * 10**9, ROWS),
        "tms": rng.integers(-3 * 10**12, 3 * 10**12, ROWS),
        "p": _nullable(rng, rng.random(ROWS) < 0.5),
        "q": _nullable(rng, rng.random(ROWS) < 0.5),
        "s": np.asarray(["apple", "Apricot", "banana", "cherry", "ab_c",
                         None], dtype=object)[rng.integers(0, 6, ROWS)],
    }

    def schema(t):
        return {"ts": t.timestamp(t.TimeUnit.SECOND, False),
                "tms": t.timestamp(t.TimeUnit.MILLI, False)}

    return twin_sessions({"t": data}, schema=schema)


def _fn(mod, name, typ, *args):
    ir = mod.ir.expr
    exprs = [a.expr if hasattr(a, "expr") else a for a in args]
    return mod.builder.QueryExpr(ir.FunctionCall(typ, name, exprs))


def _lit(mod, value):
    return mod.ir.expr.Constant(mod.types.int32(False), value)


EXPRS = {
    # integer division and modulo truncate toward zero (C semantics)
    "div": lambda ht, m: ht["a"] / ht["b"],
    "mod": lambda ht, m: ht["a"] % ht["b"],
    "div_const": lambda ht, m: ht["a"] / 7,
    "arith_mix": lambda ht, m: ht["a"] * 3 - ht["b"] + 2,
    "float_arith": lambda ht, m: ht["y"] / ht["f"] + ht["a"],
    # a float32 column against a float64 literal compares in float64
    "f32_vs_f64": lambda ht, m: ht["f"] > 1.1,
    "cast_f2i": lambda ht, m: ht["y"].cast("int32"),
    "cast_f32_2i": lambda ht, m: ht["f"].cast("int64"),
    "cast_i2f": lambda ht, m: ht["a"].cast("float"),
    "round": lambda ht, m: _fn(m, "round", m.types.fp64(True), ht["y"]),
    "round_1": lambda ht, m: _fn(m, "round", m.types.fp64(True), ht["y"],
                                 _lit(m, 1)),
    "round_int": lambda ht, m: _fn(m, "round", m.types.fp64(False),
                                   ht["a"]),
    "sqrt_int": lambda ht, m: _fn(m, "sqrt", m.types.fp64(False),
                                  ht["a"] * ht["a"]),
    "greatest": lambda ht, m: _fn(m, "greatest", m.types.fp64(True),
                                  ht["f"], ht["y"]),
    "neg_isnull": lambda ht, m: (-ht["b"]).is_null(),
    "case": lambda ht, m: m.if_then_else(ht["y"] > 0, ht["a"], ht["b"]),
    "case_nested": lambda ht, m: m.if_then_else(
        ht["p"], ht["y"], m.if_then_else(ht["q"], ht["f"], ht["a"])),
    "in_int": lambda ht, m: ht["b"].in_values([-3, 0, 4]),
    "in_str": lambda ht, m: ht["s"].in_values(["apple", "cherry", "kiwi"]),
    "like": lambda ht, m: ht["s"].like("a%"),
    "like_escape": lambda ht, m: ht["s"].like("ab\\_%", escape="\\"),
    "ilike": lambda ht, m: ht["s"].ilike("ap%"),
    "regexp": lambda ht, m: ht["s"].regexp("an+a"),
    "str_eq": lambda ht, m: ht["s"] == "banana",
    "and": lambda ht, m: ht["p"] & ht["q"],
    "or": lambda ht, m: ht["p"] | ht["q"],
    "not_and_or": lambda ht, m: ~ht["p"] | (ht["q"] & (ht["a"] > 0)),
    "add_months": lambda ht, m: ht["ts"].add_interval(ht["b"], "month"),
    "add_days": lambda ht, m: ht["ts"].add_interval(3, "day"),
    "diff_months": lambda ht, m: ht["ts"].diff("month", ht["tms"]),
    "diff_days": lambda ht, m: ht["ts"].diff("day", ht["tms"]),
    "ts_lt": lambda ht, m: ht["ts"] < ht["tms"],
    "cast_ts_ms": lambda ht, m: ht["tms"].cast("timestamp[s]"),
}
FIELDS = ["year", "quarter", "month", "day", "hour", "minute", "second",
          "dow", "isodow", "doy", "week", "epoch"]
for _f in FIELDS:
    EXPRS[f"extract_{_f}"] = lambda ht, m, _f=_f: ht["ts"].extract(_f)
for _f in ["year", "quarter", "month", "week", "day", "hour", "minute"]:
    EXPRS[f"trunc_{_f}"] = lambda ht, m, _f=_f: ht["ts"].trunc(_f)
EXPRS["extract_ms"] = lambda ht, m: ht["tms"].extract("millisecond")
EXPRS["trunc_ms_day"] = lambda ht, m: ht["tms"].trunc("day")


def _evaluate(hdk, mod, make, compiler, col):
    expr = make(hdk.scan("t"), mod).expr
    table = hdk._schema.get("t")
    cols = [col(c.data, c.validity) for c in table.columns]
    out = compiler.evaluate(expr, lambda ref: cols[ref.index])
    data = np.broadcast_to(np.asarray(out.data), (table.nrows,))
    mask = (None if out.mask is None
            else np.broadcast_to(np.asarray(out.mask), (table.nrows,)))
    return data, mask


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_scalar_matches_jax(twins, name):
    jx, pt = twins
    make = EXPRS[name]
    jd, jm = _evaluate(
        jx, hdk_tpu, make, JaxScalar(jx._dicts),
        lambda d, v: JCol(jnp.asarray(d),
                          None if v is None else jnp.asarray(v)))
    td, tm = _evaluate(
        pt, hdk_tpu_torch, make, TorchScalar(pt._dicts, torch.device("cpu")),
        lambda d, v: from_numpy(d, v, "cpu"))
    assert (jm is None) == (tm is None)
    live = np.ones(jd.shape, bool) if jm is None else jm
    if jm is not None:
        assert np.array_equal(jm, tm)
    a, b = jd[live], td[live]
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=1e-12, atol=0)
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


def test_window_function_is_refused(twins):
    """Window functions are no longer refused: the query runs and equals
    the JAX package (the name is kept from when it raised; their tests:
    tests/test_torch_window.py)."""
    jx, pt = twins
    sql = "SELECT a, ROW_NUMBER() OVER (ORDER BY a) FROM t"
    assert_same(jx.sql(sql), pt.sql(sql))
