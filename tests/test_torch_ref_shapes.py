"""The reference-derived shapes of tests/test_ref_shapes.py through both
packages on the CPU, on one device, against sqlite3 (the twin of that
suite).  Each query runs in hdk_tpu and in hdk_tpu_torch over the same
tables; both must match sqlite3 as that suite's ``check`` compares, and
each other as tests/torch_twin.py compares.  The data comes from a seed
of its own: that suite's draws from the session's shared generator, so
its tables depend on the order the tests run.

On a card, ``test_ref_shape_on_the_card`` and
``test_float32_sum_on_the_card`` run the same cases in a port session on
CUDA over the same tables: against sqlite3 and the same bound as here,
and against the port's CPU session as tests/torch_twin.py compares; no
kernel's plain version runs while the card's session executes.
"""

import sqlite3

import numpy as np
import pandas as pd
import pytest
import torch

import torch_reftwin as twin  # first: may name the port hdk_tpu
import hdk_tpu
import hdk_tpu_torch
from harness import assert_frames_match
from test_ref_shapes import QUERIES
from torch_twin import assert_same


def _tables():
    """The three tables (name to frame), drawn from seed 31."""
    rng = np.random.default_rng(31)
    n = 3000
    df = pd.DataFrame({
        "x": rng.integers(5, 10, n),
        "y": rng.integers(40, 45, n),
        "z": rng.integers(100, 105, n),
        "t": rng.integers(1000, 1010, n),
        "f": np.round(rng.normal(1.2, 0.4, n), 6),
        "d": np.round(rng.normal(2.5, 1.0, n), 6),
        "fn": np.where(rng.random(n) < 0.2, np.nan,
                       np.round(rng.normal(-0.5, 1.0, n), 6)),
        "w": rng.integers(-50, 50, n),
        "s": rng.choice(["foo", "bar", "baz", "quux"], n),
        "b": rng.integers(0, 2, n),
    })
    inner = pd.DataFrame({
        "x": rng.integers(5, 10, 40),
        "s": rng.choice(["foo", "bar", "hidden"], 40),
        "v": rng.integers(0, 100, 40),
    })
    # float32 values whose sums round: magnitudes spread over six
    # decades, signs mixed
    m = 20_000
    f32 = pd.DataFrame({
        "g": rng.integers(0, 7, m),
        "x": (rng.normal(size=m) * 10.0 ** rng.integers(-3, 3, m))
        .astype(np.float32),
    })
    return {"rt": df, "rt_inner": inner, "f32t": f32}


def _sessions(tables, *sessions):
    """An sqlite3 connection, and ``sessions``, each holding ``tables``."""
    con = sqlite3.connect(":memory:")
    for name, frame in tables.items():
        for s in sessions:
            s.import_pandas(frame, name=name)
        frame.to_sql(name, con, index=False)
    return con


@pytest.fixture(scope="module")
def env():
    tables = _tables()
    jx = hdk_tpu.HDK()
    pt = hdk_tpu_torch.HDK(device="cpu")
    con = _sessions(tables, jx, pt)
    return jx, pt, con, tables["f32t"]


@pytest.fixture(scope="module")
def card_env():
    """(a port session on the card, one on the CPU, sqlite3, the float32
    frame), while no kernel's plain version may run in the card's
    session."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.MonkeyPatch.context() as mp:
        twin.guard_plain_versions(mp)
        tables = _tables()
        gpu = hdk_tpu_torch.HDK(device="cuda")
        cpu = hdk_tpu_torch.HDK(device="cpu")
        con = _sessions(tables, gpu, cpu)
        yield gpu, cpu, con, tables["f32t"]


def _check_sqlite(session, con, sql):
    got = session.sql(sql).to_pandas()
    exp = pd.read_sql_query(sql, con)
    exp.columns = list(got.columns)[: len(exp.columns)]
    approx = tuple(c for c in got.columns if got[c].dtype.kind in "fc")
    assert_frames_match(got, exp, approx_cols=approx)


@pytest.mark.parametrize("sql", QUERIES, ids=[q[:48] for q in QUERIES])
def test_ref_shape_both_packages(env, sql):
    jx, pt, con, _ = env
    _check_sqlite(jx, con, sql)
    _check_sqlite(pt, con, sql)
    assert_same(jx.sql(sql), pt.sql(sql), ordered=False)


def test_float32_sum_within_a_few_ulps(env):
    """SQL SUM over float32 values that do not sum exactly: each group's
    sum in either package is within 8 float32 ulps (8 * 2^-23) of the
    group's sum of |x| of the exact sum (sqlite3 adds the same values in
    double).  The result is float32, and the packages accumulate apart
    (the JAX package in float32 blocks, the port in float64), so the
    error bound grows with the magnitudes added, not with the result,
    which cancellation can make small."""
    jx, pt, con, f32 = env
    _assert_float32_sums(con, f32, jx, pt)


def _assert_float32_sums(con, f32, *sessions):
    sql = "SELECT g, SUM(x) AS s FROM f32t GROUP BY g ORDER BY g"
    exact = pd.read_sql_query(sql, con)
    abs_sum = (f32.assign(a=f32["x"].astype(np.float64).abs())
               .groupby("g")["a"].sum().to_numpy())
    tol = 8 * np.finfo(np.float32).eps * abs_sum
    for session in sessions:
        got = session.sql(sql).to_pandas()
        assert got["g"].tolist() == exact["g"].tolist()
        err = np.abs(got["s"].to_numpy(np.float64) - exact["s"].to_numpy())
        assert (err <= tol).all(), (type(session).__module__, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("sql", QUERIES, ids=[q[:48] for q in QUERIES])
def test_ref_shape_on_the_card(card_env, sql):
    gpu, cpu, con, _ = card_env
    _check_sqlite(gpu, con, sql)
    assert_same(cpu.sql(sql), gpu.sql(sql), ordered=False)


@pytest.mark.cuda
def test_float32_sum_on_the_card(card_env):
    """The float32 SUM bound of test_float32_sum_within_a_few_ulps, on
    the card."""
    gpu, cpu, con, f32 = card_env
    _assert_float32_sums(con, f32, gpu)


def test_smoke_phase15_on_the_cpu():
    """chip_smoke.py's phase 15 at a small size with a CPU session in the
    card's place: it reads this suite's QUERIES, and its tables hold the
    columns of this suite's."""
    import chip_smoke as cs
    from hdk_tpu_torch.kernels import hist

    assert cs.ref_shape_queries() == QUERIES
    tables = cs.gen_ref_shapes(100)
    assert {n: sorted(t) for n, t in tables.items()} == {
        n: sorted(f.columns) for n, f in _tables().items() if n != "f32t"}
    launches = cs.surface_phase(hdk_tpu_torch, "cpu", hist, device="cpu",
                                sizes={"taxi_rows": 20_000,
                                       "shape_rows": 20_000}, want=())
    assert launches == {k.__name__: 0 for k in hist.KERNELS}
