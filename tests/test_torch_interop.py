"""SQLite interop: every case of tests/test_interop.py through the JAX
package and the port (sessions with ``exec.enable_interop``) on the same
data, results compared column by column; SUBSTR, which neither engine
has, answered by SQLite in both; the result types SQLite's values take
(an integer column with a NULL becomes float64, as pandas reads it in
the JAX package); and the port's fallback with pandas made
unimportable."""

import sys

import numpy as np
import pyarrow as pa
import pytest

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same

CTE = "WITH RECURSIVE one(x) AS (SELECT 1) "


@pytest.fixture()
def twins():
    on = {"exec.enable_interop": True}
    return hdk_tpu.HDK(**on), hdk_tpu_torch.HDK(device="cpu", **on)


def _import(twins, data, name):
    for hdk in twins:
        hdk.import_arrow(pa.table(data), name=name)


def _both(twins, sql):
    return [hdk.sql(sql) for hdk in twins]


def test_unsupported_sql_falls_back_to_sqlite(twins):
    _import(twins, {"k": [1, 2, 3, 4], "v": [10.0, 20.0, 30.0, 40.0]},
            "io_t")
    # recursive CTE: unsupported by the native parser, valid SQLite
    res = _both(twins,
                "WITH RECURSIVE cnt(x) AS (SELECT 1 UNION ALL SELECT x+1 "
                "FROM cnt WHERE x < 3) "
                "SELECT t.k, t.v FROM io_t t JOIN cnt ON t.k = cnt.x "
                "ORDER BY t.k")
    assert_same(*res)
    out = res[1].to_numpy()
    assert out["k"].tolist() == [1, 2, 3]
    assert out["v"].tolist() == [10.0, 20.0, 30.0]


def test_interop_decodes_strings(twins):
    for hdk in twins:
        hdk.import_pydict({"s": ["aa", "bb", "aa", None],
                           "v": [1, 2, 3, 4]}, name="io_s")
    res = _both(twins, CTE + "SELECT s, SUM(v) AS sv FROM io_s GROUP BY s "
                             "ORDER BY s")
    assert_same(*res)
    out = res[1].to_numpy()
    assert out["s"].mask.tolist() == [True, False, False]
    assert out["s"][1:].tolist() == ["aa", "bb"]
    assert out["sv"].tolist() == [4, 4, 2]


def test_interop_off_by_default():
    from hdk_tpu.sql.lexer import SqlError as JaxSqlError
    from hdk_tpu_torch.sql.lexer import SqlError

    for hdk, err in ((hdk_tpu.HDK(), JaxSqlError),
                     (hdk_tpu_torch.HDK(device="cpu"), SqlError)):
        hdk.import_pydict({"k": [1]}, name="io_off")
        with pytest.raises(err):
            hdk.sql("WITH RECURSIVE cnt(x) AS (SELECT 1) SELECT * FROM cnt")


def test_interop_engine_error_surfaces_for_bad_sql(twins):
    from hdk_tpu.sql.lexer import SqlError as JaxSqlError
    from hdk_tpu_torch.sql.lexer import SqlError

    for hdk, err in zip(twins, (JaxSqlError, SqlError)):
        hdk.import_pydict({"k": [1]}, name="io_bad")
        with pytest.raises(err):
            hdk.sql("SELECT nonexistent_col FROM io_bad")


def test_native_path_unaffected(twins):
    _import(twins, {"k": [1, 2, 2], "v": [1.0, 2.0, 3.0]}, "io_n")
    res = _both(twins, "SELECT k, SUM(v) AS s FROM io_n GROUP BY k "
                       "ORDER BY k")
    assert_same(*res)
    assert res[1].to_numpy()["s"].tolist() == [1.0, 5.0]


def test_substr_falls_back_to_sqlite(twins):
    """SUBSTR is no builtin of either engine: its ExecError sends the query
    to SQLite in both packages."""
    for hdk in twins:
        hdk.import_pydict({"s": ["abc", "xdef"]}, name="t")
    res = _both(twins, "SELECT SUBSTR(s, 2, 3) FROM t")
    assert_same(*res)
    assert res[1].to_numpy()["SUBSTR(s, 2, 3)"].tolist() == ["bc", "def"]


def test_interop_result_types(twins):
    """Each SQLite column typed as the JAX package types it through
    pandas: int64; float64 for an integer column with a NULL (and for a
    float or mixed one); text; comparisons as int64 0/1."""
    for hdk in twins:
        hdk.import_pydict({"k": [1, 2, 3], "v": [1.5, None, 2.0],
                           "s": ["a", None, "b"]}, name="io_ty")
    res = _both(twins, CTE + "SELECT k, v, s, k * 1.5 AS f, "
                             "CASE WHEN k = 2 THEN NULL ELSE k END AS kn, "
                             "CASE WHEN k = 1 THEN 0.5 ELSE k END AS mix, "
                             "k > 1 AS b FROM io_ty ORDER BY k")
    assert_same(*res)
    assert [str(t) for _, t in res[0].schema] == \
        [str(t) for _, t in res[1].schema]
    assert res[1].to_numpy()["kn"].tolist() == [1.0, None, 3.0]


def test_interop_exports_dates_timestamps_and_bools(twins):
    """Timestamps and dates reach SQLite as ISO text, as pandas' to_sql
    writes them (sub-second digits where present), bools as 0/1 and a
    NULL as NULL: the same text and numbers come back in both
    packages."""
    _import(twins, {
        "k": [1, 2, 3],
        "ts": pa.array(np.array(["2013-01-01T00:00:00",
                                 "2014-05-06T07:08:09.5", "NaT"],
                                dtype="datetime64[us]")),
        "d": pa.array(np.array(["2013-01-01", "2020-02-29", "2001-09-09"],
                               dtype="datetime64[D]")),
        "b": [True, False, None]}, "io_dt")
    res = _both(twins, CTE + "SELECT k, ts, d, b FROM io_dt ORDER BY k")
    assert_same(*res)
    assert res[1].to_arrow().to_pylist()[1] == {
        "k": 2, "ts": "2014-05-06 07:08:09.500000", "d": "2020-02-29",
        "b": 0.0}


def test_interop_refuses_an_untyped_column(twins):
    """A column SQLite answers with NULLs only has no type: both
    packages' importers refuse it."""
    for hdk in twins:
        hdk.import_pydict({"k": [1, 2]}, name="io_z")
        with pytest.raises(TypeError):
            hdk.sql(CTE + "SELECT NULL AS z, k FROM io_z")


def test_interop_runs_without_pandas(monkeypatch):
    """The port's fallback needs sqlite3 and numpy only: with pandas
    unimportable it exports, queries and imports back."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    hdk = hdk_tpu_torch.HDK(device="cpu", **{"exec.enable_interop": True})
    hdk.import_pydict({"k": np.arange(5), "s": ["a", "b", None, "a", "c"],
                       "v": np.arange(5) * 0.5}, name="io_np")
    out = hdk.sql("WITH RECURSIVE cnt(x) AS (SELECT 1 UNION ALL SELECT "
                  "x + 1 FROM cnt WHERE x < 3) SELECT io_np.k, s, v "
                  "FROM io_np JOIN cnt ON io_np.k = cnt.x ORDER BY k"
                  ).to_numpy()
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    assert out["k"].tolist() == [1, 2, 3]
    assert out["s"].tolist() == ["b", None, "a"]
    assert out["v"].tolist() == [0.5, 1.0, 1.5]
