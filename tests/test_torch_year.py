"""The stats-bounded EXTRACT(YEAR): where fragment stats bound the operand
to at most 64 years, the year is the lowest year plus the Jan-1
boundaries at or below the value (one ``bucketize``); a wider or unbounded
span takes the civil calendar.  Each case runs through the JAX package
and the port on the same numpy data, and through the port's civil
calendar alone, and all three must be equal: both sides of year
boundaries, pre-1970 epochs, leap days, every timestamp unit (negative
sub-second values floor to the second below), date32 and NULLs."""

import calendar

import numpy as np
import pyarrow as pa
import pytest

import hdk_tpu
import hdk_tpu_torch
from hdk_tpu_torch.exec import datetime_kernels as dtk
from hdk_tpu_torch.exec import scalar as port_scalar
from torch_twin import assert_same

UNITS = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def _boundary_seconds(lo_year: int, hi_year: int) -> np.ndarray:
    """Each Jan 1 in [lo_year, hi_year] and the seconds around it, leap
    days and the last second of each year, and random seconds between."""
    out = []
    for y in range(lo_year, hi_year + 1):
        b = calendar.timegm((y, 1, 1, 0, 0, 0))
        out += [b - 1, b, b + 1]
        if calendar.isleap(y):
            feb29 = calendar.timegm((y, 2, 29, 12, 0, 0))
            out += [feb29, calendar.timegm((y, 12, 31, 23, 59, 59))]
    lo = calendar.timegm((lo_year, 1, 1, 0, 0, 0))
    hi = calendar.timegm((hi_year, 12, 31, 23, 59, 59))
    rng = np.random.default_rng(lo_year & 0xFFFF)
    out += rng.integers(lo, hi, 400).tolist()
    secs = np.asarray(out, np.int64)
    return secs[(secs >= lo) & (secs <= hi)]


def _table(unit: str, lo_year: int, hi_year: int, nulls: bool):
    """A timestamp column in ``unit``: the boundary seconds, with sub-second
    parts of both signs, NULL at every seventh row when ``nulls``."""
    secs = _boundary_seconds(lo_year, hi_year)
    up = UNITS[unit]
    rng = np.random.default_rng(up)
    vals = secs * up
    if up > 1:  # sub-second parts, kept inside the bounding years
        vals = vals + rng.integers(0, up, vals.size)
    mask = (np.arange(vals.size) % 7 == 3) if nulls else None
    return pa.table({"ts": pa.array(vals, type=pa.timestamp(unit),
                                    mask=mask),
                     "k": pa.array(np.arange(vals.size) % 5)})


def _sessions(at):
    jx = hdk_tpu.HDK()
    pt = hdk_tpu_torch.HDK(device="cpu")
    jx.import_arrow(at, name="yt")
    pt.import_arrow(at, name="yt")
    return jx, pt


def _years(sess):
    t = sess.scan("yt")
    return t.proj(y=t["ts"].extract("year"), k=t["k"]).run()


class _CivilSpy:
    """Counts the civil-calendar EXTRACT(YEAR) calls of the port."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = dtk.extract_from_seconds

        def spy(field, secs):
            if field.name == "YEAR":
                self.calls += 1
            return real(field, secs)

        monkeypatch.setattr(dtk, "extract_from_seconds", spy)


def _civil(pt, monkeypatch):
    """The port's answer with the fast path off."""
    monkeypatch.setattr(port_scalar.ScalarCompiler, "_extract_year_bounded",
                        lambda self, e, secs: None)
    try:
        return _years(pt)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("unit", sorted(UNITS))
@pytest.mark.parametrize("years", [(1969, 1971), (1899, 1931), (2013, 2016),
                                   (1999, 2001)])
@pytest.mark.parametrize("nulls", [False, True])
def test_year_fast_path_equals_civil(unit, years, nulls, monkeypatch):
    jx, pt = _sessions(_table(unit, *years, nulls))
    spy = _CivilSpy(monkeypatch)
    fast = _years(pt)
    assert spy.calls == 0  # the fast path took it
    assert_same(_years(jx), fast)
    assert_same(_civil(pt, monkeypatch), fast)


def test_negative_sub_second_values_floor():
    """-1 ms is 1969-12-31 23:59:59.999: the year before 1970."""
    at = pa.table({"ts": pa.array([-1, 0, 1, -999, -1000, -1001],
                                  type=pa.timestamp("ms")),
                   "k": pa.array([0] * 6)})
    jx, pt = _sessions(at)
    got = _years(pt)
    assert_same(_years(jx), got)
    assert got.to_numpy()["y"].tolist() == [1969, 1970, 1970, 1969, 1969,
                                            1969]


def test_date32_column():
    days = np.concatenate([np.arange(-800, 800, 7),
                           [-366, -365, -1, 0, 365, 730, 1095, 1096]])
    at = pa.table({"ts": pa.array(days.astype(np.int32), type=pa.date32()),
                   "k": pa.array(np.arange(days.size) % 3)})
    jx, pt = _sessions(at)
    assert_same(_years(jx), _years(pt))


@pytest.mark.parametrize("span,fast", [(64, True), (65, False)])
def test_span_limit(span, fast, monkeypatch):
    """64 years between the bounds take the fast path; 65 fall back to
    the civil calendar; both equal the JAX package."""
    jx, pt = _sessions(_table("s", 1950, 1950 + span, nulls=True))
    spy = _CivilSpy(monkeypatch)
    got = _years(pt)
    assert (spy.calls == 0) == fast
    assert_same(_years(jx), got)


def test_unbounded_operand_falls_back(monkeypatch):
    """A computed timestamp has no stats bound: the civil calendar."""
    jx, pt = _sessions(_table("s", 2013, 2016, nulls=False))
    spy = _CivilSpy(monkeypatch)
    out = []
    for sess in (jx, pt):
        out.append(sess.sql("SELECT EXTRACT(YEAR FROM ts + INTERVAL '400' "
                            "DAY) AS y FROM yt"))
    assert spy.calls > 0
    assert_same(*out)


def test_group_by_year_like_taxi_q3():
    """Taxi Q3's shape: GROUP BY a key and the year, on both packages."""
    at = _table("s", 2013, 2016, nulls=False)
    jx, pt = _sessions(at)
    out = []
    for sess in (jx, pt):
        t = sess.scan("yt")
        out.append(t.agg(["k", t["ts"].extract("year").name("y")],
                         "count").run())
    assert_same(*out, ordered=False)
