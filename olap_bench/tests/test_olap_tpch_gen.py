"""The TPC-H generator at a tiny scale factor against clause 4.2.3."""

import json
import os

import numpy as np
import pytest

from olap_bench import harness
from olap_bench.data import taxi, tpch_sf10

CONF = json.load(open(os.path.join(harness.ROOT, "olap_bench", "configs",
                                   "tpch_sf10.json")))
SCALE = 0.003  # SF 0.03
CURRENT = tpch_sf10.day("1995-06-17")


@pytest.fixture(scope="module")
def tables():
    return tpch_sf10.generate(CONF, 2 ** 31 + 7, SCALE)


def test_sizes(tables):
    sf = CONF["scale_factor"] * SCALE
    assert tables["customer"]["c_custkey"].size == round(150_000 * sf)
    assert tables["orders"]["o_orderkey"].size == round(1_500_000 * sf)


def test_sparse_order_keys(tables):
    keys = tables["orders"]["o_orderkey"]
    assert np.all(np.diff(keys) > 0)
    block = (keys - 1) // 32
    used = np.bincount(block)
    assert np.all(used[:-1] == 8)  # 8 of every 32
    assert np.all((keys - 1) % 32 < 8)


def test_lines_per_order(tables):
    n = np.bincount(np.searchsorted(tables["orders"]["o_orderkey"],
                                    tables["lineitem"]["l_orderkey"]))
    assert n.min() == 1 and n.max() == 7
    assert np.all(np.isin(tables["lineitem"]["l_orderkey"],
                          tables["orders"]["o_orderkey"]))


def test_dates_and_flags(tables):
    o, li = tables["orders"], tables["lineitem"]
    assert o["o_orderdate"].min() >= tpch_sf10.day("1992-01-01")
    assert o["o_orderdate"].max() <= tpch_sf10.day("1998-12-31") - 151
    odate = o["o_orderdate"][np.searchsorted(o["o_orderkey"],
                                             li["l_orderkey"])]
    delta = li["l_shipdate"] - odate
    assert delta.min() == 1 and delta.max() == 121
    status = np.asarray(["F", "O"])[li["l_linestatus"]]
    assert np.all((status == "O") == (li["l_shipdate"] > CURRENT))
    flag = np.asarray(["A", "N", "R"])[li["l_returnflag"]]
    # receipt = ship + 1..30: shipped after CURRENT - 1 can only be N,
    # shipped on or before CURRENT - 30 can only be R or A
    assert np.all(flag[li["l_shipdate"] >= CURRENT] == "N")
    assert np.all(flag[li["l_shipdate"] <= CURRENT - 30] != "N")
    assert set(np.unique(flag)) == {"A", "N", "R"}


def test_values(tables):
    o, li = tables["orders"], tables["lineitem"]
    assert np.all(o["o_custkey"] % 3 != 0)
    assert o["o_custkey"].min() >= 1
    assert o["o_custkey"].max() <= tables["customer"]["c_custkey"].max()
    assert np.all(o["o_shippriority"] == 0)
    q = li["l_quantity"]
    assert q.min() == 1 and q.max() == 50 and np.all(q == np.round(q))
    assert set(np.round(li["l_discount"] * 100)) == set(range(0, 11))
    assert set(np.round(li["l_tax"] * 100)) == set(range(0, 9))
    retail = li["l_extendedprice"] / q
    lo, hi = 900.0, (90000 + 20000 + 100 * 999) / 100
    assert retail.min() >= lo - 1e-9 and retail.max() <= hi + 1e-9


def test_same_seed_same_tables(tables):
    again = tpch_sf10.generate(CONF, 2 ** 31 + 7, SCALE)
    other = tpch_sf10.generate(CONF, 2 ** 31 + 8, SCALE)
    for t in tables:
        for c in tables[t]:
            assert np.array_equal(tables[t][c], again[t][c])
    assert not np.array_equal(tables["lineitem"]["l_extendedprice"],
                              other["lineitem"]["l_extendedprice"])


def test_taxi_same_seed_same_table():
    conf = json.load(open(os.path.join(harness.ROOT, "olap_bench",
                                       "configs", "taxi.json")))
    a = taxi.generate(conf, 5, 0.0003)["trips"]
    b = taxi.generate(conf, 5, 0.0003)["trips"]
    for c in a:
        assert np.array_equal(a[c], b[c])
    # the source's span, January 2009 through June 2015: seven years
    assert a["pickup_datetime"].min() >= taxi.FIRST_S
    assert a["pickup_datetime"].max() < taxi.END_S
    years = a["pickup_datetime"].astype("datetime64[s]").astype(
        "datetime64[Y]").astype(np.int64) + 1970
    assert sorted(set(years.tolist())) == list(range(2009, 2016))
