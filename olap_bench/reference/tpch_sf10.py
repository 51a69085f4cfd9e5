"""TPC-H Q1, Q3 and Q6 at the validation parameters, in plain numpy, from
the generated tables alone.

Float arithmetic follows the query text row by row in the accumulation
type ``acc``: float64 for the reference, as the configuration states
(DECIMAL held as float64); the control (``acc=np.float32``) rounds the
inputs to float32 and accumulates in float32, one value after another.
Strings are the dictionaries' values; dates are days since 1970-01-01.
Q1's and Q6's filters read integer-valued or exactly stored columns, so
both sides select the same rows.  Imports numpy and nothing of the
program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

DICTS = {"l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"],
         "c_mktsegment": ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                          "MACHINERY"]}
SLICE = 20_000_000  # rows read at a time


def day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def group_sums(gid: np.ndarray, cols, n: int, acc) -> list:
    """Per-group sums of each array of ``cols`` (``gid`` in 0..n-1):
    float64 by numpy's pairwise sum (a sum in order would carry a bias
    of ~1e-10 on tens of millions of small values); in a lower precision
    one value after another."""
    out = [np.zeros(n, np.float64) for _ in cols]
    for g in range(n):
        rows = np.flatnonzero(gid == g)
        if rows.size == 0:
            continue
        for o, vals in zip(out, cols):
            sel = vals[rows]
            o[g] = (np.sum(sel, dtype=np.float64) if acc == np.float64
                    else np.cumsum(sel.astype(acc), dtype=acc)[-1])
    return out


def seq_sum(vals: np.ndarray, acc) -> float:
    """A sum in ``acc``: float64 pairwise (numpy's), or one value after
    another in a lower precision."""
    if acc == np.float64:
        return float(np.sum(vals, dtype=np.float64))
    return float(np.cumsum(vals.astype(acc), dtype=acc)[-1]) if vals.size \
        else 0.0


def q1(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    """Pricing summary report, DELTA = 90: shipdate <= 1998-12-01 - 90 days.
    Rows the filter drops go to a group of their own, left out."""
    li = tables["lineitem"]
    n = len(DICTS["l_returnflag"]) * len(DICTS["l_linestatus"])
    code = np.where(li["l_shipdate"] <= day("1998-12-01") - 90,
                    li["l_returnflag"].astype(np.int64) * 2
                    + li["l_linestatus"], n)
    qty, price, disc, tax = (li[c].astype(acc) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    one = acc(1)
    disc_price = price * (one - disc)
    charge = disc_price * (one + tax)
    cnt = np.bincount(code, minlength=n + 1)[:n]
    names = ("qty", "price", "disc_price", "charge", "disc")
    sums = dict(zip(names, (x[:n] for x in group_sums(
        code, [qty, price, disc_price, charge, disc], n, acc))))
    g = np.flatnonzero(cnt)  # in key order
    return {
        "l_returnflag": np.asarray(DICTS["l_returnflag"])[g // 2],
        "l_linestatus": np.asarray(DICTS["l_linestatus"])[g % 2],
        "sum_qty": sums["qty"][g],
        "sum_base_price": sums["price"][g],
        "sum_disc_price": sums["disc_price"][g],
        "sum_charge": sums["charge"][g],
        "avg_qty": sums["qty"][g] / cnt[g],
        "avg_price": sums["price"][g] / cnt[g],
        "avg_disc": sums["disc"][g] / cnt[g],
        "count_order": cnt[g],
    }


def q6(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    """Forecasting revenue change: 1994, discount 0.06 +- 0.01,
    quantity < 24."""
    li = tables["lineitem"]
    lo, hi = day("1994-01-01"), day("1995-01-01")
    terms = []
    for s in range(0, li["l_shipdate"].size, SLICE):
        sl = slice(s, s + SLICE)
        ship, disc = li["l_shipdate"][sl], li["l_discount"][sl]
        sel = ((ship >= lo) & (ship < hi) & (disc >= 0.05) & (disc <= 0.07)
               & (li["l_quantity"][sl] < 24))
        terms.append(li["l_extendedprice"][sl][sel].astype(acc)
                     * disc[sel].astype(acc))
    return {"revenue": np.asarray([seq_sum(np.concatenate(terms), acc)])}


def q3(tables, acc=np.float64, keep: int = 60) -> Dict[str, np.ndarray]:
    """Shipping priority, BUILDING, 1995-03-15: the ``keep`` first rows of
    the answer in its order (revenue descending, then order date; ties
    of both by order key), enough to judge a LIMIT 10 answer."""
    cust, orders, li = tables["customer"], tables["orders"], tables["lineitem"]
    cut = day("1995-03-15")
    building = DICTS["c_mktsegment"].index("BUILDING")
    seg_of = np.zeros(int(cust["c_custkey"].max()) + 1, bool)
    seg_of[cust["c_custkey"]] = cust["c_mktsegment"] == building
    ord_ok = (orders["o_orderdate"] < cut) & seg_of[orders["o_custkey"]]
    row_of = np.full(int(orders["o_orderkey"].max()) + 1, -1, np.int32)
    row_of[orders["o_orderkey"]] = np.arange(orders["o_orderkey"].size,
                                             dtype=np.int32)
    rows, revs = [], []
    for s in range(0, li["l_orderkey"].size, SLICE):
        sl = slice(s, s + SLICE)
        r = row_of[li["l_orderkey"][sl]]
        ok = (r >= 0) & (li["l_shipdate"][sl] > cut)
        ok[ok] = ord_ok[r[ok]]
        rows.append(r[ok])
        revs.append(li["l_extendedprice"][sl][ok].astype(acc)
                    * (acc(1) - li["l_discount"][sl][ok].astype(acc)))
    rows, revs = np.concatenate(rows), np.concatenate(revs)
    if acc == np.float64:
        revenue = np.bincount(rows, weights=revs, minlength=ord_ok.size)
    else:
        revenue = np.zeros(ord_ok.size, acc)
        np.add.at(revenue, rows, revs)
    present = np.unique(rows)
    rev = revenue[present].astype(np.float64)
    top = present[np.lexsort((orders["o_orderkey"][present],
                              orders["o_orderdate"][present], -rev))[:keep]]
    return {"l_orderkey": orders["o_orderkey"][top],
            "revenue": revenue[top].astype(np.float64),
            "o_orderdate": orders["o_orderdate"][top],
            "o_shippriority": orders["o_shippriority"][top]}
