"""What the port's bench scripts and chip_smoke.py share: the steps of a
script run (``require_card``, ``card_line``, ``run_child``) and the numpy
oracles of the bench queries.

An oracle computes a query's result from the generated columns alone, in
numpy; a ``*_check`` holds an engine result against it and raises
``RuntimeError`` on a difference.  Keys and counts compare exactly,
float sums to the rtol each check states.  Imports numpy and torch, and
nothing of the engine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List

import numpy as np

# -- a script run -----------------------------------------------------------


def require_card(device: str, script: str) -> None:
    """Raise unless ``device`` is the CPU or a CUDA card is there: a bench
    never falls back to the CPU."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{script}: CUDA is not available (pass "
                           "--device cpu to run on the CPU)")


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"
    for a run on the CPU."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def run_child(argv: List[str], what: str, env=None,
              timeout: float = 3600) -> List[dict]:
    """The JSON records a child process (``python argv``) prints, one a
    line.  A child that exits non-zero or prints none ends the bench:
    SystemExit naming ``what``, the exit code and the end of its errors."""
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})
    recs = [json.loads(l) for l in proc.stdout.splitlines()
            if l.startswith("{")]
    if proc.returncode != 0 or not recs:
        sys.exit(f"{what} failed (rc {proc.returncode}); stderr tail:\n"
                 f"{proc.stderr[-2000:]}")
    return recs


# -- comparisons ------------------------------------------------------------

def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(got, want, rtol: float, what: str) -> None:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    check(np.allclose(got, want, rtol=rtol, atol=0.0),
          f"{what}: max rel err "
          f"{np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))}"
          f" above {rtol}")


def equal(got, want, what: str) -> None:
    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"{what}: differs from the oracle")


def epoch(ts: str) -> int:
    return int(np.datetime64(ts, "s").astype(np.int64))


def years(secs: np.ndarray) -> np.ndarray:
    return secs.astype("datetime64[s]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def group_ids(*keys: np.ndarray):
    """(unique key rows in lexicographic order, inverse ids), through one
    mixed-radix code per row (np.unique over rows is far slower)."""
    keys = [k.astype(np.int64) for k in keys]
    lows = [int(k.min()) for k in keys]
    sizes = [int(k.max()) - lo + 1 for k, lo in zip(keys, lows)]
    code = np.zeros(len(keys[0]), np.int64)
    for k, lo, size in zip(keys, lows, sizes):
        code = code * size + (k - lo)
    present = np.bincount(code) > 0
    codes = np.flatnonzero(present)
    rank = np.cumsum(present) - 1
    cols = []
    for lo, size in zip(reversed(lows), reversed(sizes)):
        cols.append(codes % size + lo)
        codes = codes // size
    return np.stack(cols[::-1], axis=1), rank[code]


# -- taxi Q1-Q4 (bench_torch.py) --------------------------------------------

def taxi_oracle(data):
    """Taxi Q1-Q4 in numpy: name -> a no-argument callable that gives the
    query's result as {column: array}, in the engine's column names and
    row order (Q4's ties of count keep the key order).  bench_torch.py
    times these as its baseline on a host without pandas."""
    pc = data["passenger_count"].astype(np.int64)

    def q1():
        cnt = np.bincount(data["cab_type"])
        keys = np.flatnonzero(cnt)
        return {"cab_type": keys, "count": cnt[keys]}

    def q2():
        cnt = np.bincount(pc)
        sums = np.bincount(pc, weights=data["total_amount"].astype(
            np.float64))
        keys = np.flatnonzero(cnt)
        return {"passenger_count": keys,
                "total_amount_avg": sums[keys] / cnt[keys]}

    def q3():
        uniq, inv = group_ids(pc, years(data["pickup_datetime"]))
        return {"passenger_count": uniq[:, 0], "y": uniq[:, 1],
                "count": np.bincount(inv)}

    def q4():
        uniq, inv = group_ids(pc, years(data["pickup_datetime"]),
                              data["trip_distance"].astype(np.int32))
        counts = np.bincount(inv)
        order = np.argsort(-counts, kind="stable")
        return {"passenger_count": uniq[order, 0], "y": uniq[order, 1],
                "dist": uniq[order, 2], "count": counts[order]}

    return {"q1": q1, "q2": q2, "q3": q3, "q4": q4}


def taxi_check(name: str, out, data) -> None:
    """Taxi query ``name`` (q1-q4) against ``taxi_oracle``: keys and
    counts exactly, Q2's average of float32 values to rtol 1e-6."""
    for col, want in taxi_oracle(data)[name]().items():
        if col == "total_amount_avg":
            close(out[col], want, 1e-6, f"taxi_{name} {col}")
        else:
            equal(out[col], want, f"taxi_{name} {col}")


# -- the suite's configs (bench_suite_torch.py) -----------------------------

def join_fee_check(label: str, out, trips, payments) -> None:
    """COUNT(*) and SUM(fee) of a join whose every probe key has one build
    row: the count exactly, the float32 fees summed to rtol 1e-6."""
    fee_of = np.empty(payments["k"].size, np.float64)
    fee_of[payments["k"]] = payments["fee"]
    count, fee = out.values()
    equal(count, [trips["k"].size], f"{label} count")
    close(fee, [fee_of[trips["k"]].sum()], 1e-6, f"{label} sum(fee)")


def hn_oracle(data, keys: int):
    """(present keys, their counts, their sums of v) of the high-NDV
    table."""
    counts = np.bincount(data["k"], minlength=keys)
    sums = np.bincount(data["k"], weights=data["v"], minlength=keys)
    present = np.flatnonzero(counts)
    return present, counts[present], sums[present].astype(np.int64)


def hn_check(label: str, out, oracle) -> None:
    """HN1 (every group: keys, counts and sum(v) exactly) or HN2 (the 100
    largest counts; ties, Poisson counts, keep the key order)."""
    present, counts, sums = oracle
    if label == "HN1":
        equal(out["k"], present, "HN1 keys")
        equal(out["count"], counts, "HN1 count")
        equal(out["v_sum"], sums, "HN1 sum(v)")
    else:
        top = np.argsort(-counts, kind="stable")[:100]
        equal(out["k"], present[top], "HN2 keys")
        equal(out["count"], counts[top], "HN2 count")


ORACLE_SLICE = 50_000_000  # rows a numpy oracle reads at a time


def tpch_q1_check(cols, li, label):
    """TPC-H Q1's ten columns against numpy, read in slices of the table
    (the 6 (returnflag, linestatus) groups): keys, counts and the integer
    sum exactly, float sums and averages to rtol 1e-9."""
    cut = epoch("1998-09-02T00:00:00")
    cnt = np.zeros(6, np.int64)
    qsum = np.zeros(6, np.int64)
    fs = np.zeros((4, 6))
    for s in range(0, li["l_shipdate"].size, ORACLE_SLICE):
        sl = slice(s, s + ORACLE_SLICE)
        keep = li["l_shipdate"][sl] <= cut
        code = (li["l_returnflag"][sl][keep].astype(np.int64) * 2
                + li["l_linestatus"][sl][keep])
        price = li["l_extendedprice"][sl][keep]
        disc = li["l_discount"][sl][keep]
        tax = li["l_tax"][sl][keep]
        cnt += np.bincount(code, minlength=6)
        qsum += np.bincount(code, weights=li["l_quantity"][sl][keep],
                            minlength=6).astype(np.int64)
        for j, w in enumerate((price, price * (1 - disc),
                               price * (1 - disc) * (1 + tax), disc)):
            fs[j] += np.bincount(code, weights=w, minlength=6)
    present = cnt > 0
    codes = np.flatnonzero(present)
    cnt, qsum, fs = cnt[present], qsum[present], fs[:, present]
    equal(np.stack([cols[0], cols[1]], 1),
          np.stack([codes // 2, codes % 2], 1), f"{label} keys")
    equal(cols[2], qsum, f"{label} sum_qty")
    close(cols[3], fs[0], 1e-9, f"{label} sum_base_price")
    close(cols[4], fs[1], 1e-9, f"{label} sum_disc_price")
    close(cols[5], fs[2], 1e-9, f"{label} sum_charge")
    close(cols[6], qsum / cnt, 1e-9, f"{label} avg_qty")
    close(cols[7], fs[0] / cnt, 1e-9, f"{label} avg_price")
    close(cols[8], fs[3] / cnt, 1e-9, f"{label} avg_disc")
    equal(cols[9], cnt, f"{label} count")


def tpch_q6_check(res, li, label):
    """TPC-H Q6's revenue against numpy (slices of the table), rtol 1e-9."""
    (got,) = res.to_numpy().values()
    lo, hi = epoch("1994-01-01T00:00:00"), epoch("1995-01-01T00:00:00")
    want = 0.0
    for s in range(0, li["l_shipdate"].size, ORACLE_SLICE):
        sl = slice(s, s + ORACLE_SLICE)
        ship, disc = li["l_shipdate"][sl], li["l_discount"][sl]
        sel = ((ship >= lo) & (ship < hi) & (disc >= 0.05) & (disc <= 0.07)
               & (li["l_quantity"][sl] < 24))
        want += np.sum(li["l_extendedprice"][sl][sel] * disc[sel])
    close(got, [want], 1e-9, f"{label} revenue")


def q3_oracle(customer, orders, lineitem):
    """(l_orderkey, revenue) of TPC-H Q3's ten rows, and the orders table:
    the product in float32 as the engine computes it, summed in float64;
    ties of revenue keep the earlier order date."""
    cut = epoch("1995-03-15T00:00:00")
    cust_ok = customer["c_mktsegment"] == "BUILDING"
    ord_ok = (orders["o_orderdate"] < cut) & cust_ok[orders["o_custkey"]]
    lk = lineitem["l_orderkey"]
    li_ok = (lineitem["l_shipdate"] > cut) & ord_ok[lk]
    rev = (lineitem["l_extendedprice"][li_ok]
           * (np.float32(1) - lineitem["l_discount"][li_ok]))
    revenue = np.bincount(lk[li_ok], weights=rev.astype(np.float64),
                          minlength=ord_ok.size)
    keys = np.flatnonzero(np.bincount(lk[li_ok], minlength=ord_ok.size))
    top = keys[np.lexsort((orders["o_orderdate"][keys],
                           -revenue[keys]))[:10]]
    return top, revenue[top], orders


def q3_check(label: str, out, tables) -> None:
    """TPC-H Q3's ten rows against ``q3_oracle``: keys, dates and
    priorities exactly, revenue (float32 products) to rtol 1e-6."""
    top, revenue, orders = q3_oracle(tables["customer3"], tables["orders3"],
                                     tables["lineitem3"])
    equal(out["l_orderkey"], top, f"{label} l_orderkey")
    close(out["revenue"], revenue, 1e-6, f"{label} revenue")
    equal(out["o_orderdate"], orders["o_orderdate"][top],
          f"{label} o_orderdate")
    equal(out["o_shippriority"], orders["o_shippriority"][top],
          f"{label} o_shippriority")
