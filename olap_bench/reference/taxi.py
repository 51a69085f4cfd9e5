"""Taxi Q1-Q4 in plain numpy, from the generated columns alone.

A frozen copy of the port's taxi oracle (``bench_common_torch.py``),
with the accumulation precision of the float sums as a parameter: the
reference sums in float64, as the configuration states; the control
(``acc=np.float32``) accumulates in float32, one value after another.
Each function returns the whole answer as {column: array}, in the
answer's order where the query orders it.  Imports numpy and nothing of
the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# the cab_type dictionary of configs/taxi.json, by code
CAB_TYPES = ["yellow", "green"]


def years(secs: np.ndarray) -> np.ndarray:
    """The calendar year of each epoch second, by a table of the year of
    each day in the range (numpy's calendar)."""
    day0, day1 = int(secs.min()) // 86400, int(secs.max()) // 86400
    days = np.arange(day0, day1 + 1).astype("datetime64[D]")
    year_of = (days.astype("datetime64[Y]").astype(np.int64)
               + 1970).astype(np.int16)
    return year_of[secs // 86400 - day0]


def group_counts(*keys: np.ndarray):
    """(unique key rows in lexicographic order, the rows of each),
    through one mixed-radix code per row."""
    lows = [int(k.min()) for k in keys]
    sizes = [int(k.max()) - lo + 1 for k, lo in zip(keys, lows)]
    code = np.zeros(len(keys[0]), np.int64)
    for k, lo, size in zip(keys, lows, sizes):
        code *= size
        code += k
        code -= lo
    cnt = np.bincount(code)
    codes = np.flatnonzero(cnt)
    counts = cnt[codes]
    cols = []
    for lo, size in zip(reversed(lows), reversed(sizes)):
        cols.append(codes % size + lo)
        codes = codes // size
    return np.stack(cols[::-1], axis=1), counts


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


def q1(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    t = tables["trips"]
    cnt = np.bincount(t["cab_type"])
    keys = np.flatnonzero(cnt)
    return {"cab_type": np.array(CAB_TYPES, object)[keys],
            "count": cnt[keys]}


def q2(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    t = tables["trips"]
    pc = t["passenger_count"]
    cnt = np.bincount(pc)
    (sums,) = group_sums(pc, [t["total_amount"]], cnt.size, acc)
    keys = np.flatnonzero(cnt)
    return {"passenger_count": keys,
            "total_amount_avg": sums[keys] / cnt[keys]}


def q3(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    t = tables["trips"]
    uniq, counts = group_counts(t["passenger_count"],
                                years(t["pickup_datetime"]))
    return {"passenger_count": uniq[:, 0], "y": uniq[:, 1], "count": counts}


def q4(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    """ORDER BY year, count DESC; ties in key order (the comparison
    leaves their order open).  CAST(trip_distance AS INT) truncates
    toward zero, as the port's CAST does; the source's engines round
    (PERF.md, Open questions)."""
    t = tables["trips"]
    uniq, counts = group_counts(t["passenger_count"],
                                years(t["pickup_datetime"]),
                                t["trip_distance"].astype(np.int32))
    order = np.lexsort((-counts, uniq[:, 1]))
    return {"passenger_count": uniq[order, 0], "y": uniq[order, 1],
            "dist": uniq[order, 2], "count": counts[order]}
