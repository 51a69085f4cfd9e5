"""db-benchmark group-by q6 and q9 in plain numpy, from the generated
table alone.

* q6: ``median(v3)`` (linear between the two middle values, as
  ``quantile_cont(0.5)`` and R's ``median``) and ``stddev(v3)`` (the
  sample standard deviation) by ``id4, id5``.  ``v3`` has six decimals,
  so ``rint(v3 * 1e6)`` is an integer below 2**27 that gives ``v3`` back
  exactly; packed under the group id it sorts every group's values in
  one int64 sort.  The standard deviation takes two passes: the mean
  from the exact integer sums, then the squared deviations from it.
* q9: ``pow(corr(v1, v2), 2)`` by ``id2, id4``.  ``v1`` and ``v2`` are
  small integers, so the moment sums are exact and r squared comes from
  integers: ``(n Sxy - Sx Sy)^2 / ((n Sxx - Sx^2)(n Syy - Sy^2))``.
  ``id2``'s codes index the dictionary ``id001``, ``id002``, ...

``acc`` is the arithmetic's precision: float64 for the reference, as
the configuration states; the control (``acc=np.float32``) rounds the
inputs to float32 and sums in float32, one value after another.  An
aggregate SQL gives as NULL (the standard deviation of one value, r of a
constant column) is NaN here.  Answers are in key order.  Imports numpy
and nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

TABLE = "x"
DECIMALS = 1_000_000  # v3 = round(runif(N, max = 100), 6)
VALUE_BITS = 27       # 100 * DECIMALS < 2**27


def group_ids(*keys: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(a dense int64 id per row over the keys' value ranges, first key
    outermost; each key's value of every id)."""
    lows = [int(k.min()) for k in keys]
    sizes = [int(k.max()) - lo + 1 for k, lo in zip(keys, lows)]
    gid = np.zeros(keys[0].size, np.int64)
    for k, lo, size in zip(keys, lows, sizes):
        gid *= size
        gid += k
        gid -= lo
    values, ids = [], np.arange(int(np.prod(sizes)), dtype=np.int64)
    for lo, size in zip(reversed(lows), reversed(sizes)):
        values.append(ids % size + lo)
        ids //= size
    return gid, values[::-1]


def _group_sums(vals: np.ndarray, starts: np.ndarray, acc) -> np.ndarray:
    """Each group's sum of its run of ``vals`` (rows in group order,
    every group non-empty, ``starts`` their first rows): in float64 by
    ``np.add.reduceat``, exact over integers; in a lower precision one
    value after another."""
    if acc == np.float64:
        return np.add.reduceat(vals, starts)
    ends = np.append(starts[1:], vals.size)
    return np.array([np.cumsum(vals[s:e], dtype=acc)[-1]
                     for s, e in zip(starts, ends)], acc)


def q6(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    x = tables[TABLE]
    gid, (k4, k5) = group_ids(x["id4"], x["id5"])
    v3 = x["v3"]
    scaled = np.rint(v3 * DECIMALS).astype(np.int64)
    if scaled.min() < 0 or scaled.max() >= 1 << VALUE_BITS:
        raise ValueError("v3 outside [0, 100]")
    if not np.array_equal(scaled / DECIMALS, v3):
        raise ValueError("v3 has more than six decimals")
    counts = np.bincount(gid, minlength=k4.size)
    g = np.flatnonzero(counts)
    n, starts = counts[g], (np.cumsum(counts) - counts)[g]
    # every group's values in order, one sort
    packed = (gid << VALUE_BITS) | scaled
    del gid, scaled
    packed.sort()
    ordered = packed & ((1 << VALUE_BITS) - 1)
    del packed
    lo = ordered[starts + (n - 1) // 2]
    hi = ordered[starts + n // 2]
    # n - 1 of each group, NaN where it has one value
    dof = np.where(n > 1, n - 1, np.nan).astype(acc)
    if acc == np.float64:  # in units of 1e-6: integers, exact sums
        a, b = lo / DECIMALS, hi / DECIMALS
        mean = _group_sums(ordered, starts, acc) / n
        dev = ordered - np.repeat(mean, n)
        sd = np.sqrt(_group_sums(dev * dev, starts, acc) / dof) / DECIMALS
    else:
        a = (lo / DECIMALS).astype(acc)
        b = (hi / DECIMALS).astype(acc)
        vals = (ordered / DECIMALS).astype(acc)
        mean = _group_sums(vals, starts, acc) / n.astype(acc)
        dev = vals - np.repeat(mean, n)
        sd = np.sqrt(_group_sums(dev * dev, starts, acc) / dof)
    return {"id4": k4[g], "id5": k5[g],
            "median_v3": (a + (b - a) * acc(0.5)).astype(np.float64),
            "sd_v3": sd.astype(np.float64)}


def q9(tables, acc=np.float64) -> Dict[str, np.ndarray]:
    x = tables[TABLE]
    gid, (k2, k4) = group_ids(x["id2"], x["id4"])
    if acc == np.float64:
        # rows of each (group, v1, v2): the moments as exact integers
        pair, (a, b) = group_ids(x["v1"], x["v2"])
        gid *= a.size
        gid += pair
        del pair
        cnt = np.bincount(gid, minlength=k2.size * a.size).reshape(
            k2.size, a.size)
        n, sx, sy, sxy, sxx, syy = (cnt @ w for w in (
            np.ones_like(a), a, b, a * b, a * a, b * b))
        cov = (n * sxy - sx * sy).astype(np.float64)
        vx = (n * sxx - sx * sx).astype(np.float64)
        vy = (n * syy - sy * sy).astype(np.float64)
    else:
        n = np.bincount(gid, minlength=k2.size)
        order = np.argsort(gid, kind="stable")
        starts = (np.cumsum(n) - n)[n > 0]
        xs, ys = x["v1"][order].astype(acc), x["v2"][order].astype(acc)
        sums = np.zeros((5, k2.size), acc)
        sums[:, n > 0] = [_group_sums(w, starts, acc) for w in (
            xs, ys, xs * ys, xs * xs, ys * ys)]
        sx, sy, sxy, sxx, syy = sums
        nn = n.astype(acc)
        cov, vx, vy = nn * sxy - sx * sy, nn * sxx - sx * sx, nn * syy - sy * sy
    g = np.flatnonzero(n)
    # NaN where a column is constant (or the group has one row)
    denom = vx[g] * vy[g]
    denom = np.where(denom > 0, denom, np.nan)
    r2 = cov[g] * cov[g] / denom
    return {"id2": np.array([f"id{c + 1:03d}" for c in k2[g]], object),
            "id4": k4[g], "r2": r2.astype(np.float64)}
