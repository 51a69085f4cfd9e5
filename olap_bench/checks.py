"""The comparison that decides ``correct``: an answer of the program
against the reference's answer of the same query shape.

A mix's query carries a ``compare`` spec: ``keys`` (the columns that
name a row), ``exact`` (columns equal to the reference), ``close``
(float columns, judged by their relative error), and where the query
orders its rows ``sort`` ([column, "asc" | "desc"], ...) and ``limit``.
Rows are matched by key, so the order of rows the query leaves open
(ties, an unordered GROUP BY) is not judged.  Imports numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _plain(col) -> Tuple[list, int]:
    """(values as Python scalars, number of NULLs)."""
    nulls = 0
    if isinstance(col, np.ma.MaskedArray):
        nulls = int(np.ma.getmaskarray(col).sum())
        col = np.ma.getdata(col)
    return np.asarray(col).tolist(), nulls


def _sort_key(row: Dict[str, object], sort) -> tuple:
    out = []
    for name, way in sort:
        v = row[name]
        if way == "desc":
            if not isinstance(v, (int, float)):
                raise ValueError(f"descending sort on {name!r} needs numbers")
            v = -v
        out.append(v)
    return tuple(out)


def _rows(cols: Dict[str, list], names: List[str], n: int) -> List[dict]:
    return [{k: cols[k][i] for k in names} for i in range(n)]


def compare(got: Dict[str, object], want: Dict[str, np.ndarray],
            spec: dict) -> Tuple[int, float, str, str]:
    """(mismatches, largest relative error of a ``close`` column, the
    first problem found or "", where that error lies).  A mismatch is a row missing, extra,
    duplicated, out of order or outside the top ``limit``, a NULL, or an
    ``exact`` value that differs."""
    keys, exact, close = spec["keys"], spec["exact"], spec["close"]
    sort, limit = spec.get("sort"), spec.get("limit")
    names = list(dict.fromkeys(keys + exact + close
                               + [c for c, _ in sort or []]))
    problems: List[str] = []
    bad = 0
    g, w = {}, {}
    for c in names:
        if c not in got:
            return 1, 0.0, f"column {c!r} missing from the answer", ""
        g[c], nulls = _plain(got[c])
        bad += nulls
        if nulls:
            problems.append(f"{nulls} NULLs in {c!r}")
        w[c], _ = _plain(want[c])
    n_got, n_want = len(g[names[0]]), len(w[names[0]])
    got_rows, want_rows = _rows(g, names, n_got), _rows(w, names, n_want)
    where = {tuple(r[k] for k in keys): i for i, r in enumerate(want_rows)}
    expect = n_want if limit is None else min(limit, n_want)
    if n_got != expect:
        bad += abs(n_got - expect)
        problems.append(f"{n_got} rows, want {expect}")
    rel, worst = 0.0, ""
    seen = set()
    for j, r in enumerate(got_rows):
        key = tuple(r[k] for k in keys)
        i = where.get(key)
        if i is None or key in seen:
            bad += 1
            problems.append(f"row {key} {'repeated' if key in seen else 'not in the reference'}")
            seen.add(key)
            continue
        seen.add(key)
        ref = want_rows[i]
        if limit is not None and i >= limit and (
                _sort_key(ref, sort) != _sort_key(want_rows[limit - 1], sort)):
            bad += 1
            problems.append(f"row {key} is not in the top {limit}")
        for c in exact:
            if r[c] != ref[c]:
                bad += 1
                problems.append(f"{c} of {key}: {r[c]!r} != {ref[c]!r}")
        for c in close:
            a, b = float(r[c]), float(ref[c])
            err = abs(a - b) / max(abs(b), 1e-300) if a != b else 0.0
            if not err <= rel:  # NaN counts as the largest error
                rel = err if err == err else float("inf")
                worst = f"{c} of {key}"
    if sort:
        for j in range(1, n_got):
            if _sort_key(got_rows[j], sort) < _sort_key(got_rows[j - 1], sort):
                bad += 1
                problems.append(f"rows {j - 1} and {j} out of order")
    return bad, rel, (problems[0] if problems else ""), worst
