#!/usr/bin/env python3
"""Smoke run of hdk_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. device: the card's name and power limit, torch and CUDA versions;
     exits non-zero when CUDA is not available;
  2. build: compiles the CUDA kernels from hdk_tpu_torch/csrc;
  3. kernels: each histogram kernel against its plain PyTorch version on
     the card, at 100M rows and the main path's segment counts (random
     ids; sorted ids at the sort route's 50M-group buffer; K1 also at
     TPC-H Q1's and taxi Q2's layouts), each case timed beside its bound
     (bytes over the device-memory rate), its share of that bound, and
     the one PyTorch call that computes the same function where there is
     one (``bincount``, ``index_add_``);
  4. the main path through the public entry points: taxi Q1-Q4 (builder
     API, 100M rows), TPC-H Q1/Q6 and a scalar subquery (SQL, 60M
     lineitem rows) and a NULL-heavy GROUP BY (SQL, 10M rows), each
     checked against a numpy oracle and required to have run its
     histogram kernels;
  5. the sort-based GROUP BY at high NDV (bench_suite's shape, 100M rows,
     ~43M groups of 50M possible keys): HN1 ``agg("k", "count",
     "sum(v)")`` and HN2 the same count sorted descending, LIMIT 100;
  6. holistic aggregates (SQL, 10M rows): COUNT/SUM DISTINCT, STDDEV,
     MEDIAN over a packed key on the sort route, COUNT DISTINCT and
     QUANTILE on the dense route, HLL and t-digest sketches over a float
     key, and the first query again in a session whose group buffer
     starts below the group count (one widen-retry).
Phases 5-6 are the sort route: their kernel launches count apart from
phase 4's, and every kernel must launch on both.  The line before the
last is a JSON object with the per-kernel results (every phase-3 case
under ``cases``); the last line is
{"ok": true, "device": {...}}.  Any failure raises, so the script exits
non-zero and prints no result.  Needs numpy and torch; imports neither
jax, pandas nor pyarrow.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TAXI_ROWS = 100_000_000
LINEITEM_ROWS = 60_000_000
NULLS_ROWS = 10_000_000
HIGH_NDV_ROWS = 100_000_000
HIGH_NDV_KEYS = 50_000_000
HOLISTIC_ROWS = 10_000_000
SKETCH_PREFIX_ROWS = 1_000_000
KERNEL_ROWS = 100_000_000
REPEATS = 5
# K1 alone in phase 3: (E, rows, slot kind) of TPC-H Q1 and taxi Q2
K1_SHAPES = ((7, LINEITEM_ROWS, "float64"), (10, TAXI_ROWS, "float32"))


_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median device time of ``fn`` over ``repeats`` runs (after one warm
    run), by CUDA events."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- data ---------------------------------------------------------------

def gen_taxi(rows: int):
    """NYC-taxi columns with the distributions, dtypes and seed of the JAX
    package's bench.py (``gen_data``)."""
    rng = np.random.default_rng(7)
    year_secs = 365 * 86400
    return {
        "cab_type": rng.integers(0, 2, rows, dtype=np.int8),
        "passenger_count": rng.integers(0, 9, rows, dtype=np.int8),
        "total_amount": (rng.gamma(2.0, 8.0, rows)).astype(np.float32),
        "trip_distance": (rng.gamma(1.5, 2.5, rows)).astype(np.float32),
        "pickup_datetime": (np.int64(1356998400)  # 2013-01-01
                            + rng.integers(0, 4 * year_secs, rows)),
    }


def gen_lineitem(rows: int):
    """TPC-H lineitem columns with the distributions and seed of
    bench_suite.gen_lineitem."""
    rng = np.random.default_rng(13)
    year_secs = 365 * 86400
    ship = np.int64(694224000) + rng.integers(0, 7 * year_secs, rows)
    return {
        "l_quantity": rng.integers(1, 51, rows).astype(np.int8),
        "l_extendedprice": (rng.gamma(3.0, 12000.0, rows)).astype(np.float64),
        "l_discount": np.round(rng.uniform(0.0, 0.1, rows), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, rows), 2),
        "l_returnflag": rng.integers(0, 3, rows).astype(np.int8),
        "l_linestatus": rng.integers(0, 2, rows).astype(np.int8),
        "l_shipdate": ship,
    }


def gen_nulls(rows: int):
    """g in [0, 1000); int64 x and float64 y, each with 10% NULLs."""
    rng = np.random.default_rng(29)
    g = rng.integers(0, 1000, rows)
    x = rng.integers(-10**12, 10**12, rows)
    y = rng.normal(50.0, 20.0, rows)
    return {
        "g": g,
        "x": np.ma.MaskedArray(x, rng.random(rows) < 0.1),
        "y": np.ma.MaskedArray(y, rng.random(rows) < 0.1),
    }


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


# -- phase 3 ------------------------------------------------------------

# H100 SXM device memory, NVIDIA's data sheet: the rate bound_ms divides by
HBM_BYTES_PER_S = 3.35e12

# slots of each kernel case: (slot kind, columns, bytes per value)
SLOT_SHAPES = {None: (0, 0), "bool": (2, 1), "int8": (1, 1), "int64": (1, 8),
               "float32": (1, 4), "float64": (4, 8)}


def bound_ms(n: int, kind, e: int) -> float:
    """Least time of a histogram on the card: gid (4 B/row) and the slots
    read once, S x E 8-byte sums written once (E counts for K4), over
    the device-memory rate; the kernels do 1 add a value, far under the
    card's operation rate."""
    cols, width = SLOT_SHAPES[kind]
    nbytes = 4 * n + n * cols * width + 8 * max(cols, 1) * e
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_cases(hist):
    """(name, slot kind, kernel, plain version, one PyTorch call computing
    the same function or None).  K1 takes a list of 1-D columns; the other
    kernels an (N, S) tensor.  The library call is timed on in-range ids
    (gids in [0, E), what the group-by hands the kernels), where
    ``bincount`` and ``index_add_`` compute the same function; K2, K3 over
    int8 and K1 over float32 have none (the slot type differs from the
    accumulator's)."""
    def index_add(dtype):
        return lambda g, v, e: torch.zeros(
            (e, v.shape[1]), dtype=dtype, device=g.device).index_add_(0, g, v)

    return [
        ("count_hist", None, lambda g, v, e: hist.count_hist(g, e),
         lambda g, v, e: hist.count_hist_ref(g, e),
         lambda g, v, e: torch.bincount(g, minlength=e)),
        ("groupby_sums2", "bool", hist.groupby_sums2, hist.groupby_sums2_ref,
         None),
        ("seg_sums_exact", "int8", hist.seg_sums_exact,
         hist.seg_sums_exact_ref, None),
        ("seg_sums_exact", "int64", hist.seg_sums_exact,
         hist.seg_sums_exact_ref, index_add(torch.int64)),
        ("groupby_sums", "float32", hist.groupby_sums, hist.groupby_sums_ref,
         None),
        ("groupby_sums", "float64", hist.groupby_sums, hist.groupby_sums_ref,
         index_add(torch.float64)),
    ]


def kernel_phase(hist, entries, sorted_entries, card, k1_shapes=(),
                 n=KERNEL_ROWS, device="cuda"):
    """Every kernel against its plain version at ``n`` rows: over random
    group ids at each of ``entries`` segments, over sorted ids at each of
    ``sorted_entries`` (the sort route's buffers), and K1 alone at each
    (E, rows, slot kind) of ``k1_shapes``.  Random ids are checked with
    ids beyond both ends (those rows drop out) and timed on ids in
    [0, E), beside the library call on the same ids.  ``device`` and
    ``n`` are for a rehearsal on the CPU."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    slots = {
        "bool": torch.rand((n, 2), device=dev, generator=gen) < 0.9,
        "int8": torch.randint(1, 51, (n, 1), device=dev, generator=gen,
                              dtype=torch.int8),
        "int64": torch.randint(-10**12, 10**12, (n, 1), device=dev,
                               generator=gen, dtype=torch.int64),
        # K1's columns, one tensor each; positive, like prices: sums
        # without cancellation, so a relative tolerance bounds the error
        # of the summation order alone
        "float32": [torch.rand((n,), device=dev, generator=gen,
                               dtype=torch.float32) * 100],
        "float64": [torch.rand((n,), device=dev, generator=gen,
                               dtype=torch.float64) * 1e4 for _ in range(4)],
    }
    # index_add_ takes one (N, S) source: stacked here, outside its timing
    stacked = {"int64": slots["int64"],
               "float64": torch.stack(slots["float64"], 1)}
    cases = kernel_cases(hist)
    shapes = ([(e, False, n, None) for e in entries]
              + [(e, True, n, None) for e in sorted_entries]
              + [(e, False, rows, kind) for e, rows, kind in k1_shapes])
    report = {}
    for e, is_sorted, rows, only in shapes:
        if is_sorted:
            gid = torch.sort(torch.randint(0, e, (rows,), device=dev,
                                           generator=gen,
                                           dtype=torch.int32)).values
            check_gid = gid
        else:
            gid = torch.randint(0, e, (rows,), device=dev, generator=gen,
                                dtype=torch.int32)
            # gids beyond both ends: those rows must drop out
            check_gid = torch.randint(-2, e + 2, (rows,), device=dev,
                                      generator=gen, dtype=torch.int32)
        for name, kind, kern, ref, lib in cases:
            if only is not None and (name, kind) != ("groupby_sums", only):
                continue
            v = slots[kind] if kind else None
            if v is not None and rows != n:
                v = [c[:rows] for c in v] if isinstance(v, list) else v[:rows]
            got = kern(check_gid, v, e)
            want = ref(check_gid, v, e)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if got.dtype.is_floating_point:
                ok = torch.allclose(got, want, rtol=1e-10, atol=0.0)
                tol = "rtol 1e-10 (atomic float order varies)"
            else:
                ok = bool(torch.equal(got, want))
                tol = "exact"
            check(ok, f"{name}[{kind}] E={e}: kernel disagrees "
                      f"(max abs err {err})")
            del got, want
            ms = cuda_ms(lambda: kern(gid, v, e))
            plain_ms = cuda_ms(lambda: ref(gid, v, e))
            library_ms = None
            if lib is not None:
                src = stacked.get(kind)
                src = src[:rows] if src is not None else None
                library_ms = cuda_ms(lambda: lib(gid, src, e))
            bound = bound_ms(rows, kind, e)
            log(f"kernel {name:15s} slots={kind or '-':8s} N={rows} E={e} "
                f"{'sorted ' if is_sorted else ''}ok ({tol}) "
                f"max_abs_err={err!r} kernel_ms={ms!r} "
                f"plain_ms={plain_ms!r} library_ms={library_ms!r} "
                f"bound_ms={bound!r} share={bound / ms!r} [{card}]")
            rec = report.setdefault(name, {"max_abs_err": 0.0, "cases": []})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["cases"].append({
                "slots": kind, "S": SLOT_SHAPES[kind][0], "E": e, "N": rows,
                "sorted": is_sorted, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound,
                "share": bound / ms})
        del gid, check_gid
    return report


# -- phase 4 ------------------------------------------------------------

def timed_query(run, card: str, label: str, rows: int, hist, want_kernels):
    """Cold run (checked), the kernels it must have launched, and the
    median warm latency of three more runs."""
    before = hist.launches()
    t0 = time.perf_counter()
    res = run()
    res.block()
    cold = time.perf_counter() - t0
    used = {k: hist.launches()[k] - before[k] for k in before}
    for k in want_kernels:
        check(used[k] > 0, f"{label}: kernel {k} never launched ({used})")
    warm = []
    for _ in range(3):
        res.block()
        t0 = time.perf_counter()
        run().block()
        warm.append(time.perf_counter() - t0)
    lat = statistics.median(warm)
    log(f"query {label}: rows={rows} cold_s={cold!r} warm_latency_s={lat!r}"
        f" rows_per_s={rows / lat!r} launches={used} [{card}]")
    return res


def taxi_q4_entries(data) -> int:
    """Entries of taxi Q4's dense layout: passenger counts x years x
    integer distances present in the data."""
    yr = years(data["pickup_datetime"])
    dist = data["trip_distance"].astype(np.int32)
    return (9 * (int(yr.max() - yr.min()) + 1)
            * (int(dist.max()) - int(dist.min()) + 1))


def taxi_phase(hdk_mod, hdk, data, card, hist):
    t = hdk_mod.types
    ht = hdk.import_pydict(
        dict(data), name="trips",
        schema={"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    pc = data["passenger_count"].astype(np.int64)
    yr = years(data["pickup_datetime"])

    res = timed_query(lambda: ht.agg("cab_type", "count").run(), card,
                      "taxi_q1", TAXI_ROWS, hist, [])
    out = res.to_numpy()
    equal(out["cab_type"], [0, 1], "taxi_q1 keys")
    equal(out["count"], np.bincount(data["cab_type"], minlength=2),
          "taxi_q1 count")

    res = timed_query(
        lambda: ht.agg("passenger_count", "avg(total_amount)").run(), card,
        "taxi_q2", TAXI_ROWS, hist, ["groupby_sums", "count_hist"])
    out = res.to_numpy()
    cnt = np.bincount(pc, minlength=9)
    sums = np.bincount(pc, weights=data["total_amount"].astype(np.float64),
                       minlength=9)
    equal(out["passenger_count"], np.arange(9), "taxi_q2 keys")
    close(out["total_amount_avg"], sums / cnt, 1e-6, "taxi_q2 avg")

    year_expr = lambda: ht["pickup_datetime"].extract("year").name("y")
    res = timed_query(
        lambda: ht.agg(["passenger_count", year_expr()], "count").run(),
        card, "taxi_q3", TAXI_ROWS, hist, ["count_hist"])
    out = res.to_numpy()
    uniq, inv = group_ids(pc, yr)
    equal(np.stack([out["passenger_count"], out["y"]], 1), uniq,
          "taxi_q3 keys")
    equal(out["count"], np.bincount(inv), "taxi_q3 count")

    dist = data["trip_distance"].astype(np.int32)
    res = timed_query(
        lambda: ht.agg(["passenger_count", year_expr(),
                        ht["trip_distance"].cast("int32").name("dist")],
                       "count").sort(("count", "desc")).run(),
        card, "taxi_q4", TAXI_ROWS, hist, ["count_hist"])
    out = res.to_numpy()
    uniq, inv = group_ids(pc, yr, dist)
    counts = np.bincount(inv)
    order = np.argsort(-counts, kind="stable")  # ties keep key order
    equal(np.stack([out["passenger_count"], out["y"], out["dist"]], 1),
          uniq[order], "taxi_q4 keys")
    equal(out["count"], counts[order], "taxi_q4 count")
    hdk.drop_table("trips")


TPCH_Q1 = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity), "
    "SUM(l_extendedprice), "
    "SUM(l_extendedprice * (1 - l_discount)), "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), "
    "COUNT(*) FROM lineitem "
    "WHERE l_shipdate <= TIMESTAMP '1998-09-02 00:00:00' "
    "GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus")
TPCH_Q6 = (
    "SELECT SUM(l_extendedprice * l_discount) FROM lineitem "
    "WHERE l_shipdate >= TIMESTAMP '1994-01-01 00:00:00' "
    "AND l_shipdate < TIMESTAMP '1995-01-01 00:00:00' "
    "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24")
SCALAR_SUBQUERY = (
    "SELECT COUNT(*), SUM(l_extendedprice) FROM lineitem "
    "WHERE l_extendedprice > (SELECT AVG(l_extendedprice) FROM lineitem)")
NULLS_Q = ("SELECT g, COUNT(*), COUNT(x), SUM(x), AVG(y) FROM t "
           "GROUP BY g ORDER BY g")


def tpch_phase(hdk_mod, hdk, card, hist):
    t = hdk_mod.types
    t0 = time.perf_counter()
    li = gen_lineitem(LINEITEM_ROWS)
    log(f"lineitem data: {LINEITEM_ROWS} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")
    hdk.import_pydict(li, name="lineitem", schema={
        "l_shipdate": t.timestamp(t.TimeUnit.SECOND, False)})

    res = timed_query(lambda: hdk.sql(TPCH_Q1), card, "tpch_q1",
                      LINEITEM_ROWS, hist,
                      ["groupby_sums", "seg_sums_exact", "count_hist"])
    cols = list(res.to_numpy().values())
    keep = li["l_shipdate"] <= epoch("1998-09-02T00:00:00")
    rf = li["l_returnflag"][keep].astype(np.int64)
    ls = li["l_linestatus"][keep].astype(np.int64)
    uniq, inv = group_ids(rf, ls)
    qty = li["l_quantity"][keep].astype(np.int64)
    price = li["l_extendedprice"][keep]
    disc = li["l_discount"][keep]
    tax = li["l_tax"][keep]
    cnt = np.bincount(inv)
    fsum = lambda w: np.bincount(inv, weights=w)
    qsum = np.zeros(len(uniq), np.int64)
    np.add.at(qsum, inv, qty)
    equal(np.stack([cols[0], cols[1]], 1), uniq, "tpch_q1 keys")
    equal(cols[2], qsum, "tpch_q1 sum_qty")
    close(cols[3], fsum(price), 1e-9, "tpch_q1 sum_base_price")
    close(cols[4], fsum(price * (1 - disc)), 1e-9, "tpch_q1 sum_disc_price")
    close(cols[5], fsum(price * (1 - disc) * (1 + tax)), 1e-9,
          "tpch_q1 sum_charge")
    close(cols[6], qsum / cnt, 1e-9, "tpch_q1 avg_qty")
    close(cols[7], fsum(price) / cnt, 1e-9, "tpch_q1 avg_price")
    close(cols[8], fsum(disc) / cnt, 1e-9, "tpch_q1 avg_disc")
    equal(cols[9], cnt, "tpch_q1 count")

    res = timed_query(lambda: hdk.sql(TPCH_Q6), card, "tpch_q6",
                      LINEITEM_ROWS, hist, [])
    (got,) = res.to_numpy().values()
    sel = ((li["l_shipdate"] >= epoch("1994-01-01T00:00:00"))
           & (li["l_shipdate"] < epoch("1995-01-01T00:00:00"))
           & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
           & (li["l_quantity"] < 24))
    close(got, [np.sum(li["l_extendedprice"][sel] * li["l_discount"][sel])],
          1e-9, "tpch_q6 revenue")

    res = timed_query(lambda: hdk.sql(SCALAR_SUBQUERY), card,
                      "scalar_subquery", LINEITEM_ROWS, hist, [])
    count, total = res.to_numpy().values()
    price = li["l_extendedprice"]
    above = price[price > price.mean()]
    equal(count, [above.size], "scalar_subquery count")
    close(total, [above.sum()], 1e-9, "scalar_subquery sum")
    hdk.drop_table("lineitem")


def nulls_phase(hdk, card, hist):
    data = gen_nulls(NULLS_ROWS)
    hdk.import_pydict(data, name="t")
    res = timed_query(lambda: hdk.sql(NULLS_Q), card, "nulls", NULLS_ROWS,
                      hist, ["groupby_sums2", "seg_sums_exact",
                             "count_hist"])
    cols = list(res.to_numpy().values())
    g = data["g"]
    xv = ~np.ma.getmaskarray(data["x"])
    yv = ~np.ma.getmaskarray(data["y"])
    xsum = np.zeros(1000, np.int64)
    np.add.at(xsum, g[xv], data["x"].data[xv])
    ycnt = np.bincount(g[yv], minlength=1000)
    ysum = np.bincount(g[yv], weights=data["y"].data[yv], minlength=1000)
    equal(cols[0], np.arange(1000), "nulls keys")
    equal(cols[1], np.bincount(g, minlength=1000), "nulls count(*)")
    equal(cols[2], np.bincount(g[xv], minlength=1000), "nulls count(x)")
    equal(cols[3], xsum, "nulls sum(x)")
    close(cols[4], ysum / ycnt, 1e-9, "nulls avg(y)")
    hdk.drop_table("t")


# -- phases 5-6: the sort route -------------------------------------------

class EntryRecorder:
    """Largest segment count each histogram kernel was launched with while
    active, read from the launches themselves (``hist._launch``); the
    wrappers and their launch counters are untouched."""

    # kernel entry point prefix -> (wrapper name, position of E in args)
    ENTRY = (("hdk_count_hist", "count_hist", 2),
             ("hdk_groupby_sums2_", "groupby_sums2", 4),
             ("hdk_seg_sums_exact_", "seg_sums_exact", 4),
             ("hdk_groupby_sums_", "groupby_sums", 4))

    def __init__(self, hist):
        self.hist = hist
        self.max_e = {name: 0 for _, name, _ in self.ENTRY}
        self._orig = None

    def __enter__(self):
        self._orig = orig = self.hist._launch

        def launch(entry, gid, *args):
            for prefix, name, pos in self.ENTRY:
                if entry.startswith(prefix):
                    self.max_e[name] = max(self.max_e[name], int(args[pos]))
                    break
            return orig(entry, gid, *args)

        self.hist._launch = launch
        return self

    def __exit__(self, *exc):
        self.hist._launch = self._orig


def gen_high_ndv(rows: int, keys: int):
    """bench_suite.bench_high_ndv's columns and seed."""
    rng = np.random.default_rng(12)
    return {"k": rng.integers(0, keys, rows), "v": rng.integers(0, 1000, rows)}


def high_ndv_phase(hdk, card, hist, rows=HIGH_NDV_ROWS, keys=HIGH_NDV_KEYS,
                   want=("count_hist", "seg_sums_exact")):
    t0 = time.perf_counter()
    data = gen_high_ndv(rows, keys)
    counts = np.bincount(data["k"], minlength=keys)
    sums = np.bincount(data["k"], weights=data["v"], minlength=keys)
    present = np.flatnonzero(counts)
    log(f"high-NDV data: {rows} rows, {present.size} distinct keys of "
        f"{keys}; data and oracle in {time.perf_counter() - t0:.1f} s")
    ht = hdk.import_pydict(data, name="ndv_t")

    res = timed_query(lambda: ht.agg("k", "count", "sum(v)").run(), card,
                      "HN1", rows, hist, want)
    out = res.to_numpy()
    equal(out["k"], present, "HN1 keys")
    equal(out["count"], counts[present], "HN1 count")
    equal(out["v_sum"], sums[present].astype(np.int64), "HN1 sum(v)")
    log(f"HN1: group buffer cap {hdk._executor._groupby_cap} for "
        f"{present.size} groups, NDV estimate "
        f"{hdk._executor._ndv_estimate}")
    del out, res

    res = timed_query(
        lambda: ht.agg("k", "count").sort(("count", "desc"), limit=100).run(),
        card, "HN2", rows, hist, [k for k in want if k == "count_hist"])
    out = res.to_numpy()
    # ties (Poisson counts) keep the key order
    top = np.argsort(-counts[present], kind="stable")[:100]
    equal(out["k"], present[top], "HN2 keys")
    equal(out["count"], counts[present][top], "HN2 count")
    hdk.drop_table("ndv_t")


def gen_holistic(rows: int):
    """k int64 in [0, 5M) with 5% NULLs (above the dense limit: the packed
    sort route), g int32 in [0, 1000), x int64 and y float64 N(50, 20)
    with 10% NULLs each, r = round(y, 1) as a float key (no ranges: the
    NDV estimate sizes its buffer)."""
    rng = np.random.default_rng(31)
    y0 = rng.normal(50.0, 20.0, rows)
    return {
        "k": np.ma.MaskedArray(rng.integers(0, 5_000_000, rows),
                               rng.random(rows) < 0.05),
        "g": rng.integers(0, 1000, rows).astype(np.int32),
        "x": np.ma.MaskedArray(rng.integers(-10**12, 10**12, rows),
                               rng.random(rows) < 0.1),
        "y": np.ma.MaskedArray(y0, rng.random(rows) < 0.1),
        "r": np.round(y0, 1),
    }


HOLISTIC_Q1 = ("SELECT k, COUNT(*) AS n, COUNT(DISTINCT g) AS nd_g, "
               "SUM(DISTINCT g) AS sd_g, MIN(y) AS min_y, MAX(x) AS max_x, "
               "STDDEV_SAMP(y) AS sd_y, MEDIAN(y) AS med_y FROM h "
               "GROUP BY k ORDER BY k")
HOLISTIC_Q2 = ("SELECT g, COUNT(DISTINCT k) AS nd_k, QUANTILE(y, 0.25) AS q_y "
               "FROM h GROUP BY g ORDER BY g")
HOLISTIC_Q3 = ("SELECT r, APPROX_COUNT_DISTINCT(x) AS hll_x, "
               "APPROX_QUANTILE(y, 0.9) AS td_y FROM h GROUP BY r ORDER BY r")


def _spans(sorted_ids: np.ndarray):
    """(run starts, run lengths) of a sorted id array."""
    starts = np.flatnonzero(np.r_[True, sorted_ids[1:] != sorted_ids[:-1]])
    return starts, np.diff(np.r_[starts, sorted_ids.size])


def _group_quantile(ids, vals, q):
    """(group ids, exact linear-interpolated quantile per group)."""
    order = np.lexsort((vals, ids))
    sid, sv = ids[order], vals[order]
    starts, cnt = _spans(sid)
    pos = q * (cnt - 1).astype(np.float64)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    lo_v, hi_v = sv[starts + lo], sv[starts + hi]
    return sid[starts], lo_v + (hi_v - lo_v) * (pos - lo)


def _distinct_pairs(ids, vals):
    """(group ids, distinct value count, distinct value sum) per group."""
    order = np.lexsort((vals, ids))
    sid, sv = ids[order], vals[order]
    first = np.r_[True, (sid[1:] != sid[:-1]) | (sv[1:] != sv[:-1])]
    starts, _ = _spans(sid)
    csum = np.cumsum(first)
    ends = np.r_[starts[1:], sid.size]
    n_distinct = csum[ends - 1] - np.r_[0, csum[ends[:-1] - 1]]
    vsum = np.add.reduceat(np.where(first, sv, 0), starts)
    return sid[starts], n_distinct, vsum


def holistic_q1_check(out, data, what):
    k = data["k"]
    kv = ~np.ma.getmaskarray(k)
    kd = np.where(kv, np.ma.getdata(k), 5_000_000)  # NULL key last
    keys = np.unique(kd)
    equal(np.ma.getdata(out["k"])[~np.ma.getmaskarray(out["k"])],
          keys[keys < 5_000_000], f"{what} keys")
    check(np.ma.getmaskarray(out["k"]).sum() == (not kv.all()),
          f"{what}: one NULL key group")
    slot = np.searchsorted(keys, kd)
    equal(out["n"], np.bincount(slot), f"{what} count(*)")
    gid, nd, gsum = _distinct_pairs(slot, data["g"].astype(np.int64))
    equal(gid, np.arange(keys.size), f"{what} groups")
    equal(np.ma.getdata(out["nd_g"]), nd, f"{what} count(distinct g)")
    equal(np.ma.getdata(out["sd_g"]), gsum, f"{what} sum(distinct g)")
    yv = ~np.ma.getmaskarray(data["y"])
    y = np.ma.getdata(data["y"])
    n_y = np.bincount(slot[yv], minlength=keys.size)
    has_y = n_y > 0
    ymin = np.full(keys.size, np.inf)
    np.minimum.at(ymin, slot[yv], y[yv])
    equal(~np.ma.getmaskarray(out["min_y"]), has_y, f"{what} min(y) nulls")
    equal(np.ma.getdata(out["min_y"])[has_y], ymin[has_y], f"{what} min(y)")
    xv = ~np.ma.getmaskarray(data["x"])
    xmax = np.full(keys.size, np.iinfo(np.int64).min)
    np.maximum.at(xmax, slot[xv], np.ma.getdata(data["x"])[xv])
    has_x = np.bincount(slot[xv], minlength=keys.size) > 0
    equal(~np.ma.getmaskarray(out["max_x"]), has_x, f"{what} max(x) nulls")
    equal(np.ma.getdata(out["max_x"])[has_x], xmax[has_x], f"{what} max(x)")
    # STDDEV: a two-pass oracle; the engine's sum-of-squares formula
    # loses up to ~8 eps * sum(y^2) of the variance to cancellation
    s1 = np.bincount(slot[yv], weights=y[yv], minlength=keys.size)
    mean = s1 / np.maximum(n_y, 1)
    dev2 = np.bincount(slot[yv], weights=(y[yv] - mean[slot[yv]]) ** 2,
                       minlength=keys.size)
    sq = np.bincount(slot[yv], weights=y[yv] ** 2, minlength=keys.size)
    two = n_y > 1
    equal(~np.ma.getmaskarray(out["sd_y"]), two, f"{what} stddev_samp nulls")
    sd = np.sqrt(dev2[two] / (n_y[two] - 1))
    var_err = 8 * np.finfo(np.float64).eps * sq[two] / (n_y[two] - 1)
    sd_err = np.where(sd > 0, var_err / (2 * np.maximum(sd, 1e-300)),
                      np.sqrt(var_err))
    got = np.ma.getdata(out["sd_y"])[two]
    check(np.all(np.abs(got - sd) <= 1e-9 * sd + sd_err),
          f"{what} stddev_samp: outside rtol 1e-9 + the formula's bound")
    equal(~np.ma.getmaskarray(out["med_y"]), has_y, f"{what} median nulls")
    gq, med = _group_quantile(slot[yv], y[yv], 0.5)
    close(np.ma.getdata(out["med_y"])[gq], med, 1e-9, f"{what} median(y)")


def holistic_phase(hdk_mod, hdk, card, hist, rows=HOLISTIC_ROWS,
                   prefix_rows=SKETCH_PREFIX_ROWS,
                   want=("count_hist", "groupby_sums2", "seg_sums_exact",
                         "groupby_sums")):
    t0 = time.perf_counter()
    data = gen_holistic(rows)
    log(f"holistic data: {rows} rows in {time.perf_counter() - t0:.1f} s")
    hdk.import_pydict(data, name="h")
    before = hist.launches()
    res1 = timed_query(lambda: hdk.sql(HOLISTIC_Q1), card, "holistic_q1",
                       rows, hist, [k for k in want
                                    if k in ("count_hist", "groupby_sums")])
    q1 = res1.to_numpy()
    holistic_q1_check(q1, data, "holistic_q1")

    res = timed_query(lambda: hdk.sql(HOLISTIC_Q2), card, "holistic_q2",
                      rows, hist, [k for k in want if k == "count_hist"])
    out = res.to_numpy()
    kv = ~np.ma.getmaskarray(data["k"])
    _, nd, _ = _distinct_pairs(data["g"][kv].astype(np.int64),
                               np.ma.getdata(data["k"])[kv])
    equal(out["g"], np.arange(1000), "holistic_q2 keys")
    equal(out["nd_k"], nd, "holistic_q2 count(distinct k)")
    yv = ~np.ma.getmaskarray(data["y"])
    gq, q25 = _group_quantile(data["g"][yv].astype(np.int64),
                              np.ma.getdata(data["y"])[yv], 0.25)
    close(np.ma.getdata(out["q_y"])[gq], q25, 1e-9,
          "holistic_q2 quantile(y, 0.25)")

    res = timed_query(lambda: hdk.sql(HOLISTIC_Q3), card, "holistic_q3",
                      rows, hist, [])
    out = res.to_numpy()
    sketch_exact_check(out, data, hdk._executor, "holistic_q3")
    used = {k: hist.launches()[k] - before[k] for k in before}
    for k in want:
        check(used[k] > 0, f"holistic phase: kernel {k} never launched")

    # the same sketches on a prefix, on the CPU: equal to the card's
    prefix = {c: v[:prefix_rows] for c, v in data.items()}
    outs = []
    for session in (hdk, hdk_mod.HDK(device="cpu")):
        session.import_pydict(prefix, name="hp")
        outs.append(session.sql(HOLISTIC_Q3.replace("FROM h ", "FROM hp "))
                    .to_numpy())
    card_out, cpu_out = outs
    equal(card_out["r"], cpu_out["r"], "sketch prefix keys")
    equal(card_out["hll_x"], cpu_out["hll_x"], "sketch prefix HLL (exact)")
    close(np.ma.getdata(card_out["td_y"]), np.ma.getdata(cpu_out["td_y"]),
          1e-9,
          "sketch prefix t-digest")
    log(f"sketches on a {prefix_rows}-row prefix: card equals CPU (HLL "
        f"exactly, t-digest to rtol 1e-9)")
    hdk.drop_table("hp")

    # a group buffer below the group count: exactly one widen-retry
    small = hdk_mod.HDK(device=hdk.device.type,
                        **{"exec.group_by.default_max_groups": 1 << 20})
    small.import_pydict(data, name="h")
    got = small.sql(HOLISTIC_Q1).to_numpy()
    attempts = small._executor._groupby_attempts
    check(attempts == 2, f"retry session: {attempts} attempts, want 2")
    for name in q1:
        equal(np.ma.getmaskarray(got[name]), np.ma.getmaskarray(q1[name]),
              f"retry session {name} nulls")
        if q1[name].dtype.kind == "f":
            close(np.ma.filled(got[name], 0.0), np.ma.filled(q1[name], 0.0),
                  1e-9, f"retry session {name}")
        else:
            equal(np.ma.getdata(got[name]), np.ma.getdata(q1[name]),
                  f"retry session {name}")
    log(f"retry session: default_max_groups 2^20 < {len(q1['n'])} "
        f"groups, {attempts} attempts, same result")
    hdk.drop_table("h")


def sketch_exact_check(out, data, executor, what):
    """HLL within 4 standard errors (1.04/sqrt(m)) of the exact distinct
    count, plus one for a register collision of linear counting; the
    t-digest's 0.9-quantile within 1% rank (plus one row) of the group's
    values."""
    r = data["r"]
    keys = np.unique(r)
    equal(out["r"], keys, f"{what} keys")
    slot = np.searchsorted(keys, r)
    xv = ~np.ma.getmaskarray(data["x"])
    _, nd, _ = _distinct_pairs(slot[xv], np.ma.getdata(data["x"])[xv])
    has_x = np.bincount(slot[xv], minlength=keys.size) > 0
    exact = np.zeros(keys.size, np.int64)
    exact[has_x] = nd
    from hdk_tpu_torch.ops import sketches

    g = executor.config.exec.group_by
    cap = executor._groupby_cap
    p = sketches.effective_hll_p(g.hll_precision, cap, g.hll_register_budget)
    bound = 4 * 1.04 / np.sqrt(1 << p)
    est = out["hll_x"]
    rel = np.abs(est - exact) / np.maximum(exact, 1)
    check(np.all(np.abs(est - exact) <= bound * exact + 1),
          f"{what} HLL beyond its error bound (max rel {rel.max()})")
    yv = ~np.ma.getmaskarray(data["y"])
    y = np.ma.getdata(data["y"])
    order = np.lexsort((y[yv], slot[yv]))
    sid, sv = slot[yv][order], y[yv][order]
    starts, cnt = _spans(sid)
    worst = 0.0
    qv = np.ma.getdata(out["td_y"])
    for gi, st, n in zip(sid[starts], starts, cnt):
        vals = sv[st:st + n]
        lo = np.searchsorted(vals, qv[gi], "left") / n
        hi = np.searchsorted(vals, qv[gi], "right") / n
        err = 0.0 if lo <= 0.9 <= hi else min(abs(lo - 0.9), abs(hi - 0.9))
        check(err <= 0.01 + 1.0 / n,
              f"{what} t-digest group {gi}: rank error {err}")
        worst = max(worst, err)
    log(f"{what}: HLL p={p} max rel err {rel.max()!r} (bound "
        f"{bound!r}); t-digest max rank err {worst!r} over {keys.size} "
        f"groups")


# slots of each kernel's headline case in the kernels line
REPORTED_SLOTS = {"count_hist": None, "groupby_sums2": "bool",
                  "seg_sums_exact": "int64", "groupby_sums": "float64"}

REPLACES = {
    "count_hist": "hdk_tpu/ops/pallas_hist2.py:89",
    "groupby_sums2": "hdk_tpu/ops/pallas_groupby.py:180",
    "seg_sums_exact": "hdk_tpu/ops/pallas_hist.py:136",
    "groupby_sums": "hdk_tpu/ops/pallas_groupby.py:72",
}


def main() -> None:
    # phase 1: device
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs one CUDA card")
    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"device count {torch.cuda.device_count()}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hdk_tpu_torch
    from hdk_tpu_torch.kernels import build, hist

    check("jax" not in sys.modules, "jax was imported")
    hdk = hdk_tpu_torch.HDK(device="cuda")
    log(f"session device: {hdk.device}")

    # phase 2: build
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    taxi = gen_taxi(TAXI_ROWS)
    log(f"taxi data: {TAXI_ROWS} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 3: kernels against their plain versions; the group-by hands
    # them entry_count + 1 segments (the last one discards dead rows)
    entries = (11, 12, taxi_q4_entries(taxi) + 1, 65536)
    # HN1's group buffer: 50M keys + a NULL slot, + the discard segment;
    # K1 alone at TPC-H Q1's (6 groups) and taxi Q2's (9 groups) layouts
    report = kernel_phase(hist, entries, (HIGH_NDV_KEYS + 2,), card,
                          k1_shapes=K1_SHAPES)
    torch.cuda.empty_cache()

    # phase 4: the main path; counters count its launches only
    log("sizes cut: taxi 100M rows of the reference's 1.1B and TPC-H "
        "lineitem SF10 (60M rows) of its SF100, for host-side data "
        "generation time and host RAM")
    hist.reset_launches()
    taxi_phase(hdk_tpu_torch, hdk, taxi, card, hist)
    del taxi
    tpch_phase(hdk_tpu_torch, hdk, card, hist)
    nulls_phase(hdk, card, hist)
    launches = hist.launches()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    # phases 5-6: the sort route, its launches counted apart
    torch.cuda.empty_cache()
    hist.reset_launches()
    with EntryRecorder(hist) as recorder:
        high_ndv_phase(hdk, card, hist)
        holistic_phase(hdk_tpu_torch, hdk, card, hist)
    sort_launches = hist.launches()
    for name, n in sort_launches.items():
        check(n > 0, f"kernel {name} never launched on the sort route")
        log(f"sort route: kernel {name} launches={n} "
            f"largest_E={recorder.max_e[name]}")
    check("jax" not in sys.modules, "jax was imported")
    check("pandas" not in sys.modules, "pandas was imported")

    kernels = []
    for name, rec in report.items():
        # the headline case: taxi Q4's segment count, the kernel's widest
        # slots that one library call also computes
        kind = REPORTED_SLOTS[name]
        q4 = next(c for c in rec["cases"]
                  if c["E"] == entries[2] and c["slots"] == kind)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "hdk_tpu_torch/csrc/hist.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": q4["ms"],
            "plain_ms": q4["plain_ms"], "bound_ms": q4["bound_ms"],
            "bound_by": "bytes", "library_ms": q4["library_ms"],
            "shape": f"N={q4['N']} E={q4['E']} slots={kind}",
            "sort_route_launches": sort_launches[name],
            "sort_route_largest_E": recorder.max_e[name],
            "cases": rec["cases"],
        })
    print(card)  # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
