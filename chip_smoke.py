#!/usr/bin/env python3
"""Smoke run of hdk_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. device: the card's name and power limit, torch and CUDA versions;
     exits non-zero when CUDA is not available;
  2. build: compiles the CUDA kernels from hdk_tpu_torch/csrc;
  3. kernels: each histogram kernel against its plain PyTorch version on
     the card, at 100M rows and the main path's segment counts;
  4. the main path through the public entry points: taxi Q1-Q4 (builder
     API, 100M rows), TPC-H Q1/Q6 (SQL, 60M lineitem rows) and a NULL-heavy
     GROUP BY (SQL, 10M rows), each checked against a numpy oracle and
     required to have run its histogram kernels.
The line before the last is a JSON object with the per-kernel results;
the last line is {"ok": true, "device": {...}}.  Any failure raises, so
the script exits non-zero and prints no result.  Needs numpy and torch;
imports neither jax, pandas nor pyarrow.
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
KERNEL_ROWS = 100_000_000
REPEATS = 5


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

def kernel_phase(hist, entries, card):
    """Every kernel against its plain version at KERNEL_ROWS rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n = KERNEL_ROWS
    slots = {
        "bool": torch.rand((n, 2), device=dev, generator=gen) < 0.9,
        "int8": torch.randint(1, 51, (n, 1), device=dev, generator=gen,
                              dtype=torch.int8),
        "int64": torch.randint(-10**12, 10**12, (n, 1), device=dev,
                               generator=gen, dtype=torch.int64),
        "float32": torch.rand((n, 1), device=dev, generator=gen,
                              dtype=torch.float32) * 100,
        # positive, like prices: sums without cancellation, so a relative
        # tolerance bounds the error of the summation order alone
        "float64": torch.rand((n, 4), device=dev, generator=gen,
                              dtype=torch.float64) * 1e4,
    }
    cases = [
        ("count_hist", None, lambda g, v, e: hist.count_hist(g, e),
         lambda g, v, e: hist.count_hist_ref(g, e)),
        ("groupby_sums2", "bool", hist.groupby_sums2, hist.groupby_sums2_ref),
        ("seg_sums_exact", "int8", hist.seg_sums_exact,
         hist.seg_sums_exact_ref),
        ("seg_sums_exact", "int64", hist.seg_sums_exact,
         hist.seg_sums_exact_ref),
        ("groupby_sums", "float32", hist.groupby_sums, hist.groupby_sums_ref),
        ("groupby_sums", "float64", hist.groupby_sums, hist.groupby_sums_ref),
    ]
    report = {}
    for e in entries:
        # gids beyond both ends: those rows must drop out
        gid = torch.randint(-2, e + 2, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        for name, kind, kern, ref in cases:
            v = slots[kind] if kind else None
            got = kern(gid, v, e)
            want = ref(gid, v, e)
            torch.cuda.synchronize()
            if got.dtype.is_floating_point:
                err = float((got - want).abs().max())
                ok = torch.allclose(got, want, rtol=1e-10, atol=0.0)
                tol = "rtol 1e-10 (atomic float order varies)"
            else:
                err = float((got - want).abs().max())
                ok = bool(torch.equal(got, want))
                tol = "exact"
            check(ok, f"{name}[{kind}] E={e}: kernel disagrees "
                      f"(max abs err {err})")
            ms = cuda_ms(lambda: kern(gid, v, e))
            plain_ms = cuda_ms(lambda: ref(gid, v, e))
            log(f"kernel {name:15s} slots={kind or '-':8s} N={n} E={e:6d} "
                f"ok ({tol}) max_abs_err={err!r} kernel_ms={ms!r} "
                f"plain_ms={plain_ms!r} [{card}]")
            rec = report.setdefault(name, {"max_abs_err": 0.0, "cases": []})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["cases"].append({"slots": kind, "E": e, "ms": ms,
                                 "plain_ms": plain_ms})
        del gid
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
        torch.cuda.synchronize()
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

    import bench  # numpy-only at module level

    t0 = time.perf_counter()
    taxi = bench.gen_data(TAXI_ROWS)
    log(f"taxi data: {TAXI_ROWS} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 3: kernels against their plain versions; the group-by hands
    # them entry_count + 1 segments (the last one discards dead rows)
    entries = (11, 12, taxi_q4_entries(taxi) + 1, 65536)
    report = kernel_phase(hist, entries, card)
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
    check("jax" not in sys.modules, "jax was imported")

    kernels = []
    for name, rec in report.items():
        # ms / plain_ms at the taxi Q4 segment count, first slot dtype
        q4 = next(c for c in rec["cases"] if c["E"] == entries[2])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "hdk_tpu_torch/csrc/hist.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": q4["ms"],
            "plain_ms": q4["plain_ms"],
            "shape": f"N={KERNEL_ROWS} E={q4['E']} slots={q4['slots']}",
        })
    print(card)  # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
