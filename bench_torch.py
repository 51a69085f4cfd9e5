#!/usr/bin/env python
"""Taxi Q1-Q4 on hdk_tpu_torch: the headline benchmark line of the port.

    python bench_torch.py                  # 10M rows on the CUDA card
    BENCH_ROWS=100000000 python bench_torch.py
    python bench_torch.py --device cpu     # the plain versions, on the CPU

Queries (reference: omniscidb/Benchmarks/taxi/taxi_reduced_bench.cpp:52-84):
  Q1: SELECT cab_type, count(*) GROUP BY cab_type
  Q2: SELECT passenger_count, avg(total_amount) GROUP BY passenger_count
  Q3: SELECT passenger_count, extract(year from pickup_datetime), count(*)
      GROUP BY 1, 2
  Q4: SELECT passenger_count, year, cast(trip_distance as int), count(*)
      GROUP BY 1, 2, 3 ORDER BY count(*) DESC

The data is the JAX package's bench (seed 7).  Each query runs in a
fresh process of its own (``--one``); ``BENCH_ISOLATED=0`` measures all
four in this process.  After its timed runs each query's result is held
against its numpy oracle (``bench_common_torch.taxi_check``), and the
record counts the kernel launches of the timed runs (``launches``).  A
query process that fails, or a result that differs, fails the run: the
query's name, exit code and the end of its errors go to the exit
message.

The baseline runs the same queries on the same host: pandas where it
imports, else the numpy oracles (``baseline_oracle`` says which), cached
per (oracle, rows) under ``--out-dir`` (default ``bench_torch_out/``).
vs_baseline = the port's geomean rows/s over the four queries / the
baseline's.

Prints ONE JSON line with the keys ``RECORD_KEYS`` (bench.py's, then
the port's); ``card`` is the card's name and power limit as nvidia-smi
gives them ("cpu" on the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import bench_common_torch as common  # noqa: E402
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.kernels import hist  # noqa: E402
from hdk_tpu_torch.utils import benchtime  # noqa: E402

QUERIES = ("q1", "q2", "q3", "q4")
RECORD_KEYS = ("metric", "value", "unit", "vs_baseline",
               "detail_Mrows_per_sec", "detail_latency_ms", "detail_seconds",
               "baseline_oracle", "baseline_cached", "baseline_Mrows_per_sec",
               "timing", "rows", "mode", "device", "card", "launches",
               "result_check")
TIMING = ("pipelined_throughput (latency in detail_latency_ms; the "
          "baseline is synchronous, so its latency IS its throughput; "
          "see hdk_tpu_torch/utils/benchtime.py)")


def gen_data(rows: int):
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


def pandas_suite(data):
    import pandas as pd

    df = pd.DataFrame(data)
    ts = pd.to_datetime(df["pickup_datetime"], unit="s")

    def q1():
        return df.groupby("cab_type").size()

    def q2():
        return df.groupby("passenger_count")["total_amount"].mean()

    def q3():
        return df.groupby(["passenger_count", ts.dt.year]).size()

    def q4():
        g = df.groupby(["passenger_count", ts.dt.year,
                        df["trip_distance"].astype(np.int32)]).size()
        return g.sort_values(ascending=False)

    return {"q1": q1, "q2": q2, "q3": q3, "q4": q4}


def engine_suite(hdk, data, types=None):
    """The four queries through the port's builder calls on ``hdk``
    (``types``: the session package's types module, the port's by
    default)."""
    t = types or hdk_tpu_torch.types
    ht = hdk.import_pydict(
        dict(data), name="trips",
        schema={"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})

    def q1():
        return ht.agg("cab_type", "count").run()

    def q2():
        return ht.agg("passenger_count", "avg(total_amount)").run()

    def q3():
        return ht.agg(
            ["passenger_count", ht["pickup_datetime"].extract("year").name("y")],
            "count").run()

    def q4():
        return ht.agg(
            ["passenger_count", ht["pickup_datetime"].extract("year").name("y"),
             ht["trip_distance"].cast("int32").name("dist")],
            "count").sort(("count", "desc")).run()

    return {"q1": q1, "q2": q2, "q3": q3, "q4": q4}


def measure(suite, rows: int):
    """Per-query latency and throughput (a plain callable's result is
    ready when it returns)."""
    out = {}
    for name, fn in suite.items():
        m = benchtime.measure(fn)
        out[name] = {"seconds": m["throughput_s"],
                     "latency_seconds": m["latency_s"],
                     "rows_per_sec": rows / m["throughput_s"]}
    return out


def measure_engine(suite, data, rows: int):
    """``measure`` of engine queries, then each result against its numpy
    oracle (outside the timing; a difference raises).  Returns the
    measurements and the kernel launches of the timed runs."""
    hist.reset_launches()
    out = measure(suite, rows)
    launches = hist.launches()
    for name, fn in suite.items():
        common.taxi_check(name, fn().to_numpy(), data)
    return out, launches


def geomean(vals):
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def load_or_measure_baseline(data, rows: int, out_dir: str):
    """The baseline's record, measured here or read from this host's
    cache (``out_dir``/baseline_<oracle>_<rows>.json)."""
    try:
        suite, oracle = pandas_suite(data), "pandas"
    except ImportError:
        suite, oracle = common.taxi_oracle(data), "numpy"
    path = os.path.join(out_dir, f"baseline_{oracle}_{rows}.json")
    if os.path.exists(path):
        with open(path) as f:
            return {**json.load(f), "cached": True}
    res = measure(suite, rows)
    rec = {"oracle": oracle, "rows": rows, "queries": res,
           "geomean_rows_per_sec": geomean(
               [q["rows_per_sec"] for q in res.values()])}
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return {**rec, "cached": False}


def run_one_query(name: str, rows: int, device: str) -> dict:
    """Measure and check ONE engine query in this process."""
    data = gen_data(rows)
    suite = engine_suite(hdk_tpu_torch.HDK(device=device), data)
    res, launches = measure_engine({name: suite[name]}, data, rows)
    return {"query": name, **res[name], "launches": launches}


def measure_engine_isolated(rows: int, device: str):
    """One fresh process per query: each query pays its own session,
    transfers and builds, and none inherits another's caches or device
    memory.  A process that fails ends the run (SystemExit naming the
    query, its exit code and the end of its errors)."""
    out, launches = {}, {}
    for name in QUERIES:
        rec = common.run_child(
            [os.path.abspath(__file__), "--one", name, "--device", device],
            f"bench_torch: query {name}", {"BENCH_ROWS": str(rows)},
            timeout=1800)[-1]
        for k, n in rec.pop("launches").items():
            launches[k] = launches.get(k, 0) + n
        out[rec.pop("query")] = rec
    return out, launches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--one", choices=QUERIES,
                    help="(internal) measure one query in this process")
    ap.add_argument("--out-dir", default=os.path.join(ROOT,
                                                      "bench_torch_out"))
    args = ap.parse_args(argv)
    rows = int(os.environ.get("BENCH_ROWS", "10000000"))
    common.require_card(args.device, "bench_torch")
    if args.one:
        print(json.dumps(run_one_query(args.one, rows, args.device)))
        return
    card = common.card_line(args.device)
    data = gen_data(rows)
    baseline = load_or_measure_baseline(data, rows, args.out_dir)
    isolated = os.environ.get("BENCH_ISOLATED", "1") != "0"
    if isolated:
        ours, launches = measure_engine_isolated(rows, args.device)
    else:
        ours, launches = measure_engine(
            engine_suite(hdk_tpu_torch.HDK(device=args.device), data), data,
            rows)
    value = geomean([q["rows_per_sec"] for q in ours.values()])
    vs = value / baseline["geomean_rows_per_sec"]
    rec = {
        "metric": "taxi_q1q4_geomean_rows_per_sec",
        "value": value,
        "unit": "rows/s",
        "vs_baseline": vs,
        "detail_Mrows_per_sec": {n: q["rows_per_sec"] / 1e6
                                 for n, q in ours.items()},
        "detail_latency_ms": {n: q["latency_seconds"] * 1e3
                              for n, q in ours.items()},
        "detail_seconds": {n: q["seconds"] for n, q in ours.items()},
        "baseline_oracle": baseline["oracle"],
        "baseline_cached": baseline["cached"],
        "baseline_Mrows_per_sec": {
            n: q["rows_per_sec"] / 1e6
            for n, q in baseline["queries"].items()},
        "timing": TIMING,
        "rows": rows,
        "mode": "isolated" if isolated else "in_process",
        "device": args.device,
        "card": card,
        "launches": launches,
        "result_check": "numpy",
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
