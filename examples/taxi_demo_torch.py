#!/usr/bin/env python
"""NYC-taxi demo on hdk_tpu_torch, the PyTorch/CUDA port: the twin of
examples/taxi_demo.py (the reference's examples/heterogen_demo_taxi.ipynb),
the same queries on a CUDA card.

Run with a CSV of taxi trips, or none for synthetic rows:

    python examples/taxi_demo_torch.py [trips.csv]
    python examples/taxi_demo_torch.py --device cpu --rows 10000
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import hdk_tpu_torch  # noqa: E402


def load(hdk, csv, rows):
    if csv:
        return hdk.import_csv(csv, name="trips")
    rng = np.random.default_rng(0)
    year = 365 * 86400
    print(f"(no CSV given: generating {rows:,} synthetic rows)")
    return hdk.import_pydict({
        "cab_type": rng.integers(0, 2, rows, dtype=np.int8),
        "passenger_count": rng.integers(0, 9, rows, dtype=np.int8),
        "total_amount": rng.gamma(2.0, 8.0, rows).astype(np.float32),
        "trip_distance": rng.gamma(1.5, 2.5, rows).astype(np.float32),
        "pickup_datetime": np.int64(1356998400)
        + rng.integers(0, 4 * year, rows),
    }, name="trips", schema={
        "pickup_datetime": hdk_tpu_torch.types.timestamp(
            hdk_tpu_torch.types.TimeUnit.SECOND, False)})


def show(title, res, seconds):
    print(f"\n== {title}  ({seconds * 1e3:.1f} ms)")
    print(res.to_pandas().head(10).to_string())


QUERIES = {
    "Q1: count by cab_type":
        "SELECT cab_type, COUNT(*) FROM trips GROUP BY cab_type",
    "Q2: avg fare by passengers":
        "SELECT passenger_count, AVG(total_amount) FROM trips "
        "GROUP BY passenger_count",
    "Q3: counts by passengers x year":
        "SELECT passenger_count, EXTRACT(year FROM pickup_datetime) AS y,"
        " COUNT(*) FROM trips GROUP BY passenger_count, y",
    "Q4: top groups by count":
        "SELECT passenger_count, EXTRACT(year FROM pickup_datetime) AS y,"
        " CAST(trip_distance AS int) AS dist, COUNT(*) AS c FROM trips "
        "GROUP BY passenger_count, y, dist ORDER BY c DESC LIMIT 10",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("csv", nargs="?")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    hdk = hdk_tpu_torch.init(device=args.device)
    load(hdk, args.csv, args.rows)

    for title, sql in QUERIES.items():
        hdk.sql(sql).block()  # the first run pays transfers and set-up
        t0 = time.perf_counter()
        res = hdk.sql(sql).block()
        show(title, res, time.perf_counter() - t0)

    # builder-API flavor: a GROUP BY, then a window function over it
    t = hdk.scan("trips")
    top = t.agg(["passenger_count"], "count", "avg(total_amount)").run().scan
    ranked = top.proj(
        "passenger_count", "count",
        rank=hdk.rank().over().order_by((top["count"], "desc")))
    print("\n== builder API: rank by count")
    print(ranked.run().to_pandas().head(10).to_string())

    print("\n== plan for Q1")
    print(hdk.sql("EXPLAIN " + QUERIES["Q1: count by cab_type"]))


if __name__ == "__main__":
    main()
