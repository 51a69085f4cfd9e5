#!/usr/bin/env python
"""The NDV sample's share of a high-NDV GROUP BY on hdk_tpu_torch (the
port's twin of tools/ndv_overhead.py).

The sort route sizes its group buffer from a Chao84 estimate over a
strided sample, one of the few host round trips of a query; this records
its cost (``Executor._ndv_sample_seconds``) cold and warm, beside the
query's own time.

    NDV_ROWS=100000000 python tools/ndv_overhead_torch.py    # the card
    NDV_ROWS=100000 python tools/ndv_overhead_torch.py --device cpu

Data: seed 5, NDV_ROWS rows (default 100M) of hashed unbounded keys.
Prints one JSON line and writes it to ``--out`` (default
``bench_torch_out/ndv_overhead.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.utils import benchtime  # noqa: E402

# the keys of the record
RECORD_KEYS = ("rows", "device", "cold_seconds", "cold_sample_seconds",
               "warm_query_seconds", "warm_latency_seconds",
               "warm_sample_seconds_per_query",
               "sample_fraction_of_warm_query", "attempts", "ndv_estimate")


def gen_data(rows: int):
    rng = np.random.default_rng(5)
    # unbounded keys (hashed): the NDV sampler is on the hot path
    k = rng.integers(0, rows // 2, rows).astype(np.int64) * 2654435761 % (
        1 << 62)
    return {"k": k, "v": rng.integers(0, 1000, rows)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "bench_torch_out", "ndv_overhead.json"))
    args = ap.parse_args(argv)
    rows = int(os.environ.get("NDV_ROWS", "100000000"))
    hdk = hdk_tpu_torch.HDK(device=args.device)  # raises without a card
    t = hdk.import_pydict(gen_data(rows), name="ndv_ovh")
    ex = hdk._executor

    def q():
        return t.agg("k", "count", "sum(v)").run()

    # cold: the sample's first pull, the transfer, the route's set-up
    s0 = ex._ndv_sample_seconds
    t0 = time.perf_counter()
    benchtime.sync(q())
    cold = time.perf_counter() - t0
    cold_sample = ex._ndv_sample_seconds - s0

    # warm: the estimator's cost per run beside the query's
    s0 = ex._ndv_sample_seconds
    m = benchtime.measure(q, warmup=1, iters=3)
    runs = 1 + 5 + 3  # measure's warm-up, latency and throughput calls
    warm_sample = (ex._ndv_sample_seconds - s0) / runs
    out = {
        "rows": rows,
        "device": args.device,
        "cold_seconds": cold,
        "cold_sample_seconds": cold_sample,
        "warm_query_seconds": m["throughput_s"],
        "warm_latency_seconds": m["latency_s"],
        "warm_sample_seconds_per_query": warm_sample,
        "sample_fraction_of_warm_query": warm_sample / m["throughput_s"],
        "attempts": ex._groupby_attempts,
        "ndv_estimate": ex._ndv_estimate,
    }
    print(json.dumps(out))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
