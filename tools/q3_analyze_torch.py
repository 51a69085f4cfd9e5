#!/usr/bin/env python
"""TPC-H Q3 on hdk_tpu_torch, run by run: wall time, code-cache builds,
the plan variants measured so far and the NDV sample's seconds, then
EXPLAIN ANALYZE's step breakdown (the port's twin of
tools/q3_analyze.py).

    python tools/q3_analyze_torch.py [--scale 1.0] [--runs 8] [--no-analyze]
    python tools/q3_analyze_torch.py --device cpu --scale 0.001

Data and query: bench_suite_torch.py's tpch3 config (seed 23).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_suite_torch as suite  # noqa: E402
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.utils import benchtime  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--no-analyze", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    hdk = hdk_tpu_torch.HDK(device=args.device)  # raises without a card
    ex = hdk._executor
    suite.import_tables(hdk, suite.tpch_q3_tables(args.scale))

    for i in range(args.runs):
        b0 = ex.code_cache.misses
        t0 = time.perf_counter()
        benchtime.sync(hdk.sql(suite.TPCH_Q3))
        secs = time.perf_counter() - t0
        variants = sorted({v for (_s, v) in ex._plan_feedback._fb._t})
        print(f"run {i}: {secs:.4f}s  builds+{ex.code_cache.misses - b0} "
              f"measured_variants={variants} "
              f"ndv_sample={ex._ndv_sample_seconds:.4f}s", flush=True)
    if not args.no_analyze:
        print("\n=== EXPLAIN ANALYZE ===", flush=True)
        print(hdk.explain(suite.TPCH_Q3, analyze=True), flush=True)


if __name__ == "__main__":
    main()
