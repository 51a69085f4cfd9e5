#!/usr/bin/env python
"""TPC-H Q3's stages on hdk_tpu_torch: warm times of its sub-plans and of
both plan variants (the eager-aggregation rewrite and the original), in
one session (the port's twin of tools/q3_stages.py).

    python tools/q3_stages_torch.py [--scale 1.0]
    python tools/q3_stages_torch.py --device cpu --scale 0.001

Data and query: bench_suite_torch.py's tpch3 config (seed 23); route
feedback off, so each stage keeps one route.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_suite_torch as suite  # noqa: E402
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.utils import benchtime  # noqa: E402

DATE = "TIMESTAMP '1995-03-15 00:00:00'"
STAGES = {
    # the pre-aggregate alone (the root's materialization pays the trim)
    "preagg": ("SELECT l_orderkey, "
               "SUM(l_extendedprice * (1 - l_discount)) AS r "
               f"FROM lineitem3 WHERE l_shipdate > {DATE} "
               "GROUP BY l_orderkey"),
    # the dimension join alone
    "ord_cust": ("SELECT COUNT(*), MAX(o_orderdate) FROM customer3, "
                 "orders3 WHERE c_mktsegment = 'BUILDING' "
                 "AND c_custkey = o_custkey "
                 f"AND o_orderdate < {DATE}"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    hdk = hdk_tpu_torch.HDK(device=args.device,  # raises without a card
                            **{"exec.enable_route_feedback": False})
    suite.import_tables(hdk, suite.tpch_q3_tables(args.scale))

    def timed(sql, label):
        m = benchtime.measure(lambda: hdk.sql(sql), warmup=2, iters=4,
                              latency_iters=1)
        print(f"{label}: warm {m['throughput_s']:.4f}s latency "
              f"{m['latency_s']:.4f}s", flush=True)

    for label, sql in {**STAGES, "q3": suite.TPCH_Q3}.items():
        timed(sql, label)
    # the original (no-rewrite) variant
    hdk.config.exec.enable_eager_aggregation = False
    timed(suite.TPCH_Q3, "q3_original_plan")


if __name__ == "__main__":
    main()
