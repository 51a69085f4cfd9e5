#!/usr/bin/env python
"""Tour of hdk_tpu_torch's features beyond the taxi demo: UDFs with torch
bodies, window frames, arrays + UNNEST, GROUPING SETS, spill, EXPLAIN
(the twin of examples/features_demo.py).

    python examples/features_demo_torch.py             # on the CUDA card
    python examples/features_demo_torch.py --device cpu --rows 10000
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch import types as t  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=100_000,
                    help="a multiple of 1000")
    args = ap.parse_args(argv)
    hdk = hdk_tpu_torch.init(device=args.device)
    rng = np.random.default_rng(0)
    n = args.rows
    trips = hdk.import_pydict({
        "cab": rng.integers(0, 3, n, dtype=np.int8),
        "fare": np.round(rng.gamma(2.0, 8.0, n), 2),
        "tip": np.round(rng.gamma(1.0, 2.0, n), 2),
        "stops": [list(rng.integers(0, 50, rng.integers(0, 4)))
                  for _ in range(1000)] * (n // 1000),
    }, name="trips")

    # --- UDF: a torch body on the session's device ---------------------
    hdk.register_udf("tip_rate",
                     lambda tip, fare: tip / torch.clamp(fare, min=1.0),
                     arg_types=[t.fp64(), t.fp64()], ret_type=t.fp64())
    print(hdk.sql(
        "SELECT cab, AVG(tip_rate(tip, fare)) AS r FROM trips "
        "GROUP BY cab ORDER BY r DESC").to_pandas())

    # --- window frames ------------------------------------------------
    print(hdk.sql(
        "SELECT cab, fare, AVG(fare) OVER (PARTITION BY cab ORDER BY fare "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma3 "
        "FROM trips LIMIT 5").to_pandas())

    # --- arrays: cardinality + unnest ---------------------------------
    print(trips.proj(ns=trips["stops"].cardinality())
          .agg("ns", "count").run().to_pandas())
    print(trips.unnest("stops").agg("stops", "count")
          .sort(("count", "desc"), limit=5).run().to_pandas())

    # --- GROUPING SETS ------------------------------------------------
    print(hdk.sql(
        "SELECT cab, COUNT(*) AS c FROM trips GROUP BY ROLLUP(cab) "
        "ORDER BY c").to_pandas())

    # --- result chaining + explicit spill ------------------------------
    res = trips.agg("cab", "count", "sum(fare)").run()
    res.offload()  # host memory; reloads on the next use
    sc = res.scan
    print(sc.filter(sc["count"] > 10).run().to_pandas())

    # --- plan inspection -----------------------------------------------
    print(hdk.explain(
        "SELECT cab, COUNT(*) FROM trips WHERE fare > 30 GROUP BY cab"))


if __name__ == "__main__":
    main()
