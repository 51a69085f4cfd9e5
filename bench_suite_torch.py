#!/usr/bin/env python
"""The north-star configs on hdk_tpu_torch (the port's twin of the JAX
package's bench_suite.py).

  join:    trips x payments on an int64 key (100M x 10M at scale 1)
  zipf:    the same join with zipf(1.3) probe keys
  groupby: high-cardinality group-by (100M rows, 50M possible keys), and
           the same count sorted descending, LIMIT 100
  tpch:    TPC-H Q1/Q6 shapes over 60M lineitem rows (SF10)
  tpch3:   TPC-H Q3 shape (1.5M customers, 15M orders, 60M lineitem rows)

    python bench_suite_torch.py --scale 1.0      # on the CUDA card
    python bench_suite_torch.py --device cpu --scale 0.001

Data, seeds and sizes are the JAX package's; ``--scale`` (default 0.1)
multiplies every row count.  Each config runs in a fresh process of its
own; a config whose process fails fails the run.  Each record
(``RECORD_KEYS``) has rows/s (probe rows for a join), the cold/warm
split, the median and min of three warm samples, the builds (0: the
port compiles no step), ``bytes_ideal``'s share of the card's memory
rate and the kernel launches of the timed runs.  After them the query's
result is held against its numpy oracle (``bench_common_torch``) at the
size it was timed; a difference fails the config.  The records go to stdout, one
JSON line each, and together to ``--out`` (default
``bench_torch_out/bench_suite.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import bench_common_torch as common  # noqa: E402
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.kernels import hist  # noqa: E402
from hdk_tpu_torch.utils import benchtime  # noqa: E402

CONFIGS = ("join", "zipf", "groupby", "tpch", "tpch3")
RECORD_KEYS = ("config", "seconds", "seconds_min", "seconds_samples",
               "latency_seconds", "cold_seconds", "jit_builds",
               "warm_builds", "bytes_ideal", "roofline_frac_ideal",
               "launches", "result_check", "Mrows_per_sec", "card")

# H100 SXM device memory, NVIDIA's data sheet: the rate roofline_frac_ideal
# divides by
HBM_BYTES_PER_SEC = 3.35e12

TS_SECONDS = {"lineitem": "l_shipdate", "orders3": "o_orderdate",
              "lineitem3": "l_shipdate"}


def schema(types, table: str):
    """Declared types of a table: its timestamps are in seconds."""
    if table not in TS_SECONDS:
        return None
    return {TS_SECONDS[table]: types.timestamp(types.TimeUnit.SECOND, False)}


def import_tables(hdk, tables: dict, types=None) -> None:
    """``tables`` into ``hdk``, typed with ``types`` (the port's types
    module by default)."""
    types = types or hdk_tpu_torch.types
    for name, data in tables.items():
        hdk.import_pydict(data, name=name, schema=schema(types, name))


def bench_query(fn, hdk, iters=3, warmup=1):
    """Cold/warm split and the spread of repetitions:

    * ``cold_seconds`` -- the first synced execution (route probes, NDV
      samples, join builds, transfers; the kernels are built before);
    * ``seconds`` / ``seconds_min`` -- median/min of 3 warm throughput
      samples (hdk_tpu_torch.utils.benchtime), all in ``seconds_samples``;
      ``latency_seconds`` the median of their synced latencies;
    * ``jit_builds`` / ``warm_builds`` -- 0: the JAX package's record
      counts its jit builds there, and the port runs eagerly, compiling
      no step.
    """
    t0 = time.perf_counter()
    benchtime.sync(fn())
    cold = time.perf_counter() - t0
    runs = [benchtime.measure(fn, warmup=warmup, iters=max(iters, 3))
            for _ in range(3)]
    samples = sorted(float(m["throughput_s"]) for m in runs)
    lat = sorted(float(m["latency_s"]) for m in runs)
    return {
        "seconds": samples[1],
        "seconds_min": samples[0],
        "seconds_samples": samples,
        "latency_seconds": lat[1],
        "cold_seconds": cold,
        "jit_builds": 0,
        "warm_builds": 0,
    }


def _rec(config: str, rows: int, m: dict, bytes_ideal: float) -> dict:
    """``bytes_ideal``: the least device-memory traffic of the operator
    (every input byte read once, the result written once);
    ``roofline_frac_ideal`` is its time at the card's memory rate over
    the measured seconds.  The JAX package's ``bytes_algo`` and
    ``_bitonic_bytes`` are left out: they model the TPU's bitonic sort
    network, and the port sorts with ``torch.sort``."""
    return {"config": config, "rows_per_sec": rows / m["seconds"], **m,
            "bytes_ideal": int(bytes_ideal),
            "roofline_frac_ideal":
                (bytes_ideal / HBM_BYTES_PER_SEC) / m["seconds"]}


# -- configs: tables (name -> numpy columns) and queries --------------------
# Each ``*_queries(hdk, scale)`` returns [(config label, query, rows,
# bytes_ideal)] over tables already imported into ``hdk``.

def join_tables(scale: float, seed: int = 11):
    """trips x payments (seed 11); seed 17: zipf(1.3) probe keys, a few
    build rows receiving ~30% of all probes, clipped into range."""
    n_probe = int(100_000_000 * scale)
    n_build = int(10_000_000 * scale)
    rng = np.random.default_rng(seed)
    if seed == 17:
        k = np.minimum(rng.zipf(1.3, n_probe), n_build).astype(np.int64) - 1
    else:
        k = rng.integers(0, n_build, n_probe)
    sfx = "z" if seed == 17 else "j"
    return {f"trips_{sfx}": {
                "k": k,
                "amt": rng.gamma(2.0, 10.0, n_probe).astype(np.float32)},
            f"payments_{sfx}": {
                "k": rng.permutation(n_build),
                "fee": rng.gamma(1.0, 2.0, n_build).astype(np.float32)}}


def join_queries(hdk, scale: float, zipf: bool = False):
    n_probe = int(100_000_000 * scale)
    n_build = int(10_000_000 * scale)
    sfx = "z" if zipf else "j"
    t = hdk.scan(f"trips_{sfx}")
    p = hdk.scan(f"payments_{sfx}")

    def q():
        return t.join(p, "k", "k").agg([], "count", "sum(fee)").run()

    label = (f"zipf_join {n_probe}x{n_build} a=1.3 skew" if zipf
             else f"join {n_probe}x{n_build} int64 key")
    # probe keys once + the build's key and fee
    return [(label, q, n_probe, 8 * n_probe + 12 * n_build)]


def high_ndv_tables(scale: float):
    n = int(100_000_000 * scale)
    ndv = int(50_000_000 * scale)
    rng = np.random.default_rng(12)
    return {"ndv_t": {"k": rng.integers(0, ndv, n),
                      "v": rng.integers(0, 1000, n)}}


def high_ndv_queries(hdk, scale: float):
    n = int(100_000_000 * scale)
    ndv = int(50_000_000 * scale)
    t = hdk.scan("ndv_t")

    def q():
        return t.agg("k", "count", "sum(v)").run()

    def q_sorted():
        return t.agg("k", "count").sort(("count", "desc"), limit=100).run()

    # (k, v) read once; three result columns at NDV entries (or 100)
    return [(f"groupby {n} rows ~{ndv} distinct keys", q, n,
             16 * n + 24 * ndv),
            (f"groupby+top100 {n} rows ~{ndv} keys", q_sorted, n,
             16 * n + 24 * 100)]


def lineitem_tables(scale: float):
    rows = int(60_000_000 * scale)  # SF10-size lineitem at scale 1
    rng = np.random.default_rng(13)
    year_secs = 365 * 86400
    ship = np.int64(694224000) + rng.integers(0, 7 * year_secs, rows)
    return {"lineitem": {
        "l_quantity": rng.integers(1, 51, rows).astype(np.int8),
        "l_extendedprice": (rng.gamma(3.0, 12000.0, rows)).astype(np.float64),
        "l_discount": np.round(rng.uniform(0.0, 0.1, rows), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, rows), 2),
        "l_returnflag": rng.integers(0, 3, rows).astype(np.int8),
        "l_linestatus": rng.integers(0, 2, rows).astype(np.int8),
        "l_shipdate": ship,
    }}


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


def tpch_queries(hdk, scale: float):
    rows = int(60_000_000 * scale)
    # Q1: a multi-aggregate GROUP BY under a date filter; Q6: a selective
    # filter under a scalar aggregate
    return [(f"tpch_q1 {rows} rows", lambda: hdk.sql(TPCH_Q1), rows,
             35 * rows),
            (f"tpch_q6 {rows} rows", lambda: hdk.sql(TPCH_Q6), rows,
             25 * rows)]


def tpch_q3_tables(scale: float):
    """TPC-H Q3's three tables (seed 23): 1.5M customers, 15M orders and
    60M lineitem rows at scale 1 (~SF10)."""
    n_cust = int(1_500_000 * scale)
    n_ord = int(15_000_000 * scale)
    n_li = int(60_000_000 * scale)
    rng = np.random.default_rng(23)
    seg = np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                      "MACHINERY"])
    base = np.int64(694224000)  # 1992-01-01
    year7 = 7 * 365 * 86400
    customer = {"c_custkey": np.arange(n_cust, dtype=np.int64),
                "c_mktsegment": seg[rng.integers(0, 5, n_cust)]}
    orders = {"o_orderkey": np.arange(n_ord, dtype=np.int64),
              "o_custkey": rng.integers(0, n_cust, n_ord),
              "o_orderdate": base + rng.integers(0, year7, n_ord),
              "o_shippriority": rng.integers(0, 3, n_ord).astype(np.int8)}
    lineitem = {"l_orderkey": rng.integers(0, n_ord, n_li),
                "l_extendedprice": rng.gamma(3.0, 12000.0, n_li).astype(
                    np.float32),
                "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2
                                       ).astype(np.float32),
                "l_shipdate": base + rng.integers(0, year7, n_li)}
    return {"customer3": customer, "orders3": orders, "lineitem3": lineitem}


TPCH_Q3 = (
    "SELECT l_orderkey, "
    "SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
    "o_orderdate, o_shippriority "
    "FROM customer3, orders3, lineitem3 "
    "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
    "AND l_orderkey = o_orderkey "
    "AND o_orderdate < TIMESTAMP '1995-03-15 00:00:00' "
    "AND l_shipdate > TIMESTAMP '1995-03-15 00:00:00' "
    "GROUP BY l_orderkey, o_orderdate, o_shippriority "
    "ORDER BY revenue DESC, o_orderdate LIMIT 10")


def tpch_q3_queries(hdk, scale: float):
    n_cust = int(1_500_000 * scale)
    n_ord = int(15_000_000 * scale)
    n_li = int(60_000_000 * scale)
    # the join chain, the FK join path and the fused agg -> sort together
    return [(f"tpch_q3 {n_li} lineitem rows (3-table join)",
             lambda: hdk.sql(TPCH_Q3), n_li,
             24 * n_li + 25 * n_ord + 9 * n_cust)]


SUITE = {
    "join": (join_tables, join_queries),
    "zipf": (lambda s: join_tables(s, seed=17),
             lambda h, s: join_queries(h, s, zipf=True)),
    "groupby": (high_ndv_tables, high_ndv_queries),
    "tpch": (lineitem_tables, tpch_queries),
    "tpch3": (tpch_q3_tables, tpch_q3_queries),
}


def check_result(config: str, label: str, res, tables, scale: float):
    """``res`` of ``config``'s query ``label`` against its numpy oracle;
    raises on a difference."""
    out = res.to_numpy()
    if config in ("join", "zipf"):
        common.join_fee_check(label, out, *tables.values())
    elif config == "groupby":
        common.hn_check("HN2" if "top100" in label else "HN1", out,
                        common.hn_oracle(tables["ndv_t"],
                                         int(50_000_000 * scale)))
    elif label.startswith("tpch_q1"):
        common.tpch_q1_check(list(out.values()), tables["lineitem"], label)
    elif label.startswith("tpch_q6"):
        common.tpch_q6_check(res, tables["lineitem"], label)
    else:
        common.q3_check(label, out, tables)


def run_config(hdk, only: str, scale: float):
    """Import ``only``'s tables into ``hdk``, then time its queries, each
    with the kernel launches of its timed runs, and check each result."""
    tables_of, queries = SUITE[only]
    tables = tables_of(scale)
    import_tables(hdk, tables)
    out = []
    for label, q, rows, nbytes in queries(hdk, scale):
        hist.reset_launches()
        m = bench_query(q, hdk)
        launches = hist.launches()
        check_result(only, label, q(), tables, scale)
        out.append({**_rec(label, rows, m, nbytes), "launches": launches,
                    "result_check": "numpy"})
    return out


def run_all(scale: float, device: str, configs=CONFIGS):
    """One fresh process per config; a failed one ends the run
    (SystemExit naming the config, its exit code and its errors)."""
    results = []
    for only in configs:
        for rec in common.run_child(
                [os.path.abspath(__file__), "--scale", str(scale), "--only",
                 only, "--device", device],
                f"bench_suite_torch: config {only}"):
            results.append(rec)
            print(json.dumps(rec), flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="row-count multiplier vs the north-star configs")
    ap.add_argument("--only", choices=CONFIGS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "bench_torch_out", "bench_suite.json"))
    args = ap.parse_args(argv)
    common.require_card(args.device, "bench_suite_torch")

    if args.only is None:
        results = run_all(args.scale, args.device)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"scale": args.scale, "device": args.device,
                       "card": common.card_line(args.device),
                       "results": results}, f, indent=2)
        return

    hdk = hdk_tpu_torch.HDK(device=args.device)
    card = common.card_line(args.device)
    for r in run_config(hdk, args.only, args.scale):
        r["Mrows_per_sec"] = r.pop("rows_per_sec") / 1e6
        r["card"] = card
        print(json.dumps(r))


if __name__ == "__main__":
    main()
