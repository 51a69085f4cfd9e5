#!/usr/bin/env python3
"""Device-time breakdown of the sort-route, join and window queries of
chip_smoke.py.

    python3 profile_smoke.py [--out FILE.json] [--top N] [--scale F]
                             [--device cuda|cpu] [--dist SHARDS]

Runs HN1 and HN2 (high-NDV group-by, 100M rows), holistic Q1-Q3 (10M
rows), J1 (100M probe rows into a 10M-row build), TPC-H Q3 (60M
lineitem rows) and the window queries W1-W3 (100M taxi rows, 60M
lineitem rows) on the data and seeds of chip_smoke.py's phases 5-8: six
runs each (enough for a join's route A/B and TPC-H Q3's plan A/B to
settle), then one run under ``torch.profiler``.  Per query it prints the
host wall time of the profiled run, the device busy time (the union of
the kernels' intervals), the idle share ``1 - busy / wall``, and the top
kernels and operators by device time; ``--out`` writes the same as JSON.
``--scale`` shrinks the row and key counts (a rehearsal on the CPU:
``--device cpu --scale 0.01``, where no kernel is traced).  ``--dist N``
profiles phase 11's queries instead (taxi Q2, W1, HN1 and J1 in a
session of N shards on the one device).  Prints the
card's name and power limit first; imports neither jax nor pandas.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def _device_us(ev) -> float:
    """An operator's device time (the attribute's name varies by torch
    version)."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_query(label: str, run, top: int) -> dict:
    """Six runs (the first runs of a join or a plan time its route or
    plan candidates, see ``exec/feedback.py``), then one profiled run of
    ``run``."""
    for _ in range(6):
        run().block()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run().block()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    intervals = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        rec = kernels.setdefault(ev.name, [0.0, 0])
        rec[0] += (e - s) / 1e3
        rec[1] += 1
    # None where no device was traced (a run on the CPU)
    busy_ms = _busy_us(intervals) / 1e3 if intervals else None
    ops = sorted(((ev.key, _device_us(ev) / 1e3, ev.count)
                  for ev in prof.key_averages()
                  if ev.key.startswith("aten::") and _device_us(ev) > 0),
                 key=lambda r: -r[1])[:top]
    kern = sorted(((name, ms, n) for name, (ms, n) in kernels.items()),
                  key=lambda r: -r[1])[:top]
    idle = None if busy_ms is None else 1.0 - busy_ms / wall_ms
    print(f"{label}: wall {wall_ms!r} ms, "
          + ("no device traced" if busy_ms is None else
             f"device busy {busy_ms!r} ms, idle share {idle!r}"),
          flush=True)
    for name, ms, n in kern:
        print(f"  kernel {ms:9.3f} ms x {n:3d}  {name[:110]}")
    for name, ms, n in ops:
        print(f"  op     {ms:9.3f} ms x {n:3d}  {name}")
    return {"query": label, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": idle,
            "kernels": [{"name": k, "ms": ms, "count": n}
                        for k, ms, n in kern],
            "ops": [{"name": k, "ms": ms, "count": n} for k, ms, n in ops]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="JSON file to write")
    ap.add_argument("--top", type=int, default=12,
                    help="kernels and operators listed per query")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of chip_smoke.py's rows and keys")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dist", type=int, default=0,
                    help="profile phase 11's queries on this many shards")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            cs.fail("CUDA is not available: profiling needs one CUDA card")
        print(cs.gpu_line(), flush=True)
    import hdk_tpu_torch

    if args.dist:
        hdk = hdk_tpu_torch.HDK(device=args.device, **{
            "dist.enable": True, "dist.num_devices": args.dist})
        results = _dist_queries(hdk, hdk_tpu_torch, args)
    else:
        hdk = hdk_tpu_torch.HDK(device=args.device)
        results = []
        for run in (_sort_queries, _join_queries, _window_queries):
            results += run(hdk, hdk_tpu_torch, args)
    cs.check("jax" not in sys.modules, "jax was imported")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


def _sort_queries(hdk, hdk_mod, args) -> list:
    ndv_rows = int(cs.HIGH_NDV_ROWS * args.scale)
    ndv_keys = int(cs.HIGH_NDV_KEYS * args.scale)
    hol_rows = int(cs.HOLISTIC_ROWS * args.scale)
    results = []

    ht = hdk.import_pydict(cs.gen_high_ndv(ndv_rows, ndv_keys), name="ndv_t")
    results.append(profile_query(
        f"HN1 ({ndv_rows} rows)",
        lambda: ht.agg("k", "count", "sum(v)").run(), args.top))
    results.append(profile_query(
        f"HN2 ({ndv_rows} rows)",
        lambda: ht.agg("k", "count").sort(("count", "desc"),
                                          limit=100).run(), args.top))
    hdk.drop_table("ndv_t")

    hdk.import_pydict(cs.gen_holistic(hol_rows), name="h")
    for i, sql in enumerate((cs.HOLISTIC_Q1, cs.HOLISTIC_Q2,
                             cs.HOLISTIC_Q3), 1):
        results.append(profile_query(f"holistic Q{i} ({hol_rows} rows)",
                                     lambda: hdk.sql(sql), args.top))
    hdk.drop_table("h")
    cs.check("pandas" not in sys.modules, "pandas was imported")
    return results


def _join_queries(hdk, hdk_mod, args) -> list:
    results = []
    trips, payments = cs.gen_join(args.scale)
    tj = hdk.import_pydict(trips, name="trips_j")
    pj = hdk.import_pydict(payments, name="payments_j")
    results.append(profile_query(
        f"J1 ({trips['k'].size} x {payments['k'].size} rows)",
        lambda: tj.join(pj, "k", "k").agg([], "count", "sum(fee)").run(),
        args.top))
    del trips, payments
    hdk.drop_table("trips_j")
    hdk.drop_table("payments_j")
    tables = dict(zip(("customer3", "orders3", "lineitem3"),
                      cs.gen_tpch_q3(args.scale)))
    for name, data in tables.items():
        hdk.import_pydict(data, name=name,
                          schema=cs.q3_schema(hdk_mod.types, name))
    results.append(profile_query(
        f"TPC-H Q3 ({tables['lineitem3']['l_orderkey'].size} lineitem rows)",
        lambda: hdk.sql(cs.TPCH_Q3), args.top))
    for name in tables:
        hdk.drop_table(name)
    return results


def _window_queries(hdk, hdk_mod, args) -> list:
    t = hdk_mod.types
    rows = int(cs.TAXI_ROWS * args.scale)
    hdk.import_pydict(cs.gen_taxi(rows), name="trips", schema={
        "pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    results = [profile_query(f"W1 ({rows} rows)", lambda: hdk.sql(cs.W1),
                             args.top),
               profile_query(f"W2 ({rows} rows)", lambda: hdk.sql(cs.W2),
                             args.top)]
    hdk.drop_table("trips")
    lineitem = cs.gen_tpch_q3(args.scale)[2]
    hdk.import_pydict(lineitem, name="lineitem3",
                      schema=cs.q3_schema(t, "lineitem3"))
    results.append(profile_query(
        f"W3 ({lineitem['l_orderkey'].size} lineitem rows)",
        lambda: hdk.sql(cs.W3), args.top))
    hdk.drop_table("lineitem3")
    return results


def _dist_queries(hdk, hdk_mod, args) -> list:
    """Phase 11's taxi Q2 (dense_psum), W1 (dist_window), HN1
    (two_phase) and J1 (partitioned join) in the dist session."""
    t = hdk_mod.types
    rows = int(cs.TAXI_ROWS * args.scale)
    ht = hdk.import_pydict(cs.gen_taxi(rows), name="trips", schema={
        "pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    results = [
        profile_query(f"dist taxi Q2 ({rows} rows)", lambda: ht.agg(
            "passenger_count", "avg(total_amount)").run(), args.top),
        profile_query(f"dist W1 ({rows} rows)",
                      lambda: hdk.sql(cs.DIST_W1), args.top)]
    hdk.drop_table("trips")
    ndv_rows = int(cs.HIGH_NDV_ROWS * args.scale)
    ht = hdk.import_pydict(cs.gen_high_ndv(
        ndv_rows, int(cs.HIGH_NDV_KEYS * args.scale)), name="ndv_t")
    results.append(profile_query(
        f"dist HN1 ({ndv_rows} rows)",
        lambda: ht.agg("k", "count", "sum(v)").run(), args.top))
    hdk.drop_table("ndv_t")
    trips, payments = cs.gen_join(args.scale)
    tj = hdk.import_pydict(trips, name="trips_j")
    pj = hdk.import_pydict(payments, name="payments_j")
    results.append(profile_query(
        f"dist J1 ({trips['k'].size} x {payments['k'].size} rows)",
        lambda: tj.join(pj, "k", "k").agg([], "count", "sum(fee)").run(),
        args.top))
    return results


if __name__ == "__main__":
    main()
