#!/usr/bin/env python3
"""One histogram kernel of one source tree of hdk_tpu_torch, timed on one
CUDA card, for comparing two trees in one call.

    python3 k1_ab.py --tree DIR [--label NAME] [--kernel k1|k2|k3|k4] [--sweep]
                     [--queries main|q3|joins|stream]

``--kernel k1`` (the default) times K1, ``groupby_sums``:

Imports ``hdk_tpu_torch`` from DIR (a checkout, or ``git archive`` of
another commit) and, on data made by this repository's chip_smoke.py:

  * times K1 alone (median of 5 CUDA-event runs after a warm one) at the
    main path's layouts: TPC-H Q1 (E = 7, 4 float64 columns, 60M rows),
    taxi Q2 (E = 10, 1 float32 column, 100M rows), taxi Q4's E = 1981
    (4 float64, 100M) and the sort route's sorted ids at E = 50,000,002
    (4 float64, 100M).  ``kernel_ms`` is the kernel on the input its
    interface takes (an (N, S) stacked tensor made beforehand for a tree
    whose K1 takes one, the columns themselves otherwise); ``seg_sums_ms``
    is ``ops/onehot.py::seg_sums`` on the columns, any stacking included;
    each result is checked against a float64 ``index_add_`` (rtol 1e-10);
  * runs taxi Q2 and TPC-H Q1 through ``HDK(device="cuda")`` and reports
    the median warm latency of 5 runs after a cold one.

Prints the card's name and power limit, then one JSON line.  Run it for
the two trees in turns (old, new, new, old) inside one call.

    python3 k1_ab.py --tree DIR --sweep

times instead every K1 mode (``kernels/hist.py::_k1_mode``: where the
warps' sums go, and whether they match gids) at the main path's K1
shapes, each checked against ``index_add_``; a mode whose shared memory
does not fit is reported as null.

``--kernel k3`` (``seg_sums_exact``), ``--kernel k4`` (``count_hist``)
and ``--kernel k2`` (``groupby_sums2``) time the integer kernel the same
way at the main path's shapes (K3: TPC-H Q1's int8 l_quantity at E = 7,
the nulls query's int64 x at E = 1001, two int64 columns at E = 1981,
HN1's sorted ids at E = 50,000,002, E = 65536; K4: E = 7, taxi Q3's 37,
taxi Q4's 1981, 1001, 65536 and sorted 50M; K2: two bool columns at
chip_smoke.py phase 3's E = 11, 12, 1981, 65536 and sorted 50M, and at
the nulls query's E = 1001 over 10M rows), each checked bit for bit
against the plain version, beside ``seg_sums`` on the columns (any
stacking included), and the warm latency of the queries that launch the
kernel (K3/K4: TPC-H Q1, taxi Q3, the nulls query, HN1, and TPC-H Q6, no
kernel: a control; K2: the nulls query and holistic Q1 and Q2;
``--no-queries`` leaves them out); ``host_us`` is the host's time to
issue one call.  ``kernel_ms`` times one call between two CUDA events,
``kernel_ms_batched`` one of ten back-to-back calls.  With ``--sweep``
they time every mode of ``kernels/hist.py::_int_mode`` (a tree whose
kernel has it) instead.

``--queries q3`` replaces the queries above by TPC-H Q3 (chip_smoke.py
phase 7's J4: 1.5M customers, 15M orders, 60M lineitem rows; two perfect
joins, then the sort-route GROUP BY whose float SUM is K1 over sorted
ids), its warm latency beside the same numbers for the kernel.
``--queries joins`` times phase 7's J1 and J2 (100M probe rows into a
10M-row build), J5 (an IN subquery) and TPC-H Q3 instead, each after six
runs that let the tree's route and plan A/Bs settle, with the route the
last run took.  ``--queries stream`` times only phase 9's streamed TPC-H
Q1 and Q6 over lineitem at SF100 (600M rows, more than the scan budget;
each run must stream), beside the host's pinned 1 GiB host-to-device
copy rate, and no kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# (label, E, rows, dtype, columns, sorted ids)
SHAPES = (("tpch_q1", 7, 60_000_000, torch.float64, 4, False),
          ("taxi_q2", 10, 100_000_000, torch.float32, 1, False),
          ("taxi_q4_E", 1981, 100_000_000, torch.float64, 4, False),
          ("sorted_50M", 50_000_002, 100_000_000, torch.float64, 4, True))


def cuda_ms(fn, repeats: int = 5) -> float:
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


def cuda_ms_batched(fn, calls: int = 10, repeats: int = 5) -> float:
    """Median device time of ``calls`` back-to-back runs of ``fn``, per
    run: the host's time to issue a call hides behind the device's."""
    return cuda_ms(lambda: [fn() for _ in range(calls)], repeats) / calls


def kernel_rows(hist, onehot):
    takes_columns = hasattr(hist, "K1_MAX_COLS")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, e, n, dtype, n_cols, is_sorted in SHAPES:
        gid = torch.randint(0, e, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        if is_sorted:
            gid = torch.sort(gid).values
        cols = [torch.rand((n,), device=dev, generator=gen, dtype=dtype)
                * 1e4 for _ in range(n_cols)]
        arg = cols if takes_columns else torch.stack(cols, 1)
        want = torch.zeros((e, n_cols), dtype=torch.float64,
                           device=dev).index_add_(
            0, gid, torch.stack(cols, 1).to(torch.float64))
        got = hist.groupby_sums(gid, arg, e)
        ok = bool(torch.allclose(got, want, rtol=1e-10, atol=0.0))
        del got, want
        rows.append({
            "shape": label, "E": e, "N": n, "S": n_cols,
            "dtype": str(dtype).replace("torch.", ""), "sorted": is_sorted,
            "ok": ok,
            "kernel_ms": cuda_ms(lambda: hist.groupby_sums(gid, arg, e)),
            "seg_sums_ms": cuda_ms(lambda: onehot.seg_sums(cols, gid, e)),
        })
        del gid, cols, arg
        torch.cuda.empty_cache()
    return rows


# (label, E, rows, dtype, columns, sorted ids): K1 on the main path (TPC-H
# Q1, taxi Q2, nulls, the holistic sort route at 10M rows, HN1's buffer),
# beside it (taxi Q4's E, E = 65536), and the E between them that decide
# where warp-private copies stop paying
SWEEP = (("tpch_q1", 7, 60_000_000, torch.float64, 4, False),
         ("taxi_q2", 10, 100_000_000, torch.float32, 1, False),
         *[(f"e{e}_f64", e, 100_000_000, torch.float64, 1, False)
           for e in (16, 32, 64, 128, 256)],
         ("e64_f64x4", 64, 100_000_000, torch.float64, 4, False),
         ("nulls_E", 1001, 100_000_000, torch.float64, 1, False),
         ("e1981_f32", 1981, 100_000_000, torch.float32, 1, False),
         ("e1981_f64", 1981, 100_000_000, torch.float64, 4, False),
         ("e65536_f64", 65536, 100_000_000, torch.float64, 4, False),
         ("sorted_5M", 5_000_002, 10_000_000, torch.float64, 1, True),
         ("sorted_runs_1000", 1000, 100_000_000, torch.float64, 4, True),
         ("sorted_50M", 50_000_002, 100_000_000, torch.float64, 4, True))
MODES = (2, 1, 0)


def sweep_rows(hist):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    chosen = hist._k1_mode
    rows = []
    try:
        for label, e, n, dtype, n_cols, is_sorted in SWEEP:
            gid = torch.randint(0, e, (n,), device=dev, generator=gen,
                                dtype=torch.int32)
            if is_sorted:
                gid = torch.sort(gid).values
            cols = [torch.rand((n,), device=dev, generator=gen, dtype=dtype)
                    * 1e4 for _ in range(n_cols)]
            want = torch.zeros((e, n_cols), dtype=torch.float64,
                               device=dev).index_add_(
                0, gid, torch.stack(cols, 1).to(torch.float64))
            for mode in MODES:
                hist._k1_mode = lambda s, e, _m=mode: _m
                row = {"shape": label, "E": e, "N": n, "S": n_cols,
                       "dtype": str(dtype).replace("torch.", ""),
                       "mode": mode, "chosen": chosen(n_cols, e) == mode}
                try:
                    got = hist.groupby_sums(gid, cols, e)
                    torch.cuda.synchronize()
                except RuntimeError as exc:  # shared memory does not fit
                    row.update(ms=None, ok=None, error=str(exc))
                    rows.append(row)
                    continue
                row["ok"] = bool(torch.allclose(got, want, rtol=1e-10,
                                                atol=0.0))
                del got
                row["ms"] = cuda_ms(lambda: hist.groupby_sums(gid, cols, e))
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
            del gid, cols, want
            torch.cuda.empty_cache()
    finally:
        hist._k1_mode = chosen
    return rows


def warm_latency(run) -> dict:
    t0 = time.perf_counter()
    run().block()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        run().block()
        warm.append(time.perf_counter() - t0)
    return {"cold_s": cold, "warm_ms": statistics.median(warm) * 1e3,
            "warm_runs_ms": [w * 1e3 for w in warm]}


# (label, E, rows, column dtype or None for K4, columns, sorted ids)
INT_SHAPES = {
    "k2": (("e11", 11, 100_000_000, torch.bool, 2, False),
           ("e12", 12, 100_000_000, torch.bool, 2, False),
           ("taxi_q4_E", 1981, 100_000_000, torch.bool, 2, False),
           ("e65536", 65536, 100_000_000, torch.bool, 2, False),
           ("sorted_50M", 50_000_002, 100_000_000, torch.bool, 2, True),
           ("nulls", 1001, 10_000_000, torch.bool, 2, False)),
    "k3": (("tpch_q1", 7, 60_000_000, torch.int8, 1, False),
           ("e11_i8", 11, 100_000_000, torch.int8, 1, False),
           ("nulls", 1001, 10_000_000, torch.int64, 1, False),
           ("e1981_i64x2", 1981, 100_000_000, torch.int64, 2, False),
           ("e65536_i64", 65536, 100_000_000, torch.int64, 1, False),
           ("sorted_50M", 50_000_002, 100_000_000, torch.int64, 1, True)),
    "k4": (("tpch_q1", 7, 60_000_000, None, 1, False),
           ("taxi_q3", 37, 100_000_000, None, 1, False),
           ("nulls", 1001, 10_000_000, None, 1, False),
           ("taxi_q4", 1981, 100_000_000, None, 1, False),
           ("e65536", 65536, 100_000_000, None, 1, False),
           ("sorted_50M", 50_000_002, 100_000_000, None, 1, True)),
}
INT_SWEEP = {
    "k2": (("nulls", 1001, 10_000_000, torch.bool, 2, False),
           *[(f"e{e}_b2", e, 100_000_000, torch.bool, 2, False)
             for e in (11, 32, 33, 1981, 25_600, 65536)],
           ("sorted_runs_1000_b2", 1000, 100_000_000, torch.bool, 2, True),
           ("sorted_50M_b2", 50_000_002, 100_000_000, torch.bool, 2, True)),
    "k3": (("tpch_q1", 7, 60_000_000, torch.int8, 1, False),
           *[(f"e{e}_i8", e, 100_000_000, torch.int8, 1, False)
             for e in (11, 16, 37, 64, 128, 1001, 1981, 65536)],
           *[(f"e{e}_i64", e, 100_000_000, torch.int64, 1, False)
             for e in (7, 11, 37, 64, 128, 1001, 1981, 65536)],
           ("e7_i64x2", 7, 100_000_000, torch.int64, 2, False),
           ("e1981_i64x2", 1981, 100_000_000, torch.int64, 2, False),
           ("sorted_runs_1000_i64", 1000, 100_000_000, torch.int64, 1, True),
           ("sorted_50M_i64", 50_000_002, 100_000_000, torch.int64, 1,
            True)),
    "k4": (("tpch_q1", 7, 60_000_000, None, 1, False),
           *[(f"e{e}", e, 100_000_000, None, 1, False)
             for e in (11, 16, 24, 37, 64, 128, 256, 1001, 1981, 65536)],
           ("sorted_runs_1000", 1000, 100_000_000, None, 1, True),
           ("sorted_50M", 50_000_002, 100_000_000, None, 1, True)),
}
INT_MODES = (2, 1, 0)


def _int_data(gen, e, n, dtype, n_cols, is_sorted):
    dev = torch.device("cuda")
    gid = torch.randint(0, e, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    if is_sorted:
        gid = torch.sort(gid).values
    if dtype is None:
        return gid, []
    if dtype == torch.bool:
        return gid, [torch.rand((n,), device=dev, generator=gen) < 0.9
                     for _ in range(n_cols)]
    lo, hi = (1, 51) if dtype == torch.int8 else (-10**12, 10**12)
    return gid, [torch.randint(lo, hi, (n,), device=dev, generator=gen,
                               dtype=dtype) for _ in range(n_cols)]


def _int_call(hist, gid, cols, e):
    """The kernel on the input its interface takes: the columns
    themselves for a tree whose K2/K3 takes a list, else an (N, S) tensor
    (a view for one column, made beforehand for several).  A tree whose K2
    still plans with ``_use_shared`` (the generic template) takes a
    tensor."""
    if not cols:
        return lambda: hist.count_hist(gid, e)
    if cols[0].dtype == torch.bool:
        arg = (torch.stack(cols, 1) if hasattr(hist, "_use_shared")
               else cols)
        return lambda: hist.groupby_sums2(gid, arg, e)
    if hasattr(hist, "INT_MAX_COLS"):
        arg = cols
    else:
        arg = cols[0][:, None] if len(cols) == 1 else torch.stack(cols, 1)
    return lambda: hist.seg_sums_exact(gid, arg, e)


def _int_want(hist, gid, cols, e):
    if not cols:
        return hist.count_hist_ref(gid, e)
    if cols[0].dtype == torch.bool:
        return hist.groupby_sums2_ref(gid, torch.stack(cols, 1), e)
    return hist.seg_sums_exact_ref(gid, torch.stack(cols, 1), e)


def int_kernel_rows(hist, onehot, kernel):
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for label, e, n, dtype, n_cols, is_sorted in INT_SHAPES[kernel]:
        gid, cols = _int_data(gen, e, n, dtype, n_cols, is_sorted)
        call = _int_call(hist, gid, cols, e)
        ok = bool(torch.equal(call(), _int_want(hist, gid, cols, e)))
        if cols:
            seg = lambda: onehot.seg_sums(cols, gid, e)
        else:
            ones = torch.ones_like(gid, dtype=torch.bool)
            seg = lambda: onehot.seg_sums([ones], gid, e, ones_ids=[0])
        rows.append({
            "shape": label, "E": e, "N": n, "S": len(cols),
            "dtype": str(dtype).replace("torch.", ""), "sorted": is_sorted,
            "ok": ok, "kernel_ms": cuda_ms(call),
            "kernel_ms_batched": cuda_ms_batched(call),
            "seg_sums_ms": cuda_ms(seg),
        })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
        del gid, cols, call, seg
        torch.cuda.empty_cache()
    return rows


def host_us(hist, kernel, calls: int = 500) -> float:
    """Host time to issue one call of the wrapper (1024 rows, E = 7),
    in microseconds: the device keeps up, so the host clock reads the
    Python, ctypes and CUDA API time of a call."""
    gid = torch.randint(0, 7, (1024,), device="cuda", dtype=torch.int32)
    if kernel == "k4":
        call = lambda: hist.count_hist(gid, 7)
    else:
        dtype = torch.bool if kernel == "k2" else torch.int8
        cols = [torch.ones((1024,), device="cuda", dtype=dtype)]
        call = _int_call(hist, gid, cols, 7)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def int_sweep_rows(hist, kernel):
    gen = torch.Generator(device="cuda").manual_seed(11)
    chosen = hist._int_mode
    rows = []
    try:
        for label, e, n, dtype, n_cols, is_sorted in INT_SWEEP[kernel]:
            gid, cols = _int_data(gen, e, n, dtype, n_cols, is_sorted)
            want = _int_want(hist, gid, cols, e)
            for mode in INT_MODES:
                hist._int_mode = lambda s, e, d=None, _m=mode: _m
                row = {"shape": label, "E": e, "N": n, "S": len(cols),
                       "dtype": str(dtype).replace("torch.", ""),
                       "mode": mode, "chosen": chosen(max(len(cols), 1), e,
                                                      dtype) == mode,
                       "launches": len(hist._int_ranges(
                           mode, max(len(cols), 1), e, dtype))}
                call = _int_call(hist, gid, cols, e)
                try:
                    got = call()
                    torch.cuda.synchronize()
                except RuntimeError as exc:  # shared memory does not fit
                    row.update(ms=None, ok=None, error=str(exc))
                    rows.append(row)
                    continue
                row["ok"] = bool(torch.equal(got, want))
                del got
                row["ms"] = cuda_ms(call)
                row["ms_batched"] = cuda_ms_batched(call)
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
            del gid, cols, want
            torch.cuda.empty_cache()
    finally:
        hist._int_mode = chosen
    return rows


def k2_query_rows(mod, cs):
    """Warm latency of the queries that launch K2."""
    hdk = mod.HDK(device="cuda")
    hdk.import_pydict(cs.gen_nulls(cs.NULLS_ROWS), name="t")
    out = {"nulls": warm_latency(lambda: hdk.sql(cs.NULLS_Q))}
    hdk.drop_table("t")
    hdk.import_pydict(cs.gen_holistic(cs.HOLISTIC_ROWS), name="h")
    out["holistic_q1"] = warm_latency(lambda: hdk.sql(cs.HOLISTIC_Q1))
    out["holistic_q2"] = warm_latency(lambda: hdk.sql(cs.HOLISTIC_Q2))
    hdk.drop_table("h")
    return out


def int_query_rows(mod, cs):
    hdk = mod.HDK(device="cuda")
    t = mod.types
    ht = hdk.import_pydict(cs.gen_taxi(cs.TAXI_ROWS), name="trips", schema={
        "pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    year = lambda: ht["pickup_datetime"].extract("year").name("y")
    out = {"taxi_q3": warm_latency(
        lambda: ht.agg(["passenger_count", year()], "count").run())}
    hdk.drop_table("trips")
    hdk.import_pydict(cs.gen_lineitem(cs.LINEITEM_ROWS), name="lineitem",
                      schema={"l_shipdate": t.timestamp(t.TimeUnit.SECOND,
                                                        False)})
    out["tpch_q1"] = warm_latency(lambda: hdk.sql(cs.TPCH_Q1))
    out["tpch_q6"] = warm_latency(lambda: hdk.sql(cs.TPCH_Q6))  # no kernel
    hdk.drop_table("lineitem")
    hdk.import_pydict(cs.gen_nulls(cs.NULLS_ROWS), name="t")
    out["nulls"] = warm_latency(lambda: hdk.sql(cs.NULLS_Q))
    hdk.drop_table("t")
    nt = hdk.import_pydict(cs.gen_high_ndv(cs.HIGH_NDV_ROWS,
                                           cs.HIGH_NDV_KEYS), name="ndv_t")
    out["HN1"] = warm_latency(lambda: nt.agg("k", "count", "sum(v)").run())
    hdk.drop_table("ndv_t")
    return out


def query_rows(mod, cs):
    hdk = mod.HDK(device="cuda")
    t = mod.types
    taxi = cs.gen_taxi(cs.TAXI_ROWS)
    ht = hdk.import_pydict(taxi, name="trips", schema={
        "pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    del taxi
    out = {"taxi_q2": warm_latency(
        lambda: ht.agg("passenger_count", "avg(total_amount)").run())}
    hdk.drop_table("trips")
    hdk.import_pydict(cs.gen_lineitem(cs.LINEITEM_ROWS), name="lineitem",
                      schema={"l_shipdate": t.timestamp(t.TimeUnit.SECOND,
                                                        False)})
    out["tpch_q1"] = warm_latency(lambda: hdk.sql(cs.TPCH_Q1))
    hdk.drop_table("lineitem")
    return out


def q3_rows(mod, cs, settle: int = 0):
    """Warm latency of TPC-H Q3 (phase 7's J4), after ``settle`` runs."""
    hdk = mod.HDK(device="cuda")
    tables = dict(zip(("customer3", "orders3", "lineitem3"),
                      cs.gen_tpch_q3()))
    for name, data in tables.items():
        hdk.import_pydict(data, name=name, schema=cs.q3_schema(mod.types,
                                                               name))
    for _ in range(settle):
        hdk.sql(cs.TPCH_Q3).block()
    out = {"tpch_q3": warm_latency(lambda: hdk.sql(cs.TPCH_Q3))}
    out["tpch_q3"]["route"] = hdk._executor._join_route
    for name in tables:
        hdk.drop_table(name)
    return out


def join_rows(mod, cs):
    """Warm latency of phase 7's J1, J2, J5 and TPC-H Q3 (J4), each in a
    session of its own, after six runs that let a tree's route and plan
    A/Bs settle and its build tables be made."""
    def settled(run):
        for _ in range(6):
            run().block()
        return warm_latency(run)

    out = {}
    for name, seed in (("j1", 11), ("j2", 17)):
        hdk = mod.HDK(device="cuda")
        trips, payments = cs.gen_join(seed=seed)
        tj = hdk.import_pydict(trips, name="trips_j")
        pj = hdk.import_pydict(payments, name="payments_j")
        out[name] = settled(lambda: tj.join(pj, "k", "k").agg(
            [], "count", "sum(fee)").run())
        out[name]["route"] = hdk._executor._join_route
        if name == "j1":
            out["j5"] = settled(lambda: hdk.sql(cs.J5_IN))
            out["j5"]["route"] = hdk._executor._join_route
        for t in ("trips_j", "payments_j"):
            hdk.drop_table(t)
        del hdk, tj, pj, trips, payments
        torch.cuda.empty_cache()
    out.update(q3_rows(mod, cs, settle=6))
    return out


def stream_rows(mod, cs):
    """Warm latency of phase 9's streamed TPC-H Q1 and Q6 (600M lineitem
    rows), with the chunk count of the last run."""
    hdk = mod.HDK(device="cuda")
    t = mod.types
    hdk.import_pydict(cs.gen_lineitem(cs.STREAM_LINEITEM_ROWS),
                      name="lineitem", schema={
                          "l_shipdate": t.timestamp(t.TimeUnit.SECOND,
                                                    False)})
    ex = hdk._executor
    out = {"h2d_pinned_GBps": cs.h2d_rates()[0] / 1e9}
    for name, sql in (("stream_tpch_q1", cs.TPCH_Q1),
                      ("stream_tpch_q6", cs.TPCH_Q6)):
        out[name] = warm_latency(lambda: hdk.sql(sql))
        out[name]["chunks"] = ex._frag_stream_chunks
        if not ex._frag_stream_chunks or ex._frag_stream_chunks < 2:
            raise SystemExit(f"{name} did not stream")
    hdk.drop_table("lineitem")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k4"),
                    default="k1")
    ap.add_argument("--no-queries", action="store_true",
                    help="k2/k3/k4: time the kernel alone")
    ap.add_argument("--queries", choices=("main", "q3", "joins", "stream"),
                    default="main",
                    help="q3: time TPC-H Q3, joins: J1, J2, J5 and "
                         "TPC-H Q3, in place of the kernel's main-path "
                         "queries; stream: the streamed TPC-H Q1 and Q6 "
                         "alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab.py needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    sys.path.insert(0, tree)
    import hdk_tpu_torch
    from hdk_tpu_torch.kernels import hist
    from hdk_tpu_torch.ops import onehot

    src = os.path.dirname(os.path.abspath(hdk_tpu_torch.__file__))
    if os.path.dirname(src) != tree:
        raise SystemExit(f"hdk_tpu_torch loaded from {src}, not {tree}")
    if args.queries == "stream":
        print(json.dumps({"label": args.label, "tree": tree,
                          "card": cs.gpu_line(),
                          "queries": stream_rows(hdk_tpu_torch, cs)}),
              flush=True)
        return
    hist.groupby_sums(torch.zeros(8, dtype=torch.int32, device="cuda"),
                      [torch.zeros(8, device="cuda")]
                      if hasattr(hist, "K1_MAX_COLS")
                      else torch.zeros((8, 1), device="cuda"), 2)  # build
    if args.kernel != "k1":
        result = {"label": args.label, "tree": tree, "card": cs.gpu_line(),
                  "kernel": args.kernel}
        if args.sweep:
            result["sweep"] = int_sweep_rows(hist, args.kernel)
        else:
            result["host_us"] = host_us(hist, args.kernel)
            result["kernels"] = int_kernel_rows(hist, onehot, args.kernel)
            if not args.no_queries:
                rows = (q3_rows if args.queries == "q3"
                        else join_rows if args.queries == "joins"
                        else k2_query_rows if args.kernel == "k2"
                        else int_query_rows)
                result["queries"] = rows(hdk_tpu_torch, cs)
        print(json.dumps(result), flush=True)
        return
    if args.sweep:
        print(json.dumps({"label": args.label, "tree": tree,
                          "card": cs.gpu_line(), "sweep": sweep_rows(hist)}),
              flush=True)
        return
    rows = {"q3": q3_rows, "joins": join_rows}.get(args.queries,
                                                    query_rows)
    print(json.dumps({"label": args.label, "tree": tree,
                      "card": cs.gpu_line(),
                      "kernels": kernel_rows(hist, onehot),
                      "queries": rows(hdk_tpu_torch, cs)}), flush=True)


if __name__ == "__main__":
    main()
