#!/usr/bin/env python3
"""K1 (``groupby_sums``) of one source tree of hdk_tpu_torch, timed on
one CUDA card, for comparing two trees in one call.

    python3 k1_ab.py --tree DIR [--label NAME]

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
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
    hist.groupby_sums(torch.zeros(8, dtype=torch.int32, device="cuda"),
                      [torch.zeros(8, device="cuda")]
                      if hasattr(hist, "K1_MAX_COLS")
                      else torch.zeros((8, 1), device="cuda"), 2)  # build
    if args.sweep:
        print(json.dumps({"label": args.label, "tree": tree,
                          "card": cs.gpu_line(), "sweep": sweep_rows(hist)}),
              flush=True)
        return
    print(json.dumps({"label": args.label, "tree": tree,
                      "card": cs.gpu_line(),
                      "kernels": kernel_rows(hist, onehot),
                      "queries": query_rows(hdk_tpu_torch, cs)}), flush=True)


if __name__ == "__main__":
    main()
