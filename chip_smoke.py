#!/usr/bin/env python3
"""Smoke run of hdk_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. device: the card's name and power limit, torch and CUDA versions;
     exits non-zero when CUDA is not available;
  2. build: compiles the CUDA kernels from hdk_tpu_torch/csrc;
  3. kernels: each histogram kernel against its plain PyTorch version on
     the card, at 100M rows and the main path's segment counts (random
     ids; sorted ids at the sort route's 50M-group buffer; K1, K3 and K4
     also at TPC-H Q1's layout, K1 at taxi Q2's, K2 at the NULL-heavy
     query's), each random-id case again with the ids as a dense-key
     source, and each kernel over the keys of taxi Q1-Q4 and TPC-H Q1/Q6
     (``ids=keys``, beside the kernel over the built array and the time
     to build it), each case timed beside
     its bound
     (bytes over the device-memory rate), its share of that bound, and
     the one PyTorch call that computes the same function where there is
     one (``bincount``, ``index_add_``); ``ms`` is one call between two
     CUDA events, host time to issue it included, ``batched_ms`` one of
     ten back-to-back calls;
  4. the main path through the public entry points: taxi Q1-Q4 (builder
     API, 100M rows), TPC-H Q1/Q6 and a scalar subquery (SQL, 60M
     lineitem rows) and a NULL-heavy GROUP BY (SQL, 10M rows), each
     checked against a numpy oracle and required to have run its
     histogram kernels;
  5. the sort-based GROUP BY at high NDV (bench_suite's shape, 100M rows,
     ~43M groups of 50M possible keys): HN1 ``agg("k", "count",
     "sum(v)")`` and HN2 the same count sorted descending, LIMIT 100;
  6. holistic aggregates (SQL, 10M rows): COUNT/SUM DISTINCT, STDDEV,
     MEDIAN over a packed key on the sort route, COUNT DISTINCT and
     QUANTILE on the dense route, HLL and t-digest sketches over a float
     key, and the first query again in a session whose group buffer
     starts below the group count (one widen-retry);
  7. joins, in a session of their own: J1 100M probe rows into a 10M-row
     build and J2 the same with zipf(1.3) probe keys, J3 100M probe rows
     into 10M build keys spread over [0, 2^40) (INNER and LEFT), J4
     TPC-H Q3 (60M lineitem rows; two joins, then the sort-route GROUP
     BY) and J5 an IN subquery (a SEMI join), each against a numpy
     oracle: a cold run, exploration runs until the join route A/B
     (spread, value tables, sorted hash; each candidate's measured ms is
     logged, an inadmissible one +inf) and TPC-H Q3's plan A/B settle,
     then three warm runs on the settled route that build no join table;
     J4's warm runs must skip the filtered build subtrees and read the
     recycled tables ("perfect(recycled)"); J1 again in a session
     without route feedback must take the spread route;
  8. window functions and array columns, in a session of their own: W1
     the top 10 per passenger count by ROW_NUMBER over 100M taxi rows
     (and the full RANK and DENSE_RANK columns), W2 a cumulative SUM, a
     LAG and a 7-row moving AVG under a GROUP BY, W3 whole-partition
     SUM and COUNT over TPC-H lineitem's 15M orders (60M rows), W4
     TOP_K/BOTTOM_K per passenger count with UNNEST and an imported
     10M x 4 int32 array column (CARDINALITY, a subscript, UNNEST and a
     GROUP BY count), each against numpy with its cold time, median warm
     latency and rows/s;
  9. the executor's controls, in a session of their own: TPC-H Q1 and Q6
     streamed chunk by chunk over 600M lineitem rows (SF100; more than
     the scan budget) beside the rate of a pinned 1 GiB host-to-device
     copy, Q1 under the watchdog (a long time limit streams one fragment
     a chunk; a 1 ms limit must raise), EXPLAIN ANALYZE of the streamed
     Q1, fragment skipping over 100M taxi rows in pickup order (one month
     of 4 years), and the measured choice between the dense and the sort
     route of a 1000-group GROUP BY; each against numpy;
 10. the rest of the facade, in a session of its own: S1 a stream
     (``create_stream``) of 100M taxi rows pushed in 10 batches, which
     must leave at most one batch's bytes on the device; U1 a UDF with
     a torch body in taxi Q2's GROUP BY through ``hdk.call`` and SQL,
     against the same expression in builtins, then registered again
     with another body (a new step, the new result); V1 the taxi rows
     under a 10M-row fragment size; P1 a 1.6 GB projection offloaded to
     host memory (device memory must fall by its bytes), read back and
     scanned, four such results under a budget that holds two (the two
     oldest spill) and ``clear_device_mem``; I1 SQLite answering a
     recursive CTE and SUBSTR over 100k rows; and ``import_arrow`` then
     taxi Q2 with the device prefetch on and off (where pyarrow is
     installed); each against numpy;
 11. multi-device: a session of 4 shards on the card beside a
     single-device one, taxi Q2 (``dense_psum``) and Q3 sorted by its
     count (``dense_psum_fused_sort``) over 100M rows, W1 with a LIMIT
     (``dist_window``), the nulls GROUP BY (K2), a COUNT(DISTINCT)
     (``distinct_split``) and an ORDER BY + LIMIT 200000 (the range sort)
     over 10M rows, HN1 (``two_phase``), J1 (partitioned join) and J5's
     IN subquery (broadcast), each on its expected route and equal to
     its numpy oracle or else to the single-device result; per query the
     routes, warm ms beside the single-device warm ms, retries and
     ``commlog.summarize`` of its capture;
 12. multi-host: two ranks of this script (``--rank R --address
     HOST:PORT``), fresh processes on the one card, joined by
     ``torch.distributed`` over gloo on 127.0.0.1 with operands staged
     through pinned host memory, 2 of the 4 shards each; every table
     process-local (each rank imports its own rows, made from the
     seeds): taxi Q2 and Q3 sorted (100M rows, 50/50), the nulls GROUP BY
     (10M), a GROUP BY on a string column split 40/60 (10M rows; the
     ranks' dictionaries unify at ingest), HN1 (``two_phase``), J5's IN
     subquery (broadcast, process-local fact x replicated dim) and J1
     (partitioned); each on its route and equal to its numpy oracle on
     both ranks, with phase 11's bytes per shard where the sizes agree;
     per query the warm ms of each rank beside phase 11's 4-shard and
     one-device warm ms, the transport's staged bytes and ms and each
     rank's peak device memory.  ``--phase12`` runs phase 12 alone after
     the build (``--sizes '{"hn1_rows": ...}'`` cuts a size), without
     the contract lines;
 13. the port's bench: ``bench_torch.py`` (taxi Q1-Q4, 10M rows, a
     process per query), ``bench_suite_torch.py --scale 0.5`` (the
     north-star configs at half their rows, which phases 4, 5 and 7 run
     whole: the 50M x 5M join, the zipf join, the 50M-row group-by over
     25M keys with and without a top-100, TPC-H Q1/Q6 and Q3 over 30M
     lineitem rows), ``bench_scaling_torch.py``
     (2M rows over 1, 2 and 4 shards) and the ingest, NDV and TPC-H Q3
     tools at sizes cut to fit (the cuts are logged), each a process of
     its own that must exit 0 with its record's every key (all but the
     suite at once, so their times are no measurement; the suite
     alone).  The processes that time bench_torch.py's queries and the
     suite's configs hold each result against its numpy oracle
     (``bench_common_torch.py``) at the size they timed, and count the
     kernel launches of their timed runs.  ``--phase13`` runs it alone
     after the build (``--sizes '{"suite_scale": 0.1}'`` cuts a size),
     without the contract lines;
 14. the streaming top-n: each query in a default session (the
     streaming top-n up to ``exec.streaming_topn_max`` rows) and in one
     with the knob at 0 (the full sort), on the expected route in each
     and equal to a numpy stable lexsort row for row, both routes'
     warm ms logged: T1 ``ORDER BY total_amount DESC LIMIT 10``, T2
     ``ORDER BY passenger_count DESC, trip_distance LIMIT 1000`` and T3
     ``WHERE cab_type = 1 ORDER BY pickup_datetime LIMIT 100`` over 100M
     taxi rows, T4 ``ORDER BY y DESC, g`` over the nulls table at the
     knob (LIMIT 100000) and one row past it (the full sort in both
     sessions), HN2 and TPC-H Q3.  ``--phase14`` runs it alone after
     the build (``--sizes '{"taxi_rows": ...}'`` cuts a size), without
     the contract lines;
 15. the reference's surface: taxi Q1 over 10M rows with the debug timer
     on, in a session on the card and one on the CPU, each step span's
     name and ms printed, the step kinds required equal; then the 45
     query shapes of tests/test_ref_shapes.py (read from its text) over
     ``gen_ref_shapes``' 1M-row table in both sessions, the card's
     results equal to the CPU's (integers and NULLs exactly, floats to
     rtol 1e-9).  ``--phase15`` runs it alone after the build, without
     the contract lines;
 16. the exact quantiles' pair sort (``csrc/pair_sort.cu``): the kernels
     against their plain version by ``torch.equal`` over 100M rows by
     1e4 groups of ~1e4 rows (the block kernel) and 1e6 groups of ~100
     (the warp kernel), each timed beside its bound and the plain
     version, and the median through the key sort beside the
     permutation's, equal by ``==``.  ``--phase16`` runs it alone after
     the build, without the contract lines.
Phases 5-6 are the sort route, phase 7 the join path, phase 8 the
window path, phase 9 the controls, phase 10 the facade, phases 11
and 12 the multi-device and multi-host paths, phase 13 the bench's,
phase 14 the top-n's and phase 15 the reference's surface:
each phase's kernel launches count apart from the others' (phase 12's
inside its ranks and phase 13's inside its timed query processes, each
summed by the parent), every kernel must launch on phases 4, 5-6, 11
and 12, the kernels
of TPC-H Q3 on phase 7, W3's (K1 and K4) on phase 8, the streamed Q1's
(K1, K3 and K4) on phase 9, S1's (K1, K3 and K4) and U1's (K1 and
K4) on phase 10, K1, K3 and K4 on phase 13, and K1 (TPC-H Q3) and K4
(HN2) on phase 14, and K1, K3 and K4 on phase 15; the pair sort must
launch on phases 5-6 (the holistic MEDIAN and QUANTILE).  Each phase
ends with the device cache's evictions and resident bytes.  The line
before the last is a JSON object with the per-kernel results (every
phase-3 case under ``cases``, the pair sort's phase-16 cases under its
own); the last line is
{"ok": true, "device": {...}}.  Any failure raises, so the script exits
non-zero and prints no result.  Needs numpy, torch and
bench_common_torch.py beside it (the numpy oracles); imports neither
jax, pandas nor pyarrow (but for the string columns of phases 7 and 10
and phase 10's Arrow import, which go through pyarrow where it is
installed).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bench_common_torch import (check, close, epoch, equal, fail, group_ids,
                                hn_check, hn_oracle, q3_check, q3_oracle,
                                taxi_check, tpch_q1_check, tpch_q6_check,
                                years)

TAXI_ROWS = 100_000_000
LINEITEM_ROWS = 60_000_000
NULLS_ROWS = 10_000_000
HIGH_NDV_ROWS = 100_000_000
HIGH_NDV_KEYS = 50_000_000
HOLISTIC_ROWS = 10_000_000
SKETCH_PREFIX_ROWS = 1_000_000
KERNEL_ROWS = 100_000_000
REPEATS = 5
# one kernel alone in phase 3 at a main-path layout: (E, rows, kernel,
# slot kind) of TPC-H Q1 (K1 over 4 float64 sums, K3 over int8
# l_quantity, K4), taxi Q2 (K1 over float32 total_amount) and the nulls
# query (K2 over the validity of x and y)
MAIN_SHAPES = ((7, LINEITEM_ROWS, "groupby_sums", "float64"),
               (10, TAXI_ROWS, "groupby_sums", "float32"),
               (7, LINEITEM_ROWS, "seg_sums_exact", "int8"),
               (7, LINEITEM_ROWS, "count_hist", None),
               (1001, NULLS_ROWS, "groupby_sums2", "bool"))
# the main path's dense-key sources in phase 3, each kernel deriving the
# ids from the keys as the group-by hands them over: (label, rows, keys as
# (dtype, min, max), share of rows the row mask keeps or None, the kernels
# with their slot kinds); dictionary codes are int32, EXTRACT(year) int64,
# the CAST int32; TPC-H Q1's date filter keeps ~98% of the rows, Q6's ~2%
KEYED_SHAPES = (
    ("taxi_q1", TAXI_ROWS, ((torch.int32, 0, 1),), None,
     (("count_hist", None),)),
    ("taxi_q2", TAXI_ROWS, ((torch.int8, 0, 8),), None,
     (("groupby_sums", "float32"), ("count_hist", None))),
    ("taxi_q3", TAXI_ROWS, ((torch.int8, 0, 8), (torch.int64, 2009, 2015)),
     None, (("count_hist", None),)),
    ("taxi_q4", TAXI_ROWS, ((torch.int8, 0, 8), (torch.int64, 2009, 2015),
                            (torch.int32, 0, 33)), None,
     (("count_hist", None),)),
    ("tpch_q1", LINEITEM_ROWS, ((torch.int32, 0, 2), (torch.int32, 0, 1)),
     0.98, (("groupby_sums", "float64"), ("seg_sums_exact", "int8"),
            ("count_hist", None))),
    ("tpch_q6", LINEITEM_ROWS, (), 0.02,
     (("groupby_sums", "float64_1"), ("count_hist", None))),
)


_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms_batched(fn, calls: int = 10) -> float:
    """Device time of ``fn`` per run over ``calls`` back-to-back runs
    between two events: the host's time to issue a call, which a single
    run's events also count, hides behind the device's."""
    return cuda_ms(lambda: [fn() for _ in range(calls)]) / calls


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median device time of ``fn`` over ``repeats`` runs (after one warm
    run), by CUDA events."""
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


# -- data ---------------------------------------------------------------

def gen_taxi(rows: int):
    """NYC-taxi columns with the distributions, dtypes and seed of the JAX
    package's bench.py (``gen_data``)."""
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


def gen_lineitem(rows: int):
    """TPC-H lineitem columns with the distributions and seed of
    bench_suite.gen_lineitem."""
    rng = np.random.default_rng(13)
    year_secs = 365 * 86400
    ship = np.int64(694224000) + rng.integers(0, 7 * year_secs, rows)
    return {
        "l_quantity": rng.integers(1, 51, rows).astype(np.int8),
        "l_extendedprice": (rng.gamma(3.0, 12000.0, rows)).astype(np.float64),
        "l_discount": np.round(rng.uniform(0.0, 0.1, rows), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, rows), 2),
        "l_returnflag": rng.integers(0, 3, rows).astype(np.int8),
        "l_linestatus": rng.integers(0, 2, rows).astype(np.int8),
        "l_shipdate": ship,
    }


def gen_nulls(rows: int):
    """g in [0, 1000); int64 x and float64 y, each with 10% NULLs."""
    rng = np.random.default_rng(29)
    g = rng.integers(0, 1000, rows)
    x = rng.integers(-10**12, 10**12, rows)
    y = rng.normal(50.0, 20.0, rows)
    return {
        "g": g,
        "x": np.ma.MaskedArray(x, rng.random(rows) < 0.1),
        "y": np.ma.MaskedArray(y, rng.random(rows) < 0.1),
    }


def gen_join(scale: float = 1.0, seed: int = 11):
    """(trips_j, payments_j) of bench_suite.bench_join (seed 11) and, with
    ``seed=17``, of bench_zipf_join: 100M probe keys into a 10M-row build
    whose keys are a permutation of [0, 10M); the zipf(1.3) probe keys are
    clipped into the build's range."""
    n_probe = int(100_000_000 * scale)
    n_build = int(10_000_000 * scale)
    rng = np.random.default_rng(seed)
    if seed == 17:
        k = np.minimum(rng.zipf(1.3, n_probe), n_build).astype(np.int64) - 1
    else:
        k = rng.integers(0, n_build, n_probe)
    trips = {"k": k, "amt": rng.gamma(2.0, 10.0, n_probe).astype(np.float32)}
    payments = {"k": rng.permutation(n_build),
                "fee": rng.gamma(1.0, 2.0, n_build).astype(np.float32)}
    return trips, payments


def gen_hash_join(probe_rows: int, build_rows: int):
    """A join the perfect route refuses: ``build_rows`` distinct even keys
    over [0, 2^40) (a range far above ``perfect_hash_range_limit``), and
    ``probe_rows`` probe keys, 90% drawn from the build keys, 10% odd (in
    no build row) and 1% NULL.  Returns (probe, build, the build row of
    each probe key, -1 for an odd one): the oracle's matches."""
    rng = np.random.default_rng(19)
    u = np.unique(rng.integers(0, 1 << 39, build_rows + build_rows // 8))
    keys = 2 * rng.permutation(u)[:build_rows]
    row = rng.integers(0, build_rows, probe_rows)
    row[rng.random(probe_rows) >= 0.9] = -1
    k = np.where(row >= 0, keys[row],
                 2 * rng.integers(0, 1 << 39, probe_rows) + 1)
    probe = {"k": np.ma.MaskedArray(k, rng.random(probe_rows) < 0.01),
             "amt": rng.gamma(2.0, 10.0, probe_rows).astype(np.float32)}
    build = {"k": keys,
             "fee": rng.gamma(1.0, 2.0, build_rows).astype(np.float32)}
    return probe, build, row


def gen_tpch_q3(scale: float = 1.0):
    """(customer3, orders3, lineitem3) of bench_suite.bench_tpch_q3 (seed
    23): 1.5M customers, 15M orders and 60M lineitem rows at scale 1.
    o_orderdate and l_shipdate are seconds since the epoch (TIMESTAMP(s)
    NOT NULL, ``Q3_SCHEMA``)."""
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
    return customer, orders, lineitem


def q3_schema(types, table: str):
    """Declared types of a Q3 table: its timestamps are in seconds."""
    cols = {"orders3": "o_orderdate", "lineitem3": "l_shipdate"}
    if table not in cols:
        return None
    return {cols[table]: types.timestamp(types.TimeUnit.SECOND, False)}


TPCH_Q3 = (
    "SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
    "o_orderdate, o_shippriority "
    "FROM customer3, orders3, lineitem3 "
    "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
    "AND l_orderkey = o_orderkey "
    "AND o_orderdate < TIMESTAMP '1995-03-15 00:00:00' "
    "AND l_shipdate > TIMESTAMP '1995-03-15 00:00:00' "
    "GROUP BY l_orderkey, o_orderdate, o_shippriority "
    "ORDER BY revenue DESC, o_orderdate LIMIT 10")
J5_IN = ("SELECT COUNT(*), SUM(amt) FROM trips_j "
         "WHERE k IN (SELECT k FROM payments_j WHERE fee > 4.0)")


# -- phase 3 ------------------------------------------------------------

# H100 SXM device memory, NVIDIA's data sheet: the rate bound_ms divides by
HBM_BYTES_PER_S = 3.35e12

# slots of each kernel case: (slot kind, columns, bytes per value)
SLOT_SHAPES = {None: (0, 0), "bool": (2, 1), "int8": (1, 1), "int64": (1, 8),
               "float32": (1, 4), "float64": (4, 8), "float64_1": (1, 8)}


def bound_ms(n: int, kind, e: int, id_bytes: int = 4) -> float:
    """Least time of a histogram on the card: the ids (``id_bytes`` a
    row: 4 B of gid, or the keys at their widths and the mask bytes of a
    dense-key source) and the slots read once, S x E 8-byte sums written
    once (E counts for K4), over the device-memory rate; the kernels do
    1 add a value, far under the card's operation rate."""
    cols, width = SLOT_SHAPES[kind]
    nbytes = id_bytes * n + n * cols * width + 8 * max(cols, 1) * e
    return nbytes / HBM_BYTES_PER_S * 1e3


def keyed_source(hist, keys, rows: int, keep, gen, dev):
    """A dense-key source over random keys, each uniform over its
    (dtype, min, max), with a row mask keeping a ``keep`` share of the
    rows (None: no mask); its bytes a row."""
    cols = [torch.randint(lo, hi + 1, (rows,), device=dev, generator=gen,
                          dtype=dtype) for dtype, lo, hi in keys]
    mask = (None if keep is None
            else torch.rand((rows,), device=dev, generator=gen) < keep)
    src = hist.DenseKeys(tuple(cols), (None,) * len(cols),
                         tuple(lo for _, lo, _ in keys),
                         tuple(hi - lo + 1 for _, lo, hi in keys), mask, rows,
                         dev)
    return src, (sum(c.element_size() for c in cols)
                 + (0 if mask is None else 1))


def kernel_cases(hist):
    """(name, slot kind, kernel, plain version, one PyTorch call computing
    the same function or None).  K1 and K2 take a list of 1-D columns, K3
    an (N, S) tensor.  The library call is timed on in-range ids
    (gids in [0, E), what the group-by hands the kernels), where
    ``bincount`` and ``index_add_`` compute the same function; K2, K3 over
    int8 and K1 over float32 have none (the slot type differs from the
    accumulator's)."""
    def index_add(dtype):
        return lambda g, v, e: torch.zeros(
            (e, v.shape[1]), dtype=dtype, device=g.device).index_add_(0, g, v)

    return [
        ("count_hist", None, lambda g, v, e: hist.count_hist(g, e),
         lambda g, v, e: hist.count_hist_ref(g, e),
         lambda g, v, e: torch.bincount(g, minlength=e)),
        ("groupby_sums2", "bool", hist.groupby_sums2, hist.groupby_sums2_ref,
         None),
        ("seg_sums_exact", "int8", hist.seg_sums_exact,
         hist.seg_sums_exact_ref, None),
        ("seg_sums_exact", "int64", hist.seg_sums_exact,
         hist.seg_sums_exact_ref, index_add(torch.int64)),
        ("groupby_sums", "float32", hist.groupby_sums, hist.groupby_sums_ref,
         None),
        ("groupby_sums", "float64", hist.groupby_sums, hist.groupby_sums_ref,
         index_add(torch.float64)),
    ]


def kernel_phase(hist, entries, sorted_entries, card, main_shapes=(),
                 n=KERNEL_ROWS, device="cuda", keyed_shapes=()):
    """Every kernel against its plain version at ``n`` rows: over random
    group ids at each of ``entries`` segments, over sorted ids at each of
    ``sorted_entries`` (the sort route's buffers), and one kernel alone at
    each (E, rows, kernel, slot kind) of ``main_shapes``. Random ids are
    checked with ids beyond both ends (those rows drop out) and timed on
    ids in [0, E), beside the library call on the same ids.  Beside each
    random-id case the same kernel takes the ids as a dense-key source of
    one int32 key holding them (``ids`` "keys"), and each of
    ``keyed_shapes`` runs its kernels over its own keys: against the
    plain version (the id array built, then the ``*_ref``), beside the
    kernel over the prebuilt array (``array_ms``) and the time to build
    that array (``gid_ms``, the chain of passes the keys replace); the
    bound counts the keys' bytes.  ``device`` and ``n`` are for a
    rehearsal on the CPU.
    """
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    slots = {
        # K2's columns, one tensor each, as the group-by hands it the
        # validity of two nullable columns
        "bool": [torch.rand((n,), device=dev, generator=gen) < 0.9
                 for _ in range(2)],
        "int8": torch.randint(1, 51, (n, 1), device=dev, generator=gen,
                              dtype=torch.int8),
        "int64": torch.randint(-10**12, 10**12, (n, 1), device=dev,
                               generator=gen, dtype=torch.int64),
        # K1's columns, one tensor each; positive, like prices: sums
        # without cancellation, so a relative tolerance bounds the error
        # of the summation order alone
        "float32": [torch.rand((n,), device=dev, generator=gen,
                               dtype=torch.float32) * 100],
        "float64": [torch.rand((n,), device=dev, generator=gen,
                               dtype=torch.float64) * 1e4 for _ in range(4)],
    }
    slots["float64_1"] = slots["float64"][:1]
    # index_add_ takes one (N, S) source: stacked here, outside its timing
    stacked = {"int64": slots["int64"],
               "float64": torch.stack(slots["float64"], 1)}
    cases = kernel_cases(hist)
    shapes = ([(e, False, n, None) for e in entries]
              + [(e, True, n, None) for e in sorted_entries]
              + [(e, False, rows, (name, kind))
                 for e, rows, name, kind in main_shapes])
    report = {}

    def record(name, kind, e, rows, is_sorted, ids, got, want, ms,
               batched_ms, plain_ms, library_ms, bound, label="", **extra):
        err = float((got - want).abs().max()) if want.numel() else 0.0
        if got.dtype.is_floating_point:
            ok = torch.allclose(got, want, rtol=1e-10, atol=0.0)
            tol = "rtol 1e-10 (atomic float order varies)"
        else:
            ok = bool(torch.equal(got, want))
            tol = "exact"
        check(ok, f"{name}[{kind}] E={e} {ids}: kernel disagrees "
                  f"(max abs err {err})")
        more = "".join(f" {k}={v!r}" for k, v in extra.items())
        log(f"kernel {name:15s} slots={kind or '-':9s} N={rows} E={e} "
            f"ids={ids}{' ' + label if label else ''} "
            f"{'sorted ' if is_sorted else ''}ok ({tol}) "
            f"max_abs_err={err!r} kernel_ms={ms!r} "
            f"batched_ms={batched_ms!r} "
            f"plain_ms={plain_ms!r} library_ms={library_ms!r}{more} "
            f"bound_ms={bound!r} share={bound / ms!r} [{card}]")
        rec = report.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append({
            "slots": kind, "S": SLOT_SHAPES[kind][0], "E": e, "N": rows,
            "sorted": is_sorted, "ids": ids, "label": label, "ms": ms,
            "batched_ms": batched_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **extra, "bound_ms": bound,
            "share": bound / ms})

    for e, is_sorted, rows, only in shapes:
        if is_sorted:
            gid = torch.sort(torch.randint(0, e, (rows,), device=dev,
                                           generator=gen,
                                           dtype=torch.int32)).values
            check_gid = gid
        else:
            gid = torch.randint(0, e, (rows,), device=dev, generator=gen,
                                dtype=torch.int32)
            # gids beyond both ends: those rows must drop out
            check_gid = torch.randint(-2, e + 2, (rows,), device=dev,
                                      generator=gen, dtype=torch.int32)
        for name, kind, kern, ref, lib in cases:
            if only is not None and (name, kind) != only:
                continue
            v = slots[kind] if kind else None
            if v is not None and rows != n:
                v = [c[:rows] for c in v] if isinstance(v, list) else v[:rows]
            got = kern(check_gid, v, e)
            want = ref(check_gid, v, e)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: kern(gid, v, e))
            batched_ms = cuda_ms_batched(lambda: kern(gid, v, e))
            plain_ms = cuda_ms(lambda: ref(gid, v, e))
            library_ms = None
            if lib is not None:
                src = stacked.get(kind)
                src = src[:rows] if src is not None else None
                library_ms = cuda_ms(lambda: lib(gid, src, e))
            record(name, kind, e, rows, is_sorted, "array", got, want, ms,
                   batched_ms, plain_ms, library_ms, bound_ms(rows, kind, e))
            del got, want
            if is_sorted:
                continue  # the sort route's ids come from no keys
            # the same ids as one int32 key over [0, E): the kernel
            # derives them (the bound is the same 4 B a row)
            check_keys = hist.DenseKeys((check_gid,), (None,), (0,), (e,),
                                        None, rows, dev)
            keys = hist.DenseKeys((gid,), (None,), (0,), (e,), None, rows,
                                  dev)
            got = kern(check_keys, v, e)
            want = ref(check_keys, v, e)
            torch.cuda.synchronize()
            record(name, kind, e, rows, False, "keys", got, want,
                   cuda_ms(lambda: kern(keys, v, e)),
                   cuda_ms_batched(lambda: kern(keys, v, e)),
                   cuda_ms(lambda: ref(keys, v, e)), None,
                   bound_ms(rows, kind, e), array_ms=ms)
            del got, want, check_keys, keys
        del gid, check_gid
    for label, rows, key_shape, keep, kernels in keyed_shapes:
        src, id_bytes = keyed_source(hist, key_shape, rows, keep, gen, dev)
        e = src.n_entries
        gid = src.gid()[0]
        gid_ms = cuda_ms(lambda: src.gid())
        for name, kind in kernels:
            _, _, kern, ref, _ = next(c for c in cases if c[0] == name)
            v = slots[kind] if kind else None
            if v is not None and rows != n:
                v = [c[:rows] for c in v] if isinstance(v, list) else v[:rows]
            got = kern(src, v, e)
            want = ref(gid, v, e)
            torch.cuda.synchronize()
            record(name, kind, e, rows, False, "keys", got, want,
                   cuda_ms(lambda: kern(src, v, e)),
                   cuda_ms_batched(lambda: kern(src, v, e)),
                   cuda_ms(lambda: ref(src, v, e)), None,
                   bound_ms(rows, kind, e, id_bytes), label=label,
                   array_ms=cuda_ms(lambda: kern(gid, v, e)), gid_ms=gid_ms)
            del got, want
        del src, gid
    return report


# -- phase 4 ------------------------------------------------------------

def gid_counts(run) -> dict:
    """The debug timer's ``gid_keys`` and ``gid_array`` over one untimed
    run of ``run``: reductions whose ids the kernels derived from the
    keys, and those that built the id array."""
    from hdk_tpu_torch.utils import timer

    timer.enable_debug_timer(True)
    try:
        with timer.DebugTimer("gid sources"):
            run().block()
        totals = timer.span_totals()
    finally:
        timer.enable_debug_timer(False)
    return {c: sum(t.get(c, 0) for t in totals.values())
            for c in ("gid_keys", "gid_array")}


def timed_query(run, card: str, label: str, rows: int, hist, want_kernels,
                report=None, gid=None):
    """Cold run (checked), the kernels it must have launched, and the
    median warm latency of three more runs; ``report`` (a dict) receives
    the cold seconds and the warm latency.  ``gid`` (a dict) adds the
    counts of ``gid_counts`` over one more run, after the timed ones."""
    before = hist.launches()
    t0 = time.perf_counter()
    res = run()
    res.block()
    cold = time.perf_counter() - t0
    used = {k: hist.launches()[k] - before[k] for k in before}
    for k in want_kernels:
        check(used[k] > 0, f"{label}: kernel {k} never launched ({used})")
    warm = []
    for _ in range(3):
        res.block()
        t0 = time.perf_counter()
        run().block()
        warm.append(time.perf_counter() - t0)
    lat = statistics.median(warm)
    log(f"query {label}: rows={rows} cold_s={cold!r} warm_latency_s={lat!r}"
        f" rows_per_s={rows / lat!r} launches={used} [{card}]")
    if report is not None:
        report.update(cold_s=cold, warm_s=lat)
    if gid is not None:
        for name, n in gid_counts(run).items():
            gid[name] += n
    return res


def taxi_q4_entries(data) -> int:
    """Entries of taxi Q4's dense layout: passenger counts x years x
    integer distances present in the data."""
    yr = years(data["pickup_datetime"])
    dist = data["trip_distance"].astype(np.int32)
    return (9 * (int(yr.max() - yr.min()) + 1)
            * (int(dist.max()) - int(dist.min()) + 1))


def taxi_phase(hdk_mod, hdk, data, card, hist, gid=None):
    t = hdk_mod.types
    ht = hdk.import_pydict(
        dict(data), name="trips",
        schema={"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})

    res = timed_query(lambda: ht.agg("cab_type", "count").run(), card,
                      "taxi_q1", TAXI_ROWS, hist, ["count_hist"], gid=gid)
    taxi_check("q1", res.to_numpy(), data)

    res = timed_query(
        lambda: ht.agg("passenger_count", "avg(total_amount)").run(), card,
        "taxi_q2", TAXI_ROWS, hist, ["groupby_sums", "count_hist"],
        gid=gid)
    taxi_check("q2", res.to_numpy(), data)

    year_expr = lambda: ht["pickup_datetime"].extract("year").name("y")
    res = timed_query(
        lambda: ht.agg(["passenger_count", year_expr()], "count").run(),
        card, "taxi_q3", TAXI_ROWS, hist, ["count_hist"], gid=gid)
    taxi_check("q3", res.to_numpy(), data)

    res = timed_query(
        lambda: ht.agg(["passenger_count", year_expr(),
                        ht["trip_distance"].cast("int32").name("dist")],
                       "count").sort(("count", "desc")).run(),
        card, "taxi_q4", TAXI_ROWS, hist, ["count_hist"], gid=gid)
    taxi_check("q4", res.to_numpy(), data)
    hdk.drop_table("trips")


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
SCALAR_SUBQUERY = (
    "SELECT COUNT(*), SUM(l_extendedprice) FROM lineitem "
    "WHERE l_extendedprice > (SELECT AVG(l_extendedprice) FROM lineitem)")
NULLS_Q = ("SELECT g, COUNT(*), COUNT(x), SUM(x), AVG(y) FROM t "
           "GROUP BY g ORDER BY g")


def tpch_phase(hdk_mod, hdk, card, hist, gid=None):
    t = hdk_mod.types
    t0 = time.perf_counter()
    li = gen_lineitem(LINEITEM_ROWS)
    log(f"lineitem data: {LINEITEM_ROWS} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")
    hdk.import_pydict(li, name="lineitem", schema={
        "l_shipdate": t.timestamp(t.TimeUnit.SECOND, False)})

    res = timed_query(lambda: hdk.sql(TPCH_Q1), card, "tpch_q1",
                      LINEITEM_ROWS, hist,
                      ["groupby_sums", "seg_sums_exact", "count_hist"],
                      gid=gid)
    tpch_q1_check(list(res.to_numpy().values()), li, "tpch_q1")

    res = timed_query(lambda: hdk.sql(TPCH_Q6), card, "tpch_q6",
                      LINEITEM_ROWS, hist, ["groupby_sums", "count_hist"],
                      gid=gid)
    tpch_q6_check(res, li, "tpch_q6")

    res = timed_query(lambda: hdk.sql(SCALAR_SUBQUERY), card,
                      "scalar_subquery", LINEITEM_ROWS, hist, [], gid=gid)
    count, total = res.to_numpy().values()
    price = li["l_extendedprice"]
    above = price[price > price.mean()]
    equal(count, [above.size], "scalar_subquery count")
    close(total, [above.sum()], 1e-9, "scalar_subquery sum")
    hdk.drop_table("lineitem")


def nulls_phase(hdk, card, hist, gid=None):
    data = gen_nulls(NULLS_ROWS)
    hdk.import_pydict(data, name="t")
    res = timed_query(lambda: hdk.sql(NULLS_Q), card, "nulls", NULLS_ROWS,
                      hist, ["groupby_sums2", "seg_sums_exact",
                             "count_hist"], gid=gid)
    cols = list(res.to_numpy().values())
    g = data["g"]
    xv = ~np.ma.getmaskarray(data["x"])
    yv = ~np.ma.getmaskarray(data["y"])
    xsum = np.zeros(1000, np.int64)
    np.add.at(xsum, g[xv], data["x"].data[xv])
    ycnt = np.bincount(g[yv], minlength=1000)
    ysum = np.bincount(g[yv], weights=data["y"].data[yv], minlength=1000)
    equal(cols[0], np.arange(1000), "nulls keys")
    equal(cols[1], np.bincount(g, minlength=1000), "nulls count(*)")
    equal(cols[2], np.bincount(g[xv], minlength=1000), "nulls count(x)")
    equal(cols[3], xsum, "nulls sum(x)")
    close(cols[4], ysum / ycnt, 1e-9, "nulls avg(y)")
    hdk.drop_table("t")


# -- phases 5-6: the sort route -------------------------------------------

class EntryRecorder:
    """Largest segment count each histogram kernel was launched with while
    active, read from the launches themselves (``hist._launch``); the
    wrappers and their launch counters are untouched."""

    # kernel entry point prefix -> (wrapper name, position of E in args,
    # position of the range's first entry or None); K2, K3 and K4 launch
    # over entries e_lo .. e_lo + E
    ENTRY = (("hdk_count_hist", "count_hist", 3, 2),
             ("hdk_groupby_sums2_", "groupby_sums2", 5, 4),
             ("hdk_seg_sums_exact_", "seg_sums_exact", 5, 4),
             ("hdk_groupby_sums_", "groupby_sums", 4, None))

    def __init__(self, hist):
        self.hist = hist
        self.max_e = {name: 0 for _, name, _, _ in self.ENTRY}
        self._orig = None

    def __enter__(self):
        self._orig = orig = self.hist._launch

        def launch(entry, gid, *args):
            for prefix, name, pos, lo in self.ENTRY:
                if entry.startswith(prefix):
                    e = int(args[pos]) + (0 if lo is None else int(args[lo]))
                    self.max_e[name] = max(self.max_e[name], e)
                    break
            return orig(entry, gid, *args)

        self.hist._launch = launch
        return self

    def __exit__(self, *exc):
        self.hist._launch = self._orig


def gen_high_ndv(rows: int, keys: int):
    """bench_suite.bench_high_ndv's columns and seed."""
    rng = np.random.default_rng(12)
    return {"k": rng.integers(0, keys, rows), "v": rng.integers(0, 1000, rows)}


def high_ndv_phase(hdk, card, hist, rows=HIGH_NDV_ROWS, keys=HIGH_NDV_KEYS,
                   want=("count_hist", "seg_sums_exact")):
    t0 = time.perf_counter()
    data = gen_high_ndv(rows, keys)
    oracle = hn_oracle(data, keys)
    log(f"high-NDV data: {rows} rows, {oracle[0].size} distinct keys of "
        f"{keys}; data and oracle in {time.perf_counter() - t0:.1f} s")
    ht = hdk.import_pydict(data, name="ndv_t")

    res = timed_query(lambda: ht.agg("k", "count", "sum(v)").run(), card,
                      "HN1", rows, hist, want)
    hn_check("HN1", res.to_numpy(), oracle)
    log(f"HN1: group buffer cap {hdk._executor._groupby_cap} for "
        f"{oracle[0].size} groups, NDV estimate "
        f"{hdk._executor._ndv_estimate}")
    del res

    res = timed_query(
        lambda: ht.agg("k", "count").sort(("count", "desc"), limit=100).run(),
        card, "HN2", rows, hist, [k for k in want if k == "count_hist"])
    hn_check("HN2", res.to_numpy(), oracle)
    hdk.drop_table("ndv_t")


def gen_holistic(rows: int):
    """k int64 in [0, 5M) with 5% NULLs (above the dense limit: the packed
    sort route), g int32 in [0, 1000), x int64 and y float64 N(50, 20)
    with 10% NULLs each, r = round(y, 1) as a float key (no ranges: the
    NDV estimate sizes its buffer)."""
    rng = np.random.default_rng(31)
    y0 = rng.normal(50.0, 20.0, rows)
    return {
        "k": np.ma.MaskedArray(rng.integers(0, 5_000_000, rows),
                               rng.random(rows) < 0.05),
        "g": rng.integers(0, 1000, rows).astype(np.int32),
        "x": np.ma.MaskedArray(rng.integers(-10**12, 10**12, rows),
                               rng.random(rows) < 0.1),
        "y": np.ma.MaskedArray(y0, rng.random(rows) < 0.1),
        "r": np.round(y0, 1),
    }


HOLISTIC_Q1 = ("SELECT k, COUNT(*) AS n, COUNT(DISTINCT g) AS nd_g, "
               "SUM(DISTINCT g) AS sd_g, MIN(y) AS min_y, MAX(x) AS max_x, "
               "STDDEV_SAMP(y) AS sd_y, MEDIAN(y) AS med_y FROM h "
               "GROUP BY k ORDER BY k")
HOLISTIC_Q2 = ("SELECT g, COUNT(DISTINCT k) AS nd_k, QUANTILE(y, 0.25) AS q_y "
               "FROM h GROUP BY g ORDER BY g")
HOLISTIC_Q3 = ("SELECT r, APPROX_COUNT_DISTINCT(x) AS hll_x, "
               "APPROX_QUANTILE(y, 0.9) AS td_y FROM h GROUP BY r ORDER BY r")


def _spans(sorted_ids: np.ndarray):
    """(run starts, run lengths) of a sorted id array."""
    starts = np.flatnonzero(np.r_[True, sorted_ids[1:] != sorted_ids[:-1]])
    return starts, np.diff(np.r_[starts, sorted_ids.size])


def _group_quantile(ids, vals, q):
    """(group ids, exact linear-interpolated quantile per group)."""
    order = np.lexsort((vals, ids))
    sid, sv = ids[order], vals[order]
    starts, cnt = _spans(sid)
    pos = q * (cnt - 1).astype(np.float64)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    lo_v, hi_v = sv[starts + lo], sv[starts + hi]
    return sid[starts], lo_v + (hi_v - lo_v) * (pos - lo)


def _distinct_pairs(ids, vals):
    """(group ids, distinct value count, distinct value sum) per group."""
    order = np.lexsort((vals, ids))
    sid, sv = ids[order], vals[order]
    first = np.r_[True, (sid[1:] != sid[:-1]) | (sv[1:] != sv[:-1])]
    starts, _ = _spans(sid)
    csum = np.cumsum(first)
    ends = np.r_[starts[1:], sid.size]
    n_distinct = csum[ends - 1] - np.r_[0, csum[ends[:-1] - 1]]
    vsum = np.add.reduceat(np.where(first, sv, 0), starts)
    return sid[starts], n_distinct, vsum


def holistic_q1_check(out, data, what):
    k = data["k"]
    kv = ~np.ma.getmaskarray(k)
    kd = np.where(kv, np.ma.getdata(k), 5_000_000)  # NULL key last
    keys = np.unique(kd)
    equal(np.ma.getdata(out["k"])[~np.ma.getmaskarray(out["k"])],
          keys[keys < 5_000_000], f"{what} keys")
    check(np.ma.getmaskarray(out["k"]).sum() == (not kv.all()),
          f"{what}: one NULL key group")
    slot = np.searchsorted(keys, kd)
    equal(out["n"], np.bincount(slot), f"{what} count(*)")
    gid, nd, gsum = _distinct_pairs(slot, data["g"].astype(np.int64))
    equal(gid, np.arange(keys.size), f"{what} groups")
    equal(np.ma.getdata(out["nd_g"]), nd, f"{what} count(distinct g)")
    equal(np.ma.getdata(out["sd_g"]), gsum, f"{what} sum(distinct g)")
    yv = ~np.ma.getmaskarray(data["y"])
    y = np.ma.getdata(data["y"])
    n_y = np.bincount(slot[yv], minlength=keys.size)
    has_y = n_y > 0
    ymin = np.full(keys.size, np.inf)
    np.minimum.at(ymin, slot[yv], y[yv])
    equal(~np.ma.getmaskarray(out["min_y"]), has_y, f"{what} min(y) nulls")
    equal(np.ma.getdata(out["min_y"])[has_y], ymin[has_y], f"{what} min(y)")
    xv = ~np.ma.getmaskarray(data["x"])
    xmax = np.full(keys.size, np.iinfo(np.int64).min)
    np.maximum.at(xmax, slot[xv], np.ma.getdata(data["x"])[xv])
    has_x = np.bincount(slot[xv], minlength=keys.size) > 0
    equal(~np.ma.getmaskarray(out["max_x"]), has_x, f"{what} max(x) nulls")
    equal(np.ma.getdata(out["max_x"])[has_x], xmax[has_x], f"{what} max(x)")
    # STDDEV: a two-pass oracle; the engine's sum-of-squares formula
    # loses up to ~8 eps * sum(y^2) of the variance to cancellation
    s1 = np.bincount(slot[yv], weights=y[yv], minlength=keys.size)
    mean = s1 / np.maximum(n_y, 1)
    dev2 = np.bincount(slot[yv], weights=(y[yv] - mean[slot[yv]]) ** 2,
                       minlength=keys.size)
    sq = np.bincount(slot[yv], weights=y[yv] ** 2, minlength=keys.size)
    two = n_y > 1
    equal(~np.ma.getmaskarray(out["sd_y"]), two, f"{what} stddev_samp nulls")
    sd = np.sqrt(dev2[two] / (n_y[two] - 1))
    var_err = 8 * np.finfo(np.float64).eps * sq[two] / (n_y[two] - 1)
    sd_err = np.where(sd > 0, var_err / (2 * np.maximum(sd, 1e-300)),
                      np.sqrt(var_err))
    got = np.ma.getdata(out["sd_y"])[two]
    check(np.all(np.abs(got - sd) <= 1e-9 * sd + sd_err),
          f"{what} stddev_samp: outside rtol 1e-9 + the formula's bound")
    equal(~np.ma.getmaskarray(out["med_y"]), has_y, f"{what} median nulls")
    gq, med = _group_quantile(slot[yv], y[yv], 0.5)
    close(np.ma.getdata(out["med_y"])[gq], med, 1e-9, f"{what} median(y)")


def holistic_phase(hdk_mod, hdk, card, hist, rows=HOLISTIC_ROWS,
                   prefix_rows=SKETCH_PREFIX_ROWS,
                   want=("count_hist", "groupby_sums2", "seg_sums_exact",
                         "groupby_sums")):
    t0 = time.perf_counter()
    data = gen_holistic(rows)
    log(f"holistic data: {rows} rows in {time.perf_counter() - t0:.1f} s")
    hdk.import_pydict(data, name="h")
    before = hist.launches()
    res1 = timed_query(lambda: hdk.sql(HOLISTIC_Q1), card, "holistic_q1",
                       rows, hist, [k for k in want
                                    if k in ("count_hist", "groupby_sums")])
    q1 = res1.to_numpy()
    holistic_q1_check(q1, data, "holistic_q1")

    res = timed_query(lambda: hdk.sql(HOLISTIC_Q2), card, "holistic_q2",
                      rows, hist, [k for k in want if k == "count_hist"])
    out = res.to_numpy()
    kv = ~np.ma.getmaskarray(data["k"])
    _, nd, _ = _distinct_pairs(data["g"][kv].astype(np.int64),
                               np.ma.getdata(data["k"])[kv])
    equal(out["g"], np.arange(1000), "holistic_q2 keys")
    equal(out["nd_k"], nd, "holistic_q2 count(distinct k)")
    yv = ~np.ma.getmaskarray(data["y"])
    gq, q25 = _group_quantile(data["g"][yv].astype(np.int64),
                              np.ma.getdata(data["y"])[yv], 0.25)
    close(np.ma.getdata(out["q_y"])[gq], q25, 1e-9,
          "holistic_q2 quantile(y, 0.25)")

    res = timed_query(lambda: hdk.sql(HOLISTIC_Q3), card, "holistic_q3",
                      rows, hist, [])
    out = res.to_numpy()
    sketch_exact_check(out, data, hdk._executor, "holistic_q3")
    used = {k: hist.launches()[k] - before[k] for k in before}
    for k in want:
        check(used[k] > 0, f"holistic phase: kernel {k} never launched")

    # the same sketches on a prefix, on the CPU: equal to the card's
    prefix = {c: v[:prefix_rows] for c, v in data.items()}
    outs = []
    for session in (hdk, hdk_mod.HDK(device="cpu")):
        session.import_pydict(prefix, name="hp")
        outs.append(session.sql(HOLISTIC_Q3.replace("FROM h ", "FROM hp "))
                    .to_numpy())
    card_out, cpu_out = outs
    equal(card_out["r"], cpu_out["r"], "sketch prefix keys")
    equal(card_out["hll_x"], cpu_out["hll_x"], "sketch prefix HLL (exact)")
    close(np.ma.getdata(card_out["td_y"]), np.ma.getdata(cpu_out["td_y"]),
          1e-9,
          "sketch prefix t-digest")
    log(f"sketches on a {prefix_rows}-row prefix: card equals CPU (HLL "
        f"exactly, t-digest to rtol 1e-9)")
    hdk.drop_table("hp")

    # a group buffer below the group count: exactly one widen-retry
    small = hdk_mod.HDK(device=hdk.device.type,
                        **{"exec.group_by.default_max_groups": 1 << 20})
    small.import_pydict(data, name="h")
    got = small.sql(HOLISTIC_Q1).to_numpy()
    attempts = small._executor._groupby_attempts
    check(attempts == 2, f"retry session: {attempts} attempts, want 2")
    for name in q1:
        equal(np.ma.getmaskarray(got[name]), np.ma.getmaskarray(q1[name]),
              f"retry session {name} nulls")
        if q1[name].dtype.kind == "f":
            close(np.ma.filled(got[name], 0.0), np.ma.filled(q1[name], 0.0),
                  1e-9, f"retry session {name}")
        else:
            equal(np.ma.getdata(got[name]), np.ma.getdata(q1[name]),
                  f"retry session {name}")
    log(f"retry session: default_max_groups 2^20 < {len(q1['n'])} "
        f"groups, {attempts} attempts, same result")
    small.drop_table("h")
    hdk.drop_table("h")


def sketch_exact_check(out, data, executor, what):
    """HLL within 4 standard errors (1.04/sqrt(m)) of the exact distinct
    count, plus one for a register collision of linear counting; the
    t-digest's 0.9-quantile within 1% rank (plus one row) of the group's
    values."""
    r = data["r"]
    keys = np.unique(r)
    equal(out["r"], keys, f"{what} keys")
    slot = np.searchsorted(keys, r)
    xv = ~np.ma.getmaskarray(data["x"])
    _, nd, _ = _distinct_pairs(slot[xv], np.ma.getdata(data["x"])[xv])
    has_x = np.bincount(slot[xv], minlength=keys.size) > 0
    exact = np.zeros(keys.size, np.int64)
    exact[has_x] = nd
    from hdk_tpu_torch.ops import sketches

    g = executor.config.exec.group_by
    cap = executor._groupby_cap
    p = sketches.effective_hll_p(g.hll_precision, cap, g.hll_register_budget)
    bound = 4 * 1.04 / np.sqrt(1 << p)
    est = out["hll_x"]
    rel = np.abs(est - exact) / np.maximum(exact, 1)
    check(np.all(np.abs(est - exact) <= bound * exact + 1),
          f"{what} HLL beyond its error bound (max rel {rel.max()})")
    yv = ~np.ma.getmaskarray(data["y"])
    y = np.ma.getdata(data["y"])
    order = np.lexsort((y[yv], slot[yv]))
    sid, sv = slot[yv][order], y[yv][order]
    starts, cnt = _spans(sid)
    worst = 0.0
    qv = np.ma.getdata(out["td_y"])
    for gi, st, n in zip(sid[starts], starts, cnt):
        vals = sv[st:st + n]
        lo = np.searchsorted(vals, qv[gi], "left") / n
        hi = np.searchsorted(vals, qv[gi], "right") / n
        err = 0.0 if lo <= 0.9 <= hi else min(abs(lo - 0.9), abs(hi - 0.9))
        check(err <= 0.01 + 1.0 / n,
              f"{what} t-digest group {gi}: rank error {err}")
        worst = max(worst, err)
    log(f"{what}: HLL p={p} max rel err {rel.max()!r} (bound "
        f"{bound!r}); t-digest max rank err {worst!r} over {keys.size} "
        f"groups")


# -- phase 7: joins -------------------------------------------------------

# the route label of each candidate of the join route A/B
JOIN_LABEL = {"spread": "spread", "value": "perfect", "hash": "hash"}
# TPC-H Q3's warm ms before a warm run skipped its build subtrees
# (PERF.md §5: chip_smoke.py on one H100 80GB HBM3 at 700 W)
J4_WARM_MS_BEFORE_SKIP = 14.540610999972614


def join_query(run, card, label, rows, hist, executor, route=None, want=(),
               inadmissible=(), admissible=()):
    """Cold run (checked for the kernels it must launch), then
    exploration runs until the plan A/B and every route A/B the query
    reaches are settled (a run that explores nothing), then three warm
    runs that must build no join table.  ``route``: the label the warm
    runs must show; None takes the settled join route A/B's winner.
    ``inadmissible`` / ``admissible``: candidates that must measure +inf
    / a finite time.  Logs the cold time, each candidate's measured ms,
    the median warm latency and rows/s; returns (result, {candidate:
    measured ms} of the query's last join route A/B, warm seconds)."""
    before = hist.launches()
    builds0 = executor._join_builds
    fb, pfb = executor._feedback, executor._plan_feedback
    seen = []  # (signature, explored?) of each route or plan choice

    def spy_route(sig, routes, _choose=fb.choose):
        got = _choose(sig, routes)
        seen.append((sig, got[1]))
        return got

    def spy_plan(sig, variants, _choose=pfb.choose):
        got = _choose(sig, variants)
        seen.append((sig, got[1] is not None))
        return got

    fb.choose, pfb.choose = spy_route, spy_plan
    try:
        t0 = time.perf_counter()
        res = run()
        res.block()
        cold = time.perf_counter() - t0
        used = {k: hist.launches()[k] - before[k] for k in before}
        for k in want:
            check(used[k] > 0, f"{label}: kernel {k} never launched "
                               f"({used})")
        explore = []
        sigs = [sig for sig, _ in seen]
        while any(m for _, m in seen):
            check(len(explore) < 10, f"{label}: the route A/Bs did not "
                                     f"settle")
            seen.clear()
            t0 = time.perf_counter()
            run().block()
            explore.append(time.perf_counter() - t0)
            sigs += [sig for sig, _ in seen]
    finally:
        del fb.choose, pfb.choose
    sigs = list(dict.fromkeys(sigs))
    plans = {k[1]: v for k, v in fb._t.items()
             if k[0].startswith("eagerplan|") and k[0] in sigs}
    tune = [s for s in sigs if s.endswith("|tunejoin")]
    measured = fb.measured(tune[-1]) if tune else {}
    ms = {r: v * 1e3 for r, v in measured.items()}
    for r in inadmissible:
        check(measured.get(r) == float("inf"),
              f"{label}: candidate {r} measured {ms.get(r)}, want +inf")
    for r in admissible:
        check(0 < measured.get(r, 0) < float("inf"),
              f"{label}: candidate {r} measured {ms.get(r)}, want a time")
    if route is None:
        check(bool(tune), f"{label}: no join route A/B")
        route = JOIN_LABEL[min(measured, key=measured.get)]
    log(f"join {label}: exploration runs_s={explore!r} "
        f"route_ab_ms={ms!r} plan_ab_s={plans!r} [{card}]")
    builds = executor._join_builds - builds0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        run().block()
        warm.append(time.perf_counter() - t0)
        check(executor._join_route == route,
              f"{label}: route {executor._join_route}, want {route}")
    check(executor._join_builds == builds0 + builds,
          f"{label}: a warm run built a join table again")
    lat = statistics.median(warm)
    log(f"join {label}: route={route} rows={rows} cold_s={cold!r} "
        f"warm_latency_s={lat!r} rows_per_s={rows / lat!r} "
        f"cold_builds={builds} warm_builds=0 launches={used} [{card}]")
    return res, ms, lat


def drop_tables(hdk, *names):
    """Drop tables (and with them their columns' device copies)."""
    for name in names:
        hdk.drop_table(name)


def join_phase(hdk_mod, card, hist, device="cuda", scale=1.0,
               hash_rows=(100_000_000, 10_000_000),
               want_q3=("groupby_sums",), spread_min_rows=None):
    """J1-J5 in a session of their own, each against a numpy oracle:
    counts and keys exactly, sums of float32 values to rtol 1e-6.  Each
    join takes the route its route A/B settles on (J4: the recycled build
    side); J1 again in a session without route feedback must take the
    spread route (``spread_min_rows`` lowers ``spread_join_min_rows``
    there, for a run below its 4M probe rows)."""
    hdk = hdk_mod.HDK(device=device)
    ex = hdk._executor
    spread_ok = (("spread", "value", "hash")
                 if int(100_000_000 * scale)
                 >= hdk.config.exec.join.spread_join_min_rows else ())

    # J1: 100M probe rows into a 10M-row build (bench_suite.bench_join)
    trips, payments = gen_join(scale, seed=11)
    n_probe = trips["k"].size
    fee_of = np.empty(payments["k"].size, np.float64)
    fee_of[payments["k"]] = payments["fee"]
    tj = hdk.import_pydict(trips, name="trips_j")
    pj = hdk.import_pydict(payments, name="payments_j")
    res, _, _ = join_query(
        lambda: tj.join(pj, "k", "k").agg([], "count", "sum(fee)").run(),
        card, "J1", n_probe, hist, ex, admissible=spread_ok)
    count, fee = res.to_numpy().values()
    equal(count, [n_probe], "J1 count")
    close(fee, [fee_of[trips["k"]].sum()], 1e-6, "J1 sum(fee)")

    # J5: an IN subquery over J1's tables (a SEMI join: no spread route)
    # (its filtered build side is recycled from the second run on, which
    # bypasses the route A/B)
    res, _, _ = join_query(lambda: hdk.sql(J5_IN), card, "J5", n_probe,
                           hist, ex, route="perfect(recycled)",
                           inadmissible=("spread",))
    count, amt = res.to_numpy().values()
    in_set = np.zeros(payments["k"].size, bool)
    in_set[payments["k"][payments["fee"].astype(np.float64) > 4.0]] = True
    sel = in_set[trips["k"]]
    equal(count, [int(sel.sum())], "J5 count")
    close(amt, [trips["amt"][sel].astype(np.float64).sum()], 1e-6, "J5 sum")
    del sel, in_set
    drop_tables(hdk, "trips_j", "payments_j")

    # J1 forced onto the spread route: without route feedback the static
    # order (spread > value > hash) applies; J1's build keys are a
    # permutation of [0, 10M) (a complete table) and fee is float32
    cfg = {"exec.enable_route_feedback": False}
    if spread_min_rows is not None:
        cfg["exec.join.spread_join_min_rows"] = spread_min_rows
    hs = hdk_mod.HDK(device=device, **cfg)
    ts_ = hs.import_pydict(trips, name="trips_s")
    ps_ = hs.import_pydict(payments, name="payments_s")
    res, _, _ = join_query(
        lambda: ts_.join(ps_, "k", "k").agg([], "count", "sum(fee)").run(),
        card, "J1_forced_spread", n_probe, hist, hs._executor,
        route="spread")
    count, fee = res.to_numpy().values()
    equal(count, [n_probe], "J1 spread count")
    close(fee, [fee_of[trips["k"]].sum()], 1e-6, "J1 spread sum(fee)")
    drop_tables(hs, "trips_s", "payments_s")
    del hs, ts_, ps_

    # J2: zipf(1.3) probe keys (bench_suite.bench_zipf_join), in a session
    # of its own: the route A/B keys its times by plan shape, which J2
    # shares with J1
    trips, payments = gen_join(scale, seed=17)
    fee_of[payments["k"]] = payments["fee"]
    hz = hdk_mod.HDK(device=device)
    tz = hz.import_pydict(trips, name="trips_z")
    pz = hz.import_pydict(payments, name="payments_z")
    res, _, _ = join_query(
        lambda: tz.join(pz, "k", "k").agg([], "count", "sum(fee)").run(),
        card, "J2", n_probe, hist, hz._executor, admissible=spread_ok)
    count, fee = res.to_numpy().values()
    equal(count, [n_probe], "J2 count")
    close(fee, [fee_of[trips["k"]].sum()], 1e-6, "J2 sum(fee)")
    del trips, payments, fee_of
    drop_tables(hz, "trips_z", "payments_z")
    del hz, tz, pz

    # J3: the sorted-hash route (build keys spread over [0, 2^40): no
    # perfect table, so neither spread nor value)
    probe, build, row = gen_hash_join(*hash_rows)
    th = hdk.import_pydict(probe, name="probe_h")
    bh = hdk.import_pydict(build, name="build_h")
    found = (row >= 0) & ~np.ma.getmaskarray(probe["k"])
    fee_sum = build["fee"][row[found]].astype(np.float64).sum()
    res, _, _ = join_query(
        lambda: th.join(bh, "k", "k").agg([], "count", "sum(fee)").run(),
        card, "J3_inner", hash_rows[0], hist, ex,
        inadmissible=("spread", "value"))
    count, fee = res.to_numpy().values()
    equal(count, [int(found.sum())], "J3 inner count")
    close(fee, [fee_sum], 1e-6, "J3 inner sum(fee)")
    res, _, _ = join_query(lambda: th.join(bh, "k", "k", how="left").agg(
        [], "count", "count(fee)").run(), card, "J3_left", hash_rows[0],
        hist, ex, inadmissible=("spread", "value"))
    count, n_fee = res.to_numpy().values()
    equal(count, [hash_rows[0]], "J3 left count(*)")
    equal(count - n_fee, [hash_rows[0] - int(found.sum())],
          "J3 left NULL fee count")
    del probe, build, row, found
    drop_tables(hdk, "probe_h", "build_h")

    # J4: TPC-H Q3 (bench_suite.bench_tpch_q3); its warm runs skip the
    # filtered build subtrees and read the recycled tables
    tables = dict(zip(("customer3", "orders3", "lineitem3"),
                      gen_tpch_q3(scale)))
    for name, data in tables.items():
        hdk.import_pydict(data, name=name,
                          schema=q3_schema(hdk_mod.types, name))
    res, _, lat = join_query(
        lambda: hdk.sql(TPCH_Q3), card, "J4_tpch_q3",
        tables["lineitem3"]["l_orderkey"].size, hist, ex,
        route="perfect(recycled)", want=want_q3)
    check(bool(ex._join_skip_rhs), "J4: the warm runs skipped no build "
                                   "subtree")
    log(f"join J4_tpch_q3: warm_ms={lat * 1e3!r} against "
        f"{J4_WARM_MS_BEFORE_SKIP!r} before build subtrees were skipped; "
        f"skipped nodes={len(ex._recycled_nodes)} [{card}]")
    q3_check("J4", res.to_numpy(), tables)
    drop_tables(hdk, *tables)


# -- phase 8: window functions and array columns ---------------------------

ARRAY_ROWS = 10_000_000
ARRAY_WIDTH = 4
W1_SPEC = ("PARTITION BY passenger_count ORDER BY total_amount DESC, "
           "pickup_datetime")
W1 = ("SELECT passenger_count, total_amount, rn FROM (SELECT "
      "passenger_count, total_amount, ROW_NUMBER() OVER (" + W1_SPEC
      + ") AS rn FROM trips) WHERE rn <= 10 ORDER BY passenger_count, rn")
W1_RANKS = (f"SELECT RANK() OVER ({W1_SPEC}) AS r, DENSE_RANK() OVER "
            f"({W1_SPEC}) AS dr FROM trips")
W2 = ("SELECT passenger_count, COUNT(*) AS c, MAX(cs) AS mcs, SUM(lg) AS slg, "
      "SUM(ra) AS sra FROM (SELECT passenger_count, SUM(total_amount) OVER "
      "(PARTITION BY passenger_count ORDER BY pickup_datetime) AS cs, "
      "LAG(total_amount) OVER (PARTITION BY passenger_count ORDER BY "
      "pickup_datetime) AS lg, AVG(trip_distance) OVER (PARTITION BY "
      "cab_type ORDER BY pickup_datetime ROWS BETWEEN 6 PRECEDING AND "
      "CURRENT ROW) AS ra FROM trips) GROUP BY passenger_count "
      "ORDER BY passenger_count")
W3 = ("SELECT COUNT(*) AS c, SUM(rev) AS s FROM (SELECT "
      "SUM(l_extendedprice * (1 - l_discount)) OVER (PARTITION BY "
      "l_orderkey) AS rev, COUNT(*) OVER (PARTITION BY l_orderkey) AS nl "
      "FROM lineitem3) WHERE rev > 100000 AND nl >= 5")
# the kernels W3's whole-partition SUM and COUNT launch (over sorted ids)
WINDOW_KERNELS = ("groupby_sums", "count_hist")
PICKUP_BASE = 1356998400  # gen_taxi's first pickup second


def window_order(*keys):
    """Row order of a window sort over non-negative integer keys (each
    (values, bits), most significant first), ties by row.  Least
    significant keys first, each pass one ``np.sort`` of the keys it
    takes packed above the row's rank in the order so far (which makes
    every pass stable); as many keys a pass as fit in 63 bits."""
    n = keys[0][0].size
    rank_bits = max(1, int(n - 1).bit_length())
    passes, cur, bits = [], [], rank_bits
    for values, b in reversed(keys):
        check(b + rank_bits <= 63, "window oracle key wider than a pass")
        if bits + b > 63:
            passes.append(cur)
            cur, bits = [], rank_bits
        cur.insert(0, (values, b))
        bits += b
    passes.append(cur)
    order = np.arange(n, dtype=np.int64)
    for group in passes:
        packed = np.zeros(n, np.int64)
        for values, b in group:
            packed = (packed << b) | values[order].astype(np.int64)
        packed = np.sort((packed << rank_bits)
                         | np.arange(n, dtype=np.int64))
        order = order[packed & ((1 << rank_bits) - 1)]
    return order


def spans(sorted_part):
    """(partition start per sorted row, boundary flags) of sorted keys."""
    n = sorted_part.size
    b = np.ones(n, bool)
    b[1:] = sorted_part[1:] != sorted_part[:-1]
    pos = np.arange(n)
    return np.maximum.accumulate(np.where(b, pos, 0)), b


def w1_oracle(data):
    """W1's ten rows per passenger count, and the full RANK and DENSE_RANK
    columns, from one sort of (passenger_count, total_amount DESC,
    pickup_datetime)."""
    pc = data["passenger_count"].astype(np.int64)
    amount = data["total_amount"]
    check(bool((amount >= 0).all()), "W1 oracle: a negative total_amount")
    desc = (np.int64(0x7FFFFFFF) - amount.view(np.int32).astype(np.int64))
    pick = data["pickup_datetime"] - PICKUP_BASE
    order = window_order((pc, 4), (desc, 31), (pick, 27))
    spc, samt, spick = pc[order], amount[order], pick[order]
    start, pb = spans(spc)
    tb = pb.copy()
    tb[1:] |= (samt[1:] != samt[:-1]) | (spick[1:] != spick[:-1])
    pos = np.arange(order.size)
    rank_s = np.maximum.accumulate(np.where(tb, pos, 0)) - start + 1
    tiec = np.cumsum(tb)
    dense_s = tiec - tiec[start] + 1
    rn = pos - start + 1
    top = rn <= 10
    rank = np.empty_like(rank_s)
    rank[order] = rank_s
    dense = np.empty_like(dense_s)
    dense[order] = dense_s
    return (spc[top], samt[top], rn[top]), rank, dense


def w2_oracle(data):
    """W2's columns per passenger count: COUNT(*), MAX of the cumulative
    float32 sum (each partition's total: the values are positive), SUM of
    LAG (the total but the partition's last row in pickup order) and SUM
    of the 7-row moving average over (cab_type, pickup_datetime), summed
    directly over ``sliding_window_view``."""
    pc = data["passenger_count"].astype(np.int64)
    amount = data["total_amount"].astype(np.float64)
    pick = data["pickup_datetime"] - PICKUP_BASE
    total = np.bincount(pc, weights=amount, minlength=9)
    order = window_order((pc, 4), (pick, 27))
    _, pb = spans(pc[order])
    last = order[np.append(np.flatnonzero(pb)[1:] - 1, order.size - 1)]
    slg = total.copy()
    slg[pc[last]] -= amount[last]
    del order, pb
    cab = data["cab_type"].astype(np.int64)
    dist = data["trip_distance"].astype(np.float64)
    order = window_order((cab, 1), (pick, 27))
    ra = np.empty(order.size)
    scab = cab[order]
    for c in np.unique(scab):
        rows = order[scab == c]
        padded = np.concatenate([np.zeros(6), dist[rows]])
        sums = np.lib.stride_tricks.sliding_window_view(padded, 7).sum(axis=1)
        ra[rows] = sums / np.minimum(np.arange(1, rows.size + 1), 7)
    return (np.bincount(pc, minlength=9), total, slg,
            np.bincount(pc, weights=ra, minlength=9))


def w3_oracle(lineitem):
    """(c, s, slack) of W3: each order's revenue summed in float64 and
    rounded to float32, as the engine's FLOAT column holds it; ``slack``
    is the rows of orders whose revenue lies within one float32 ulp of
    100000, which either side of the cut may count."""
    lk = lineitem["l_orderkey"]
    rev_row = (lineitem["l_extendedprice"]
               * (np.float32(1) - lineitem["l_discount"]))
    rev = np.bincount(lk, weights=rev_row.astype(np.float64)).astype(
        np.float32)
    nl = np.bincount(lk, minlength=rev.size)
    sel = (rev > np.float32(100000)) & (nl >= 5)
    ulp = np.spacing(np.float32(100000))
    near = np.abs(rev.astype(np.float64) - 100000.0) <= ulp
    return (int(nl[sel].sum()), float((rev[sel].astype(np.float64)
                                       * nl[sel]).sum()),
            int(nl[near & (nl >= 5)].sum()))


def gen_arrays(rows: int, width: int = ARRAY_WIDTH):
    """An int32 array column of ``rows`` lists of 0..width elements in
    [0, 1000), 10% of the elements NULL (absent), as a 2-D masked array
    (True = absent)."""
    rng = np.random.default_rng(37)
    lengths = rng.integers(0, width + 1, rows)
    present = ((np.arange(width)[None, :] < lengths[:, None])
               & (rng.random((rows, width)) >= 0.1))
    return (rng.integers(0, 1000, (rows, width)).astype(np.int32),
            present)


def window_phase(hdk_mod, card, hist, device="cuda", taxi_rows=TAXI_ROWS,
                 tpch_scale=1.0, array_rows=ARRAY_ROWS,
                 want_w3=WINDOW_KERNELS):
    """W1-W4 in a session of their own, each against numpy: W1 the top 10
    per passenger count by ROW_NUMBER (and, cold, the full RANK and
    DENSE_RANK columns), W2 a cumulative SUM, a LAG and a 7-row moving
    AVG under a GROUP BY, W3 the partition totals of TPC-H lineitem over
    15M orders, W4 TOP_K/BOTTOM_K per passenger count with UNNEST and an
    imported array column (CARDINALITY, a subscript, UNNEST + GROUP BY)."""
    hdk = hdk_mod.HDK(device=device)
    t = hdk_mod.types
    t0 = time.perf_counter()
    data = gen_taxi(taxi_rows)
    log(f"window phase: taxi {taxi_rows} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")
    ht = hdk.import_pydict(
        dict(data), name="trips",
        schema={"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})

    # W1: top 10 per group by ROW_NUMBER
    t0 = time.perf_counter()
    (w1_pc, w1_amt, w1_rn), rank, dense = w1_oracle(data)
    log(f"W1 oracle in {time.perf_counter() - t0:.1f} s")
    res = timed_query(lambda: hdk.sql(W1), card, "W1", taxi_rows, hist, [])
    out = res.to_numpy()
    equal(out["passenger_count"], w1_pc, "W1 passenger_count")
    equal(out["total_amount"], w1_amt, "W1 total_amount")
    equal(out["rn"], w1_rn, "W1 rn")
    check(out["rn"].size == 90 or taxi_rows < 90 * 9, "W1 rows")
    t0 = time.perf_counter()
    out = hdk.sql(W1_RANKS).to_numpy()
    equal(out["r"], rank, "W1 RANK column")
    equal(out["dr"], dense, "W1 DENSE_RANK column")
    log(f"W1 RANK and DENSE_RANK: {rank.size} rows equal the oracle "
        f"(query and check {time.perf_counter() - t0:.1f} s)")
    del out, rank, dense

    # W2: cumulative SUM, LAG and a moving AVG under a GROUP BY
    t0 = time.perf_counter()
    cnt, total, slg, sra = w2_oracle(data)
    log(f"W2 oracle in {time.perf_counter() - t0:.1f} s")
    res = timed_query(lambda: hdk.sql(W2), card, "W2", taxi_rows, hist, [])
    out = res.to_numpy()
    present = np.flatnonzero(cnt)
    equal(out["passenger_count"], present, "W2 keys")
    equal(out["c"], cnt[present], "W2 count")
    close(out["mcs"], total[present].astype(np.float32), 1e-6, "W2 max(cs)")
    close(out["slg"], slg[present], 1e-6, "W2 sum(lg)")
    close(out["sra"], sra[present], 1e-9, "W2 sum(ra)")

    # W4 (taxi): TOP_K / BOTTOM_K per passenger count, then UNNEST
    agg = lambda: ht.agg("passenger_count",
                         ht["total_amount"].top_k(5).name("tk"),
                         ht["trip_distance"].bottom_k(5).name("bk")).run()
    res = timed_query(agg, card, "W4_topk", taxi_rows, hist, [])
    pc = data["passenger_count"]
    for col, name, largest in (("total_amount", "tk", True),
                               ("trip_distance", "bk", False)):
        rows = res.scan.unnest(name).run().to_numpy()
        want_pc, want_v = [], []
        for p in present:
            v = np.sort(data[col][pc == p])
            v = v[::-1][:5] if largest else v[:5]
            want_pc += [p] * v.size
            want_v.append(v)
        equal(rows["passenger_count"], want_pc, f"W4 {name} keys")
        equal(rows[name], np.concatenate(want_v), f"W4 {name} values")
    log(f"W4 top_k/bottom_k: {2 * len(want_pc)} unnested rows equal "
        f"the oracle")
    hdk.drop_table("trips")
    del data, ht, res, pc

    # W3: partition totals over 15M orders (groupby.transform)
    tables = gen_tpch_q3(tpch_scale)
    lineitem = tables[2]
    del tables
    hdk.import_pydict(lineitem, name="lineitem3",
                      schema=q3_schema(t, "lineitem3"))
    c, s, slack = w3_oracle(lineitem)
    res = timed_query(lambda: hdk.sql(W3), card, "W3",
                      lineitem["l_orderkey"].size, hist, want_w3)
    out = res.to_numpy()
    check(abs(int(out["c"][0]) - c) <= slack,
          f"W3 count {int(out['c'][0])} vs {c} (slack {slack})")
    close(out["s"], [s], 1e-6, "W3 sum(rev)")
    hdk.drop_table("lineitem3")
    del lineitem

    # W4 (arrays): an imported int32 array column
    values, alive = gen_arrays(array_rows)
    ha = hdk.import_pydict({"id": np.arange(array_rows),
                            "xs": np.ma.MaskedArray(values, ~alive)},
                           name="arrs")
    res = timed_query(lambda: ha.proj(n=ha["xs"].cardinality(),
                                      x1=ha["xs"].at(1)).run(),
                      card, "W4_cardinality", array_rows, hist, [])
    out = res.to_numpy()
    equal(out["n"], alive.sum(axis=1), "W4 cardinality")
    equal(np.ma.getmaskarray(out["x1"]), ~alive[:, 1], "W4 xs[1] NULLs")
    equal(np.ma.getdata(out["x1"])[alive[:, 1]], values[alive[:, 1], 1],
          "W4 xs[1]")
    res = timed_query(lambda: ha.unnest("xs").agg("xs", "count").run(),
                      card, "W4_unnest", array_rows * ARRAY_WIDTH, hist,
                      [])
    out = res.to_numpy()
    keys, counts = np.unique(values[alive], return_counts=True)
    equal(out["xs"], keys, "W4 unnest keys")
    equal(out["count"], counts, "W4 unnest count")
    hdk.drop_table("arrs")


# -- phase 9: executor controls --------------------------------------------

# TPC-H lineitem at SF100 (600M rows; 6M rows a scale factor): Q1 reads
# 35 bytes a row (21.0 GB) and Q6 25 (15.0 GB), both over the default scan
# budget (half of the 12 GiB device cache budget), so both stream
STREAM_LINEITEM_ROWS = 600_000_000
Q1_ROW_BYTES = 35  # l_quantity, l_returnflag, l_linestatus 1 each; 4 x 8
Q6_ROW_BYTES = 25  # l_quantity 1; l_extendedprice, l_discount, l_shipdate
STREAM_KERNELS = ("groupby_sums", "seg_sums_exact", "count_hist")
MONTH_Q = ("SELECT passenger_count, COUNT(*) AS c FROM trips_sorted "
           "WHERE pickup_datetime >= TIMESTAMP '2014-03-01 00:00:00' "
           "AND pickup_datetime < TIMESTAMP '2014-04-01 00:00:00' "
           "GROUP BY passenger_count")
NULLS_GROUP_Q = ("SELECT g, COUNT(*), COUNT(x), SUM(x), AVG(y) FROM t "
                 "GROUP BY g")


def h2d_rates():
    """(pinned, pageable) host-to-device bytes/s of a 1 GiB copy: the
    pinned rate bounds a stream that copies its chunks from the host."""
    n = 1 << 30
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pageable = torch.from_numpy(np.ones(n, np.uint8))
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    rates = tuple(n / (cuda_ms(lambda h=h: dev.copy_(h, non_blocking=True))
                       / 1e3) for h in (pinned, pageable))
    del pinned, pageable, dev
    return rates


def d2h_rates():
    """(pinned, pageable) device-to-host bytes/s of a 1 GiB copy; the
    pageable copy lands in fresh host memory, as ``Tensor.cpu()`` does."""
    n = 1 << 30
    dev = torch.ones(n, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pinned_s = cuda_ms(lambda: pinned.copy_(dev, non_blocking=True)) / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.cpu()
    pageable_s = time.perf_counter() - t0
    del dev, pinned
    return n / pinned_s, n / pageable_s


def streamed_query(hdk, sql, label, rows, row_bytes, card, hist, want,
                   bound_bps):
    """``timed_query`` of a query that must stream (every run in two or
    more chunks), with its GB/s beside the pinned-copy bound."""
    ex = hdk._executor
    chunks = []

    def run():
        res = hdk.sql(sql)
        res.block()
        chunks.append(ex._frag_stream_chunks)
        return res

    report = {}
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    res = timed_query(run, card, label, rows, hist, want, report)
    check(all(c is not None and c >= 2 for c in chunks),
          f"{label}: a run did not stream ({chunks} chunks)")
    gbps = rows * row_bytes / report["warm_s"] / 1e9
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else None)
    log(f"stream {label}: chunks={chunks[0]} used_bytes={rows * row_bytes} "
        f"warm_ms={report['warm_s'] * 1e3!r} rows_per_s="
        f"{rows / report['warm_s']!r} GB_per_s={gbps!r} "
        f"pinned_h2d_GB_per_s={bound_bps / 1e9!r} "
        f"bound_ms={rows * row_bytes / bound_bps * 1e3!r} "
        f"peak_device_bytes={peak} [{card}]")
    return res


def controls_phase(hdk_mod, card, hist, device="cuda",
                   lineitem_rows=STREAM_LINEITEM_ROWS, taxi_rows=TAXI_ROWS,
                   nulls_rows=NULLS_ROWS, want=STREAM_KERNELS, config=None):
    """Phase 9 in a session of its own: TPC-H Q1 and Q6 streamed over a
    lineitem table larger than the scan budget, Q1 under the watchdog
    (a long limit chunks one fragment at a time; a 1 ms limit raises),
    EXPLAIN ANALYZE of the streamed Q1, fragment skipping over
    time-ordered taxi rows, and the measured route choice of a GROUP BY
    in the tuning window; each against numpy."""
    t_phase = time.perf_counter()
    hdk = hdk_mod.HDK(device=device, **(config or {}))
    ex = hdk._executor
    ExecError = hdk_mod.exec.scalar.ExecError
    pinned_bps, pageable_bps = (h2d_rates() if device == "cuda"
                                else (float("inf"), float("inf")))
    log(f"host-to-device copy of 1 GiB: pinned {pinned_bps / 1e9!r} GB/s, "
        f"pageable {pageable_bps / 1e9!r} GB/s [{card}]")

    t0 = time.perf_counter()
    li = gen_lineitem(lineitem_rows)
    t = hdk_mod.types
    hdk.import_pydict(li, name="lineitem", schema={
        "l_shipdate": t.timestamp(t.TimeUnit.SECOND, False)})
    log(f"controls phase: lineitem {lineitem_rows} rows "
        f"({len(hdk._schema.get('lineitem').fragments)} fragments) "
        f"generated in {time.perf_counter() - t0:.1f} s")

    res = streamed_query(hdk, TPCH_Q1, "stream_tpch_q1", lineitem_rows,
                         Q1_ROW_BYTES, card, hist, want, pinned_bps)
    tpch_q1_check(list(res.to_numpy().values()), li, "stream_tpch_q1")
    res = streamed_query(hdk, TPCH_Q6, "stream_tpch_q6", lineitem_rows,
                         Q6_ROW_BYTES, card, hist, (), pinned_bps)
    tpch_q6_check(res, li, "stream_tpch_q6")

    # the watchdog: a time limit streams one fragment a chunk and checks
    # the deadline between chunks
    t0 = time.perf_counter()
    res = hdk.sql(TPCH_Q1, watchdog_time_limit_ms=600_000).block()
    secs = time.perf_counter() - t0
    frags = len(hdk._schema.get("lineitem").fragments)
    check(ex._frag_stream_chunks == frags,
          f"watchdog Q1: {ex._frag_stream_chunks} chunks, want {frags}")
    tpch_q1_check(list(res.to_numpy().values()), li, "watchdog_tpch_q1")
    log(f"watchdog Q1 (limit 600000 ms): {frags} chunks in {secs!r} s, "
        f"result equal [{card}]")
    try:
        hdk.sql(TPCH_Q1, watchdog_time_limit_ms=1).block()
        raised = None
    except ExecError as err:
        raised = err
    check(raised is not None and "watchdog" in str(raised),
          "watchdog Q1 (limit 1 ms) did not raise")
    log(f"watchdog Q1 (limit 1 ms) raised: {raised}; stream chunks "
        f"{ex._frag_stream_chunks}")

    # EXPLAIN ANALYZE of the streamed Q1: every line [ms, rows], 6 groups
    t0 = time.perf_counter()
    text = hdk.explain(TPCH_Q1, analyze=True)
    plan = text.split("\n-- ")[0].splitlines()
    for line in text.splitlines():
        log(f"explain analyze: {line}")
    check(all(line.endswith(" rows]") and " ms, " in line for line in plan),
          "explain analyze: a plan line without [ms, rows]")
    check(plan[0].endswith(", 6 rows]"), f"explain analyze root: {plan[0]}")
    check(ex._frag_stream_chunks >= 2, "explain analyze: Q1 did not stream")
    log(f"explain analyze of the streamed Q1 in "
        f"{time.perf_counter() - t0:.3f} s [{card}]")
    del li, res
    drop_tables(hdk, "lineitem")

    # fragment skipping: taxi rows in pickup order, as trip files are
    # published month by month; one month lies in one fragment
    t0 = time.perf_counter()
    taxi = gen_taxi(taxi_rows)
    taxi["pickup_datetime"].sort()
    hdk.import_pydict(taxi, name="trips_sorted", schema={
        "pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    log(f"controls phase: sorted taxi {taxi_rows} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    stats = []

    def month():
        res = hdk.sql(MONTH_Q)
        stats.append(ex._frag_prune_stats)
        return res

    res = timed_query(month, card, "pruned_month", taxi_rows, hist, ())
    check(all(st is not None and st["selected"] < st["total"]
              for st in stats), f"pruned_month: fragments {stats}")
    sel = ((taxi["pickup_datetime"] >= epoch("2014-03-01T00:00:00"))
           & (taxi["pickup_datetime"] < epoch("2014-04-01T00:00:00")))
    counts = np.bincount(taxi["passenger_count"][sel], minlength=9)
    out = res.to_numpy()
    present = np.flatnonzero(counts)
    order = np.argsort(out["passenger_count"])
    equal(out["passenger_count"][order], present, "pruned_month keys")
    equal(out["c"][order], counts[present], "pruned_month count")
    log(f"pruned_month: fragments {stats[0]['selected']} of "
        f"{stats[0]['total']}, {int(sel.sum())} rows in the month [{card}]")
    del taxi, sel
    drop_tables(hdk, "trips_sorted")

    # route feedback: a GROUP BY over 1000 dense entries (in the window
    # where both routes are timed) explores "perfect", then "sort"
    data = gen_nulls(nulls_rows)
    hdk.import_pydict(data, name="t")
    outs = []
    for i in range(4):
        t0 = time.perf_counter()
        outs.append(list(hdk.sql(NULLS_GROUP_Q).block().to_numpy()
                         .values()))
        log(f"route feedback run {i}: {time.perf_counter() - t0!r} s")
    sigs = {g for g, _r in ex._feedback._t if not g.startswith("eagerplan|")}
    check(len(sigs) == 1, f"route feedback: {len(sigs)} tuned plans")
    measured = ex._feedback.measured(next(iter(sigs)))
    check(set(measured) == {"perfect", "sort"},
          f"route feedback: routes measured {measured}")
    for cols in outs[1:]:
        order0, order1 = np.argsort(outs[0][0]), np.argsort(cols[0])
        for j, (a, b) in enumerate(zip(outs[0], cols)):
            a, b = np.ma.asarray(a)[order0], np.ma.asarray(b)[order1]
            check(np.array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
                  and (np.allclose(a.compressed(), b.compressed(), rtol=1e-9,
                                   atol=0) if j == 4 else
                       np.array_equal(a.compressed(), b.compressed())),
                  f"route feedback: column {j} differs between routes")
    log(f"route feedback: measured_s={measured!r}, all 4 results equal "
        f"[{card}]")
    hdk.drop_table("t")
    log(f"controls phase: {time.perf_counter() - t_phase:.1f} s including "
        f"data generation and the numpy oracles")


# -- phase 10: the rest of the facade ------------------------------------

STREAM_BATCHES = 10
INTEROP_ROWS = 100_000
STREAM_SCHEMA = {"cab_type": "int8", "passenger_count": "int8",
                 "total_amount": "fp32", "trip_distance": "fp32"}
STREAM_AGGS = ["count", "sum(cab_type)", "sum(total_amount)",
               "avg(total_amount)", "min(trip_distance)",
               "max(trip_distance)", "stddev(total_amount)"]
# S1 must launch K1 (the float sums), K3 (the int8 sum) and K4; U1 K1 and K4
FACADE_STREAM_KERNELS = ("groupby_sums", "seg_sums_exact", "count_hist")
FACADE_UDF_KERNELS = ("groupby_sums", "count_hist")
U32 = 2.0 ** -24  # float32's unit roundoff
IO_RECURSIVE_Q = ("WITH RECURSIVE cnt(x) AS (SELECT 0 UNION ALL SELECT x + 1 "
                  "FROM cnt WHERE x < 999) SELECT io.k, io.v FROM io "
                  "JOIN cnt ON io.k = cnt.x * 100 ORDER BY io.k")
IO_SUBSTR_Q = "SELECT k, SUBSTR(s, 2, 3) AS sub FROM io ORDER BY k"


def device_bytes() -> int:
    """Bytes of live tensors on the card, after the collector has run."""
    import gc

    gc.collect()
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def log_device_cache(phase: str) -> None:
    """The device cache manager's evictions so far and its resident bytes
    (table columns and results) at the end of a phase."""
    from hdk_tpu_torch.storage.memory import device_cache_manager

    mgr = device_cache_manager()
    log(f"{phase} done: device cache evictions={mgr.evictions} "
        f"resident_bytes={mgr.resident_bytes} budget={mgr.budget}; "
        f"device bytes allocated={device_bytes()}")


def launches_since(hist, before):
    now = hist.launches()
    return {k: now[k] - before[k] for k in now}


def stream_check(out, data, batches, what):
    """S1 against numpy: counts and the int8 sum exactly; float32 sums and
    averages to rtol 1e-6; MIN/MAX exactly; STDDEV against a two-pass
    oracle within its formula's bound: each push rounds the float32 sums
    (s, the sum of squares q) once more, and x*x rounds once, so q and s
    carry up to (batches + 1) float32 roundings, and (q - s^2/n)/(n - 1)
    up to (batches + 1) * u32 * (q + 2 s^2/n) / (n - 1) of variance."""
    pc = data["passenger_count"].astype(np.int64)
    keys = np.flatnonzero(np.bincount(pc, minlength=9))
    order = np.argsort(out["passenger_count"])
    equal(out["passenger_count"][order], keys, f"{what} keys")
    cnt = np.bincount(pc, minlength=9)[keys]
    equal(out["count"][order], cnt, f"{what} count")
    equal(out["cab_type_sum"][order],
          np.bincount(pc, weights=data["cab_type"], minlength=9)[keys]
          .astype(np.int64), f"{what} sum(cab_type)")
    x = data["total_amount"].astype(np.float64)
    s = np.bincount(pc, weights=x, minlength=9)[keys]
    close(out["total_amount_sum"][order], s, 1e-6, f"{what} sum")
    close(out["total_amount_avg"][order], s / cnt, 1e-6, f"{what} avg")
    td = data["trip_distance"]
    lo = np.full(9, np.inf, np.float32)
    hi = np.full(9, -np.inf, np.float32)
    np.minimum.at(lo, pc, td)
    np.maximum.at(hi, pc, td)
    equal(out["trip_distance_min"][order], lo[keys], f"{what} min")
    equal(out["trip_distance_max"][order], hi[keys], f"{what} max")
    mean = s / cnt
    mean9 = np.zeros(9)
    mean9[keys] = mean
    dev2 = np.bincount(pc, weights=(x - mean9[pc]) ** 2, minlength=9)[keys]
    q = np.bincount(pc, weights=x * x, minlength=9)[keys]
    sd = np.sqrt(dev2 / (cnt - 1))
    var_err = ((batches + 1) * U32 * (q + 2 * cnt * mean * mean)
               + 8 * np.finfo(np.float64).eps * q) / (cnt - 1)
    got = np.asarray(out["total_amount_stddev"][order], np.float64)
    err = np.abs(got - sd)
    bound = 1e-9 * sd + var_err / (2 * sd)
    check(np.all(err <= bound),
          f"{what} stddev: error {err.max()!r} above the bound "
          f"{bound[np.argmax(err)]!r}")


def stream_s1(hdk, data, card, hist, batches, want):
    """S1: the taxi rows pushed in ``batches`` equal batches through
    ``create_stream``; each push imports its batch, aggregates it and
    merges the partials.  Returns the launches of the stream."""
    rows = len(data["passenger_count"])
    n = rows // batches
    batch_bytes = n * sum(data[c].itemsize for c in STREAM_SCHEMA)
    mem0 = device_bytes()
    before = hist.launches()
    t_all = time.perf_counter()
    st = hdk.create_stream(STREAM_SCHEMA, ["passenger_count"], STREAM_AGGS)
    push_ms = []
    for b in range(batches):
        t0 = time.perf_counter()
        st.push({c: data[c][b * n:(b + 1) * n] for c in STREAM_SCHEMA})
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        push_ms.append((time.perf_counter() - t0) * 1e3)
    res = st.finish()
    out = res.to_numpy()
    total = time.perf_counter() - t_all
    used = launches_since(hist, before)
    for k in want:
        check(used[k] > 0, f"S1 stream: kernel {k} never launched ({used})")
    stream_check(out, {c: v[:n * batches] for c, v in data.items()},
                 batches, "S1 stream")
    del res
    mem1 = device_bytes()
    check(mem1 - mem0 <= batch_bytes,
          f"S1 stream: {mem1 - mem0} bytes left on the device after "
          f"finish(), more than one batch ({batch_bytes})")
    log(f"S1 stream: {batches} pushes of {n} rows, push_ms={push_ms!r}, "
        f"total_s={total!r}, rows_per_s={n * batches / total!r}, "
        f"device bytes after finish minus before={mem1 - mem0} "
        f"(one batch {batch_bytes}), launches={used} [{card}]")
    return used


def udf_u1(hdk_mod, hdk, ht, data, card, hist, want):
    """U1: a torch-body UDF in taxi Q2's GROUP BY, through the builder
    with ``hdk.call`` and in SQL, against numpy and against the same
    expression written with builtins; then the name registered again
    with another body."""
    t = hdk_mod.types

    def register(floor):
        hdk.register_udf(
            "fare_per_mile",
            lambda a, b: a.to(torch.float64)
            / torch.clamp(b.to(torch.float64), min=floor),
            arg_types=[t.fp64(), t.fp64()], ret_type=t.fp64())

    pc = data["passenger_count"].astype(np.int64)
    cnt = np.bincount(pc, minlength=9)
    ta = data["total_amount"].astype(np.float64)
    td = data["trip_distance"].astype(np.float64)

    def oracle(floor):
        return np.bincount(pc, weights=ta / np.maximum(td, floor),
                           minlength=9) / cnt

    def builder():
        fpm = hdk.call("fare_per_mile", ht["total_amount"],
                       ht["trip_distance"])
        return ht.agg("passenger_count", fpm.avg().name("fpm")).run()

    sql = ("SELECT passenger_count, AVG(fare_per_mile(total_amount, "
           "trip_distance)) AS fpm FROM trips GROUP BY passenger_count "
           "ORDER BY passenger_count")
    plain = ("SELECT passenger_count, AVG(total_amount / CASE WHEN "
             "trip_distance > 0.1 THEN trip_distance * 1.0 ELSE 0.1 END) "
             "AS fpm FROM trips GROUP BY passenger_count "
             "ORDER BY passenger_count")
    rows = len(pc)
    register(0.1)
    q2 = {}
    timed_query(lambda: ht.agg("passenger_count", "avg(total_amount)").run(),
                card, "U1 beside: taxi_q2", rows, hist, want, q2)
    reports = {}
    for label, run in (("builder", builder), ("sql", lambda: hdk.sql(sql)),
                       ("builtins", lambda: hdk.sql(plain))):
        reports[label] = {}
        res = timed_query(run, card, f"U1 {label}", rows, hist,
                          want if label != "builtins" else (),
                          reports[label])
        out = res.to_numpy()
        order = np.argsort(out["passenger_count"])
        equal(out["passenger_count"][order], np.arange(9), f"U1 {label} keys")
        close(out["fpm"][order], oracle(0.1), 1e-9, f"U1 {label}")
        reports[label]["out"] = np.asarray(out["fpm"])[order]
    close(reports["builder"]["out"], reports["builtins"]["out"], 1e-9,
          "U1 UDF against builtins")
    close(reports["sql"]["out"], reports["builtins"]["out"], 1e-9,
          "U1 SQL UDF against builtins")
    register(1.0)
    out = hdk.sql(sql).to_numpy()
    order = np.argsort(out["passenger_count"])
    close(out["fpm"][order], oracle(1.0), 1e-9, "U1 after re-registering")
    log(f"U1 UDF: cold_ms builder/sql/builtins/taxi_q2 = "
        f"{[reports[k]['cold_s'] * 1e3 for k in reports] + [q2['cold_s'] * 1e3]!r}, "
        f"warm_ms = "
        f"{[reports[k]['warm_s'] * 1e3 for k in reports] + [q2['warm_s'] * 1e3]!r}; "
        f"re-registered: the new body's result [{card}]")


def spill_p1(hdk, ht, data, card, mgr, h2d):
    """P1: a two-column projection of the taxi rows offloaded to host
    memory and read back; four such results under a budget that holds
    two; ``clear_device_mem``.  The device-memory checks need a card (a
    CPU session has no device bytes to count)."""
    on_card = hdk.device.type == "cuda"
    td = data["trip_distance"]
    ta = data["total_amount"]

    def project(i):
        return ht.proj(d=ht["trip_distance"].cast("fp64") + i,
                       a=ht["total_amount"] * 2).run().block()

    def read_back(res, i, what):
        out = res.to_numpy()
        equal(out["d"], td.astype(np.float64) + i, f"{what} d")
        equal(out["a"], ta * np.float32(2), f"{what} a")

    d2h = d2h_rates() if on_card else (float("inf"), float("inf"))
    res = project(1)
    nbytes = res._nbytes()
    mem0 = device_bytes()
    t0 = time.perf_counter()
    res.offload()
    secs = time.perf_counter() - t0
    mem1 = device_bytes()
    check(not on_card or mem0 - mem1 >= nbytes,
          f"P1 offload: device bytes fell by {mem0 - mem1}, less than the "
          f"result's {nbytes}")
    t0 = time.perf_counter()
    res._ensure_device()
    if on_card:
        torch.cuda.synchronize()
    back = time.perf_counter() - t0
    log(f"P1 offload: {nbytes} bytes in {secs!r} s = "
        f"{nbytes / secs / 1e9!r} GB/s device to host (1 GiB copies: "
        f"pinned {d2h[0] / 1e9!r} GB/s, pageable {d2h[1] / 1e9!r} GB/s); "
        f"reload {back!r} s = {nbytes / back / 1e9!r} GB/s host to device "
        f"(pinned 1 GiB copy {h2d / 1e9!r} GB/s); device bytes {mem0} -> "
        f"{mem1} [{card}]")
    res.offload()
    t0 = time.perf_counter()
    read_back(res, 1, "P1 read back")
    log(f"P1 read back and compared in {time.perf_counter() - t0!r} s")
    res.offload()
    s = res.scan
    out = s.agg([], s["a"].sum().name("sa"), s["d"].max().name("md"),
                "count").run().to_numpy()
    close(out["sa"], [ta.astype(np.float64).sum() * 2], 1e-6,
          "P1 scan sum(a)")
    equal(out["md"], [np.float64(td.max()) + 1], "P1 scan max(d)")
    equal(out["count"], [len(td)], "P1 scan count")
    hdk.drop_table(res._registered.name)
    del res, s

    # LRU: room for the projection's two columns and two and a half
    # results; each projection touches its columns, so the results are
    # the least recently used entries
    hdk.clear_device_mem()
    old_budget = mgr.budget
    evictions0 = mgr.evictions
    mgr.set_budget(mgr.resident_bytes + td.nbytes + ta.nbytes
                   + 2 * nbytes + nbytes // 2)
    try:
        results = [project(i) for i in range(4)]
        evicted = mgr.evictions - evictions0
        spilled = [r._table is None for r in results]
        check(evicted >= 2, f"P1 LRU: {evicted} evictions, want 2 or more")
        check(spilled[:2] == [True, True] and not any(spilled[2:]),
              f"P1 LRU: spilled {spilled}, want the two oldest")
        for i, r in enumerate(results):
            read_back(r, i, f"P1 LRU result {i}")
        log(f"P1 LRU: budget {mgr.budget}, 4 results of {nbytes} bytes, "
            f"{evicted} evictions, spilled {spilled}, all read back equal "
            f"[{card}]")
        del results, r
    finally:
        mgr.set_budget(old_budget)

    # clear_device_mem: the table's columns leave the device
    q2 = lambda: ht.agg("passenger_count", "avg(total_amount)").run()
    want = q2().to_numpy()
    cols = hdk._schema.get("trips").columns
    col_bytes = sum(x.nbytes for c in cols for pair in c._device.values()
                    for x in pair if x is not None)
    mem0 = device_bytes()
    hdk.clear_device_mem()
    mem1 = device_bytes()
    check(not on_card or mem0 - mem1 >= col_bytes,
          f"clear_device_mem: device bytes fell by {mem0 - mem1}, less "
          f"than the columns' {col_bytes}")
    got = q2().to_numpy()
    equal(got["passenger_count"], want["passenger_count"],
          "clear_device_mem keys")
    close(got["total_amount_avg"], want["total_amount_avg"], 1e-9,
          "clear_device_mem taxi_q2")
    log(f"clear_device_mem: {col_bytes} column bytes dropped, device bytes "
        f"{mem0} -> {mem1}; taxi Q2 again equal [{card}]")


def interop_i1(hdk_mod, device, card, rows):
    """I1: SQL the engine refuses, answered by SQLite over a table of
    ``rows`` rows: a recursive CTE joined to it, and SUBSTR."""
    hdk = hdk_mod.HDK(device=device, **{"exec.enable_interop": True})
    k = np.arange(rows, dtype=np.int64)
    v = np.random.default_rng(37).normal(size=rows)
    s = np.asarray([f"s{i % 997:04d}" for i in range(rows)], dtype=object)
    hdk.import_pydict({"k": k, "v": v, "s": s}, name="io")
    t0 = time.perf_counter()
    out = hdk.sql(IO_RECURSIVE_Q).to_numpy()
    t_cte = time.perf_counter() - t0
    sel = (k % 100 == 0) & (k <= 99_900)
    equal(out["k"], k[sel], "I1 recursive CTE k")
    equal(out["v"], v[sel], "I1 recursive CTE v")
    t0 = time.perf_counter()
    out = hdk.sql(IO_SUBSTR_Q).to_numpy()
    t_sub = time.perf_counter() - t0
    equal(out["k"], k, "I1 SUBSTR k")
    equal(np.asarray(out["sub"], dtype=object),
          np.asarray([x[1:4] for x in s], dtype=object), "I1 SUBSTR")
    log(f"I1 interop over {rows} rows: recursive CTE join {t_cte!r} s, "
        f"SUBSTR {t_sub!r} s (SQLite on the host; no speed claimed) "
        f"[{card}]")
    hdk.drop_table("io")


def ingest_overlap(hdk_mod, device, data, card):
    """``import_arrow`` of the taxi rows, then taxi Q2, with the device
    prefetch on and off, each in a fresh session, in the order on, off,
    off, on; the results must be equal.  Skipped (and said so) where
    pyarrow is not installed."""
    try:
        import pyarrow as pa
    except ImportError:
        log("ingest overlap: pyarrow is not installed here, not measured")
        return
    import gc

    from hdk_tpu_torch.storage.table import _ingest_pool

    at = pa.table(dict(data))
    outs = []
    for prefetch in (True, False, False, True):
        # each run starts with the ingest worker idle (an earlier
        # session's stats may still be computing) and no garbage left
        _ingest_pool().submit(lambda: None).result()
        gc.collect()
        hdk = hdk_mod.HDK(device=device,
                          **{"storage.prefetch_device": prefetch})
        t0 = time.perf_counter()
        ht = hdk.import_arrow(at, name="trips_arrow")
        t_import = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = ht.agg("passenger_count", "avg(total_amount)").run() \
            .block().to_numpy()
        t_query = time.perf_counter() - t0
        outs.append(out)
        log(f"ingest overlap: prefetch={prefetch} import_s={t_import!r} "
            f"first_query_s={t_query!r} sum_s={t_import + t_query!r} "
            f"[{card}]")
        hdk.drop_table("trips_arrow")
        del hdk, ht
    for out in outs[1:]:
        equal(out["passenger_count"], outs[0]["passenger_count"],
              "ingest overlap keys")
        close(out["total_amount_avg"], outs[0]["total_amount_avg"], 1e-9,
              "ingest overlap taxi_q2")


def facade_phase(hdk_mod, card, hist, device="cuda", taxi_rows=TAXI_ROWS,
                 batches=STREAM_BATCHES, interop_rows=INTEROP_ROWS,
                 want_stream=FACADE_STREAM_KERNELS,
                 want_udf=FACADE_UDF_KERNELS):
    """Phase 10 in a session of its own: S1 a stream of the taxi rows in
    ``batches`` pushes, U1 a torch-body UDF in taxi Q2's GROUP BY, V1 a
    refragmented view, P1 spill to host memory, I1 SQLite interop, and
    the ingest prefetch on and off; each against numpy."""
    from hdk_tpu_torch.storage.memory import device_cache_manager

    t_phase = time.perf_counter()
    pandas_before = "pandas" in sys.modules
    mgr = device_cache_manager()
    h2d = h2d_rates()[0] if device == "cuda" else float("inf")
    t0 = time.perf_counter()
    data = gen_taxi(taxi_rows)
    log(f"facade phase: taxi {taxi_rows} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    hdk = hdk_mod.HDK(device=device)

    used = stream_s1(hdk, data, card, hist, batches, want_stream)
    left = [n for n in hdk.table_names() if n.startswith("__stream_")]
    check(not left, f"S1 left its batch tables {left}")

    t = hdk_mod.types
    ht = hdk.import_pydict(
        dict(data), name="trips",
        schema={"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    udf_u1(hdk_mod, hdk, ht, data, card, hist, want_udf)

    # V1: the same rows under a 10M-row fragment size
    view = hdk.refragmented_view("trips", "trips_10m", 10_000_000)
    a = ht.agg("passenger_count", "avg(total_amount)").run().to_numpy()
    b = view.agg("passenger_count", "avg(total_amount)").run().to_numpy()
    equal(b["passenger_count"], a["passenger_count"], "V1 keys")
    close(b["total_amount_avg"], a["total_amount_avg"], 1e-9, "V1 taxi_q2")
    log(f"V1 view: {len(hdk._schema.get('trips_10m').fragments)} fragments, "
        f"taxi Q2 equal to the table's [{card}]")
    hdk.drop_table("trips_10m")

    spill_p1(hdk, ht, data, card, mgr, h2d)
    hdk.drop_table("trips")
    del ht, view
    # the stream, the UDF, the view and the spill load no pandas; I1's
    # text column and the Arrow import go through pyarrow, which loads
    # pandas where it is installed
    check(pandas_before or "pandas" not in sys.modules,
          "the facade phase imported pandas")
    interop_i1(hdk_mod, device, card, interop_rows)
    ingest_overlap(hdk_mod, device, data, card)
    check("jax" not in sys.modules, "jax was imported")
    log(f"facade phase: {time.perf_counter() - t_phase:.1f} s including "
        f"data generation and the numpy oracles")
    return used


# -- phase 11: multi-device sessions --------------------------------------

DIST_SHARDS = 4
# phase 11 must launch every histogram kernel on its shards
DIST_KERNELS = ("count_hist", "groupby_sums2", "seg_sums_exact",
                "groupby_sums")
DIST_DISTINCT_Q = ("SELECT g % 10 AS b, COUNT(DISTINCT g) AS dg, "
                   "COUNT(*) AS c, SUM(x) AS sx FROM t GROUP BY g % 10")
DIST_SORT_Q = "SELECT g, x, y FROM t ORDER BY y DESC, g LIMIT 200000"
# W1 with a LIMIT over its 90 rows: the ORDER BY takes the top-n path,
# not a range sort whose buffers size by the 100M rows
DIST_W1 = W1 + " LIMIT 100"


def result_rows(out, ordered: bool):
    """(NULL flags, values) per column of a to_numpy result; unordered
    results in lexicographic order of both."""
    cols = []
    for v in out.values():
        null = np.ma.getmaskarray(v)
        cols.append((null, np.where(null, 0, np.ma.getdata(v))))
    if not ordered and cols and len(cols[0][0]):
        keys = [c for pair in cols for c in pair]
        order = np.lexsort(keys[::-1])
        cols = [(n[order], d[order]) for n, d in cols]
    return cols


def same_result(got, want, what: str, ordered: bool, rtol: float = 1e-9):
    """Two to_numpy results hold the same rows: integers and NULLs equal,
    floats to ``rtol``."""
    check(list(got) == list(want), f"{what}: columns {list(got)}")
    for (gn, gv), (wn, wv) in zip(result_rows(got, ordered),
                                  result_rows(want, ordered)):
        check(gn.shape == wn.shape, f"{what}: {gn.size} rows, want "
              f"{wn.size}")
        equal(gn, wn, f"{what} NULLs")
        if wv.dtype.kind == "f":
            close(gv, wv, rtol, what)
        else:
            equal(gv, wv, what)


def dist_phase(hdk_mod, card, hist, device="cuda", shards=DIST_SHARDS,
               taxi_rows=TAXI_ROWS, nulls_rows=NULLS_ROWS,
               ndv_rows=HIGH_NDV_ROWS, ndv_keys=HIGH_NDV_KEYS,
               join_scale=1.0, want=DIST_KERNELS, config=None):
    """Phase 11: a session of ``shards`` shards on the one card beside a
    single-device session on the same data.  Each query runs cold (its
    collectives captured) and three times warm in both (the median
    reported); it must take its expected
    distributed route and equal its numpy oracle or the single-device
    result (a query without an oracle).  Kernel launches count on the
    distributed runs only, reset before each and read after it; returns
    their sum per kernel and, per query, its warm ms in both sessions and
    its ``commlog.summarize``."""
    from hdk_tpu_torch.utils import commlog

    t_phase = time.perf_counter()
    stats = {}
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    solo = hdk_mod.HDK(device=device)
    dist = hdk_mod.HDK(device=device, **{"dist.enable": True,
                                         "dist.num_devices": shards,
                                         **(config or {})})
    ex = dist._executor
    mesh = ex._mesh
    check(mesh is not None and mesh.size == shards,
          f"dist session: no {shards}-shard mesh")
    check(all(d.type == torch.device(device).type for d in mesh.devices),
          f"dist session: shards on {mesh.devices}")
    log(f"phase 11: {shards} shards on {sorted({str(d) for d in mesh.devices})}"
        f" [{card}]")
    totals = {k: 0 for k in hist.launches()}
    t = hdk_mod.types
    ts_schema = {"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)}

    def counted(run):
        hist.reset_launches()
        res = run()
        res.block()
        for k, n in hist.launches().items():
            totals[k] += n
        return res

    def warm_s(run, count=False):
        """Median of three warm runs."""
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            (counted(run) if count else run().block())
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def query(label, make, rows, routes, oracle=None, ordered=False,
              rtol=1e-9):
        """``make(session)`` -> result; ``routes``: {executor attribute:
        label} the distributed runs must show."""
        res_s = make(solo).block()
        solo_ms = warm_s(lambda: make(solo)) * 1e3
        with commlog.capture() as rec:
            t0 = time.perf_counter()
            res_d = counted(lambda: make(dist))
            cold = time.perf_counter() - t0
        got_routes = {a: getattr(ex, a) for a in routes}
        retries = ex._dist_retries
        dist_ms = warm_s(lambda: make(dist), count=True) * 1e3
        for attr, want_route in routes.items():
            check(got_routes[attr] == want_route,
                  f"{label}: {attr}={got_routes[attr]}, want {want_route}")
        out = res_d.to_numpy()
        if oracle is not None:
            oracle(out)
        else:
            same_result(out, res_s.to_numpy(), f"{label} vs one device",
                        ordered, rtol)
        ops = [r for r in rec if not r.get("gather")]
        gathers = [r for r in rec if r.get("gather")]
        summary = commlog.summarize(ops, shards)
        stats[label] = {"warm_ms": dist_ms, "single_device_warm_ms": solo_ms,
                        "commlog": summary, "rows": rows}
        log(f"dist {label}: routes={got_routes} rows={rows} cold_s={cold!r} "
            f"warm_ms={dist_ms!r} single_device_warm_ms={solo_ms!r} "
            f"retries={retries} commlog={json.dumps(summary)} "
            f"gathers={len(gathers)} gather_bytes_per_shard="
            f"{sum(r['bytes_per_device'] for r in gathers)} [{card}]")
        return out

    # taxi Q2 (dense_psum) and Q3 sorted by its count (the fused sort)
    t0 = time.perf_counter()
    data = gen_taxi(taxi_rows)
    log(f"phase 11: taxi {taxi_rows} rows in {time.perf_counter() - t0:.1f} s")
    for s in (solo, dist):
        s.import_pydict(dict(data), name="trips", schema=ts_schema)
    pc = data["passenger_count"].astype(np.int64)

    def q2_oracle(out):
        cnt = np.bincount(pc, minlength=9)
        sums = np.bincount(pc, weights=data["total_amount"].astype(
            np.float64), minlength=9)
        equal(out["passenger_count"], np.arange(9), "dist taxi_q2 keys")
        close(out["total_amount_avg"], sums / cnt, 1e-6, "dist taxi_q2 avg")

    query("taxi_q2", lambda s: s.scan("trips").agg(
        "passenger_count", "avg(total_amount)").run(), taxi_rows,
        {"_dist_agg_route": "dense_psum"}, q2_oracle)

    def q3_sorted(s):
        ht = s.scan("trips")
        return ht.agg(["passenger_count",
                       ht["pickup_datetime"].extract("year").name("y")],
                      "count").sort(("count", "desc")).run()

    def q3_oracle(out):
        uniq, inv = group_ids(pc, years(data["pickup_datetime"]))
        counts = np.bincount(inv)
        order = np.argsort(-counts, kind="stable")
        equal(np.stack([out["passenger_count"], out["y"]], 1), uniq[order],
              "dist taxi_q3 keys")
        equal(out["count"], counts[order], "dist taxi_q3 count")

    query("taxi_q3_sorted", q3_sorted, taxi_rows,
          {"_dist_agg_route": "dense_psum_fused_sort"}, q3_oracle,
          ordered=True)

    # W1: ROW_NUMBER top 10 per passenger count on the dist_window route
    query("W1", lambda s: s.sql(DIST_W1), taxi_rows,
          {"_dist_window_route": "dist_window"}, ordered=True)
    for s in (solo, dist):
        s.drop_table("trips")
    del data, pc
    torch.cuda.empty_cache()

    # the nulls GROUP BY (K2), a COUNT(DISTINCT) on the distinct_split
    # route and an ORDER BY + LIMIT above the top-n limit (range sort)
    nulls = gen_nulls(nulls_rows)
    for s in (solo, dist):
        s.import_pydict(nulls, name="t")
    g = nulls["g"]

    def nulls_oracle(out):
        cols = list(out.values())
        xv = ~np.ma.getmaskarray(nulls["x"])
        yv = ~np.ma.getmaskarray(nulls["y"])
        xsum = np.zeros(1000, np.int64)
        np.add.at(xsum, g[xv], nulls["x"].data[xv])
        ysum = np.bincount(g[yv], weights=nulls["y"].data[yv], minlength=1000)
        equal(cols[0], np.arange(1000), "dist nulls keys")
        equal(cols[1], np.bincount(g, minlength=1000), "dist nulls count(*)")
        equal(cols[2], np.bincount(g[xv], minlength=1000),
              "dist nulls count(x)")
        equal(cols[3], xsum, "dist nulls sum(x)")
        close(cols[4], ysum / np.bincount(g[yv], minlength=1000), 1e-9,
              "dist nulls avg(y)")

    query("nulls", lambda s: s.sql(NULLS_Q), nulls_rows,
          {"_dist_agg_route": "dense_psum_fused_sort"}, nulls_oracle,
          ordered=True)

    def distinct_oracle(out):
        b = g % 10
        order = np.argsort(out["b"])
        equal(out["b"][order], np.arange(10), "dist distinct keys")
        equal(out["dg"][order], [np.unique(g[b == i]).size
                                 for i in range(10)], "dist distinct dg")
        equal(out["c"][order], np.bincount(b, minlength=10),
              "dist distinct count")

    query("count_distinct", lambda s: s.sql(DIST_DISTINCT_Q), nulls_rows,
          {"_dist_agg_route": "distinct_split"}, distinct_oracle)
    query("order_by_limit", lambda s: s.sql(DIST_SORT_Q), nulls_rows,
          {"_dist_sort_route": "range"}, ordered=True)
    for s in (solo, dist):
        s.drop_table("t")
    del nulls, g

    # HN1: ~43M groups on the two-phase route
    t0 = time.perf_counter()
    hn = gen_high_ndv(ndv_rows, ndv_keys)
    counts = np.bincount(hn["k"], minlength=ndv_keys)
    sums = np.bincount(hn["k"], weights=hn["v"], minlength=ndv_keys)
    present = np.flatnonzero(counts)
    log(f"phase 11: high-NDV {ndv_rows} rows, {present.size} groups, "
        f"oracle in {time.perf_counter() - t0:.1f} s")
    for s in (solo, dist):
        s.import_pydict(hn, name="ndv_t")

    def hn1_oracle(out):
        order = np.argsort(out["k"])
        equal(out["k"][order], present, "dist HN1 keys")
        equal(out["count"][order], counts[present], "dist HN1 count")
        equal(out["v_sum"][order], sums[present].astype(np.int64),
              "dist HN1 sum(v)")

    query("HN1", lambda s: s.scan("ndv_t").agg("k", "count",
                                               "sum(v)").run(),
          ndv_rows, {"_dist_agg_route": "two_phase"}, hn1_oracle)
    for s in (solo, dist):
        s.drop_table("ndv_t")
    del hn, counts, sums, present
    torch.cuda.empty_cache()

    # J1 (partitioned: its 10M-row build is above the broadcast
    # threshold) and J5's IN subquery (broadcast: 1.35M filtered rows)
    t0 = time.perf_counter()
    trips, payments = gen_join(join_scale, seed=11)
    n_probe = trips["k"].size
    fee_of = np.empty(payments["k"].size, np.float64)
    fee_of[payments["k"]] = payments["fee"]
    log(f"phase 11: join data in {time.perf_counter() - t0:.1f} s")
    for s in (solo, dist):
        s.import_pydict(trips, name="trips_j")
        s.import_pydict(payments, name="payments_j")
    check(payments["k"].size > dist.config.dist.broadcast_join_threshold
          or join_scale < 1, "J1's build is not above the threshold")

    def j1_oracle(out):
        count, fee = out.values()
        equal(count, [n_probe], "dist J1 count")
        close(fee, [fee_of[trips["k"]].sum()], 1e-6, "dist J1 sum(fee)")

    query("J1", lambda s: s.scan("trips_j").join(
        s.scan("payments_j"), "k", "k").agg([], "count", "sum(fee)").run(),
        n_probe, {"_dist_join_route": "partitioned"}, j1_oracle, rtol=1e-6)

    def j5_oracle(out):
        count, amt = out.values()
        in_set = np.zeros(payments["k"].size, bool)
        in_set[payments["k"][payments["fee"].astype(np.float64) > 4.0]] = True
        sel = in_set[trips["k"]]
        equal(count, [int(sel.sum())], "dist J5 count")
        close(amt, [trips["amt"][sel].astype(np.float64).sum()], 1e-6,
              "dist J5 sum")

    query("J5_broadcast", lambda s: s.sql(J5_IN), n_probe,
          {"_dist_join_route": "broadcast"}, j5_oracle, rtol=1e-6)
    for s in (solo, dist):
        drop_tables(s, "trips_j", "payments_j")
    del trips, payments, fee_of, solo, dist
    torch.cuda.empty_cache()
    for name in want:
        check(totals[name] > 0, f"kernel {name} never launched on the "
              f"multi-device path ({totals})")
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else None)
    log(f"multi-device path: kernel launches {totals}; phase 11 in "
        f"{time.perf_counter() - t_phase:.1f} s, peak_device_bytes={peak}")
    return totals, stats


# -- phase 12: a multi-host session, two ranks on the one card ----------

MH_WORLD = 2
MH_SHARDS = 4  # global: two a rank
MH_STRING_ROWS = 10_000_000
MH_STRING_SPLIT = 0.4  # rank 0's share of the string table
# HN1 and J1 cut to 10M rows: at phase 11's 100M they take 3.3 and 8.1
# s a warm run over the staged gloo transport on one H100, and phase 12
# then outruns its ~120 s budget (PERF.md §5); J5 keeps 100M probe rows
MH_HN1_ROWS = 10_000_000
MH_J5_SCALE = 1.0
MH_J1_SCALE = 0.1
MH_TIMEOUT_S = 900
MH_STRING_Q = ("SELECT city, COUNT(*) AS c, SUM(amt) AS s FROM mstr "
               "GROUP BY city ORDER BY city")


def mh_part(rows: int, rank: int, share0: float = 0.5) -> slice:
    """Rank ``rank``'s rows of a table split ``share0`` / the rest."""
    cut = int(rows * share0)
    return slice(0, cut) if rank == 0 else slice(cut, rows)


def gen_cities(rows: int):
    """A string key of 1000 city names (zipf-skewed) and an amount."""
    rng = np.random.default_rng(37)
    names = np.asarray([f"city_{i:04d}" for i in range(1000)])
    idx = np.minimum(rng.zipf(1.2, rows), 1000) - 1
    return {"city": names[idx], "amt": rng.integers(1, 100, rows)}


MH_SIZES = {"taxi_rows": TAXI_ROWS, "nulls_rows": NULLS_ROWS,
            "string_rows": MH_STRING_ROWS, "hn1_rows": MH_HN1_ROWS,
            "j5_scale": MH_J5_SCALE, "j1_scale": MH_J1_SCALE}


def mh_rank(rank: int, address: str, device: str = "cuda",
            sizes=None, config=None) -> dict:
    """One rank of phase 12 (run as ``chip_smoke.py --rank R --address
    HOST:PORT``): a multi-host session of 2 local shards of 4, its tables
    process-local (each rank imports its own rows, made from the seeds
    like every phase's), each query cold then three times warm, checked
    against numpy on this rank.  Returns the per-query report, this
    rank's kernel launches over the session's runs and its peak device
    memory.  ``sizes`` overrides ``MH_SIZES``; ``config`` adds session
    settings."""
    sz = {**MH_SIZES, **(sizes or {})}
    taxi_rows, nulls_rows = sz["taxi_rows"], sz["nulls_rows"]
    string_rows, hn1_rows = sz["string_rows"], sz["hn1_rows"]
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hdk_tpu_torch
    from hdk_tpu_torch.kernels import hist
    from hdk_tpu_torch.utils import commlog

    hdk = hdk_tpu_torch.HDK(device=device, **{
        "dist.enable": True, "dist.multi_host": True,
        "dist.coordinator_address": address,
        "dist.num_processes": MH_WORLD, "dist.process_id": rank,
        "dist.num_devices": MH_SHARDS, "dist.timeout_s": MH_TIMEOUT_S,
        **(config or {})})
    ex = hdk._executor
    mesh = ex._mesh
    tr = commlog.transport()
    check(mesh.size == MH_SHARDS and mesh.world == MH_WORLD
          and mesh.local_size == MH_SHARDS // MH_WORLD,
          f"rank {rank}: mesh {mesh.size}/{mesh.world}")
    hist.reset_launches()
    totals = {k: 0 for k in hist.launches()}
    report = []
    t = hdk_tpu_torch.types

    def counted(run):
        hist.reset_launches()
        res = run()
        res.block()
        for k, n in hist.launches().items():
            totals[k] += n
        return res

    def query(label, run, rows, routes, oracle):
        with commlog.capture() as rec:
            t0 = time.perf_counter()
            out = counted(run).to_numpy()
            cold = time.perf_counter() - t0
        got = {a: getattr(ex, a) for a in routes}
        retries = ex._dist_retries
        for attr, want in routes.items():
            check(got[attr] == want,
                  f"rank {rank} {label}: {attr}={got[attr]}, want {want}")
        oracle(out)
        times, staged, staged_ms = [], [], []
        for _ in range(3):
            tr.reset_stats()
            t0 = time.perf_counter()
            counted(run)
            times.append(time.perf_counter() - t0)
            st = tr.stats()
            staged.append(st["staged_bytes"])
            staged_ms.append(st["ms"])
        ops = [r for r in rec if not r.get("gather")]
        gathers = [r for r in rec if r.get("gather")]
        report.append({
            "label": label, "rows": rows, "routes": got, "retries": retries,
            "cold_s": cold, "warm_ms": statistics.median(times) * 1e3,
            "commlog": commlog.summarize(ops, MH_SHARDS),
            "gathers": len(gathers),
            "gather_bytes_per_shard": sum(r["bytes_per_device"]
                                          for r in gathers),
            "staged_bytes_per_run": statistics.median(staged),
            "staged_ms_per_run": statistics.median(staged_ms)})
        print(f"rank {rank} {label}: {json.dumps(report[-1])}",
              file=sys.stderr, flush=True)

    # taxi Q2 (dense_psum; K1 + K4) and Q3 sorted (the fused sort), the
    # 100M rows split 50/50
    data = gen_taxi(taxi_rows)
    part = mh_part(taxi_rows, rank)
    ts_schema = {"pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)}
    hdk.import_pydict({k: v[part] for k, v in data.items()}, name="trips",
                      schema=ts_schema, process_local=True)
    pc = data["passenger_count"].astype(np.int64)

    def q2_oracle(out):
        cnt = np.bincount(pc, minlength=9)
        sums = np.bincount(pc, weights=data["total_amount"].astype(
            np.float64), minlength=9)
        equal(out["passenger_count"], np.arange(9), "mh taxi_q2 keys")
        close(out["total_amount_avg"], sums / cnt, 1e-6, "mh taxi_q2 avg")

    query("taxi_q2", lambda: hdk.scan("trips").agg(
        "passenger_count", "avg(total_amount)").run(), taxi_rows,
        {"_dist_agg_route": "dense_psum"}, q2_oracle)

    def q3_run():
        ht = hdk.scan("trips")
        return ht.agg(["passenger_count",
                       ht["pickup_datetime"].extract("year").name("y")],
                      "count").sort(("count", "desc")).run()

    def q3_oracle(out):
        uniq, inv = group_ids(pc, years(data["pickup_datetime"]))
        counts = np.bincount(inv)
        order = np.argsort(-counts, kind="stable")
        equal(np.stack([out["passenger_count"], out["y"]], 1), uniq[order],
              "mh taxi_q3 keys")
        equal(out["count"], counts[order], "mh taxi_q3 count")

    query("taxi_q3_sorted", q3_run, taxi_rows,
          {"_dist_agg_route": "dense_psum_fused_sort"}, q3_oracle)
    hdk.drop_table("trips")
    del data, pc

    # the nulls GROUP BY (K2), 10M rows split 50/50
    nulls = gen_nulls(nulls_rows)
    part = mh_part(nulls_rows, rank)
    hdk.import_pydict({k: v[part] for k, v in nulls.items()}, name="t",
                      process_local=True)
    g = nulls["g"]

    def nulls_oracle(out):
        cols = list(out.values())
        xv = ~np.ma.getmaskarray(nulls["x"])
        yv = ~np.ma.getmaskarray(nulls["y"])
        xsum = np.zeros(1000, np.int64)
        np.add.at(xsum, g[xv], nulls["x"].data[xv])
        ysum = np.bincount(g[yv], weights=nulls["y"].data[yv],
                           minlength=1000)
        equal(cols[0], np.arange(1000), "mh nulls keys")
        equal(cols[1], np.bincount(g, minlength=1000), "mh nulls count(*)")
        equal(cols[2], np.bincount(g[xv], minlength=1000),
              "mh nulls count(x)")
        equal(cols[3], xsum, "mh nulls sum(x)")
        close(cols[4], ysum / np.bincount(g[yv], minlength=1000), 1e-9,
              "mh nulls avg(y)")

    query("nulls", lambda: hdk.sql(NULLS_Q), nulls_rows,
          {"_dist_agg_route": "dense_psum_fused_sort"}, nulls_oracle)
    hdk.drop_table("t")
    del nulls, g

    # a string GROUP BY over a process-local string column split 40/60:
    # each rank's dictionary joins the rank-ordered union at ingest
    cities = gen_cities(string_rows)
    part = mh_part(string_rows, rank, MH_STRING_SPLIT)
    t0 = time.perf_counter()
    hdk.import_pydict({k: v[part] for k, v in cities.items()}, name="mstr",
                      process_local=True)
    ingest_s = time.perf_counter() - t0

    def string_oracle(out):
        names, inv = np.unique(cities["city"], return_inverse=True)
        equal(np.asarray(out["city"], dtype=str), names, "mh string keys")
        equal(out["c"], np.bincount(inv), "mh string count")
        equal(out["s"], np.bincount(inv, weights=cities["amt"]).astype(
            np.int64), "mh string sum")

    query("string_groupby", lambda: hdk.sql(MH_STRING_Q), string_rows,
          {"_dist_agg_route": "dense_psum_fused_sort"}, string_oracle)
    report[-1]["ingest_s"] = ingest_s
    hdk.drop_table("mstr")
    del cities

    # HN1 on the two-phase route (K3 + K4)
    hn = gen_high_ndv(hn1_rows, HIGH_NDV_KEYS)
    part = mh_part(hn1_rows, rank)
    hdk.import_pydict({k: v[part] for k, v in hn.items()}, name="ndv_t",
                      process_local=True)
    counts = np.bincount(hn["k"], minlength=HIGH_NDV_KEYS)
    sums = np.bincount(hn["k"], weights=hn["v"], minlength=HIGH_NDV_KEYS)
    present = np.flatnonzero(counts)

    def hn1_oracle(out):
        order = np.argsort(out["k"])
        equal(out["k"][order], present, "mh HN1 keys")
        equal(out["count"][order], counts[present], "mh HN1 count")
        equal(out["v_sum"][order], sums[present].astype(np.int64),
              "mh HN1 sum(v)")

    query("HN1", lambda: hdk.scan("ndv_t").agg("k", "count",
                                               "sum(v)").run(),
          hn1_rows, {"_dist_agg_route": "two_phase"}, hn1_oracle)
    hdk.drop_table("ndv_t")
    del hn, counts, sums, present
    if cuda:
        torch.cuda.empty_cache()

    def join_tables(scale):
        trips, payments = gen_join(scale, seed=11)
        part = mh_part(trips["k"].size, rank)
        hdk.import_pydict({k: v[part] for k, v in trips.items()},
                          name="trips_j", process_local=True)
        hdk.import_pydict(payments, name="payments_j")
        return trips, payments

    # J5's IN subquery (broadcast: process-local fact x replicated dim,
    # the dim's 1.35M filtered rows below the broadcast threshold)
    trips, payments = join_tables(sz["j5_scale"])

    def j5_oracle(out):
        count, amt = out.values()
        in_set = np.zeros(payments["k"].size, bool)
        in_set[payments["k"][payments["fee"].astype(np.float64) > 4.0]] = True
        sel = in_set[trips["k"]]
        equal(count, [int(sel.sum())], "mh J5 count")
        close(amt, [trips["amt"][sel].astype(np.float64).sum()], 1e-6,
              "mh J5 sum")

    query("J5_broadcast", lambda: hdk.sql(J5_IN), trips["k"].size,
          {"_dist_join_route": "broadcast"}, j5_oracle)
    drop_tables(hdk, "trips_j", "payments_j")
    del trips, payments

    # J1 (partitioned: its build above the broadcast threshold, which a
    # cut build lowers to half its rows on every rank alike)
    trips, payments = join_tables(sz["j1_scale"])
    n_probe = trips["k"].size
    dcfg = hdk.config.dist
    dcfg.broadcast_join_threshold = min(dcfg.broadcast_join_threshold,
                                        payments["k"].size // 2)
    fee_of = np.empty(payments["k"].size, np.float64)
    fee_of[payments["k"]] = payments["fee"]

    def j1_oracle(out):
        count, fee = out.values()
        equal(count, [n_probe], "mh J1 count")
        close(fee, [fee_of[trips["k"]].sum()], 1e-6, "mh J1 sum(fee)")

    query("J1", lambda: hdk.scan("trips_j").join(
        hdk.scan("payments_j"), "k", "k").agg([], "count",
                                              "sum(fee)").run(),
          n_probe, {"_dist_join_route": "partitioned"}, j1_oracle)
    report[-1]["broadcast_join_threshold"] = dcfg.broadcast_join_threshold
    drop_tables(hdk, "trips_j", "payments_j")
    del trips, payments, fee_of
    out = {"rank": rank, "queries": report, "launches": totals,
           "peak_device_bytes": (torch.cuda.max_memory_allocated() if cuda
                                 else None),
           "transport": tr.backend, "transport_reason": tr.reason,
           "devices": [str(d) for d in mesh.devices]}
    del hdk
    import torch.distributed as dist

    dist.destroy_process_group()
    return out


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multihost_phase(card, dist_stats, device="cuda", sizes=None,
                    config=None, want=DIST_KERNELS):
    """Phase 12: two ranks of this script, fresh processes on the one
    card, joined over gloo on 127.0.0.1 with operands staged through
    pinned host memory, each with 2 of the 4 shards.  A rank that fails
    or outlives ``MH_TIMEOUT_S`` fails the phase, and both are killed on
    the way out.  Returns the kernel launches summed over the ranks."""
    t_phase = time.perf_counter()
    sz = {**MH_SIZES, **(sizes or {})}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    address = f"127.0.0.1:{free_port()}"
    log(f"phase 12: {MH_WORLD} ranks x {MH_SHARDS // MH_WORLD} shards on "
        f"the one card, gloo at {address} [{card}]")
    extra = ["--device", device, "--sizes", json.dumps(sz),
             "--config", json.dumps(config or {})]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--address", address] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MH_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MH_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        for line in se.splitlines():
            if line.startswith(f"rank {r} "):
                log(line)
        check(p.returncode == 0,
              f"phase 12: rank {r} exited {p.returncode}:\n{se[-6000:]}")
        lines = [ln for ln in so.splitlines() if ln.startswith('{"rank"')]
        check(bool(lines), f"phase 12: rank {r} printed no result")
        ranks.append(json.loads(lines[-1]))
    totals = {k: sum(rk["launches"][k] for rk in ranks)
              for k in ranks[0]["launches"]}
    for rk in ranks:
        log(f"phase 12: rank {rk['rank']} on {rk['devices']}, transport "
            f"{rk['transport']} ({rk['transport_reason']}), "
            f"peak_device_bytes={rk['peak_device_bytes']}, kernel launches "
            f"{rk['launches']} [{card}]")
    for i, q in enumerate(ranks[0]["queries"]):
        label = q["label"]
        p11 = dist_stats.get(label)
        for rk in ranks[1:]:
            other = rk["queries"][i]
            check(other["routes"] == q["routes"]
                  and other["retries"] == q["retries"]
                  and other["commlog"] == q["commlog"],
                  f"phase 12 {label}: the ranks disagree")
        same_size = p11 is not None and p11["rows"] == q["rows"]
        if same_size:
            check(q["commlog"] == p11["commlog"],
                  f"phase 12 {label}: commlog {q['commlog']} is not phase "
                  f"11's {p11['commlog']}")
        warm = [rk["queries"][i]["warm_ms"] for rk in ranks]
        log(f"multi-host {label}: routes={q['routes']} rows={q['rows']} "
            f"retries={q['retries']} warm_ms_by_rank={warm!r} "
            f"phase11_4shard_warm_ms="
            f"{p11['warm_ms'] if same_size else None!r} "
            f"single_device_warm_ms="
            f"{p11['single_device_warm_ms'] if same_size else None!r} "
            f"commlog={json.dumps(q['commlog'])} "
            f"commlog_equals_phase11={same_size} "
            f"staged_bytes_per_run_by_rank="
            f"{[rk['queries'][i]['staged_bytes_per_run'] for rk in ranks]} "
            f"staged_ms_per_run_by_rank="
            f"{[rk['queries'][i]['staged_ms_per_run'] for rk in ranks]!r} "
            f"cold_s_by_rank={[rk['queries'][i]['cold_s'] for rk in ranks]!r}"
            f" [{card}]")
    for name in want:
        check(totals[name] > 0, f"kernel {name} never launched inside the "
              f"ranks of phase 12 ({totals})")
    full = {**MH_SIZES, "hn1_rows": HIGH_NDV_ROWS, "j1_scale": 1.0}
    cuts = [f"{k}={v} (full size: {full[k]})" for k, v in sz.items()
            if v != full[k]]
    log(f"multi-host path: kernel launches {totals}; phase 12 in "
        f"{time.perf_counter() - t_phase:.1f} s; cut: "
        f"{'; '.join(cuts) or 'nothing'}")
    return totals


# -- phase 13: the port's bench ---------------------------------------------

BENCH_KERNELS = ("groupby_sums", "seg_sums_exact", "count_hist")
# each script's sizes: the bench's defaults, where they fit; the cuts
# (the suite, ingest, NDV, the two Q3 tools) are logged.  The suite runs
# at half scale to keep the script inside its time limit on a slow host
BENCH_SIZES = {"bench_rows": 10_000_000, "suite_scale": 0.5,
               "scaling_rows": 2_000_000, "ingest_rows": 1_000_000,
               "ingest_reps": 1, "dict_rows": 1_000_000,
               "ndv_rows": 10_000_000, "q3_scale": 0.1, "q3_runs": 4}
BENCH_DEFAULTS = {"suite_scale": 1.0, "ingest_rows": 10_000_000,
                  "ingest_reps": 3,
                  "dict_rows": 4_000_000, "ndv_rows": 100_000_000,
                  "q3_scale": 1.0, "q3_runs": 8}
BENCH_TIMEOUT_S = 600
# the scripts whose records phase 13 reads
BENCH_RECORDS = {"bench_torch": "bench_torch.py",
                 "bench_suite": "bench_suite_torch.py",
                 "bench_scaling": "bench_scaling_torch.py",
                 "bench_ingest": "tools/bench_ingest_torch.py",
                 "ndv_overhead": "tools/ndv_overhead_torch.py"}


def record_keys(rel: str):
    """``RECORD_KEYS`` of the script at ``rel``: the keys its record has."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3],
        os.path.join(os.path.dirname(os.path.abspath(__file__)), rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RECORD_KEYS


def start_script(label: str, argv, env=None):
    """``python argv`` from the repository's root, started in a process
    group of its own (so it can be killed whole, with the processes the
    script starts)."""
    proc = subprocess.Popen(
        [sys.executable, *argv], cwd=os.path.dirname(os.path.abspath(
            __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, **(env or {})}, start_new_session=True)
    return label, time.perf_counter(), proc


def stop_script(job) -> None:
    import signal

    if job[2].poll() is None:
        os.killpg(job[2].pid, signal.SIGKILL)
        job[2].communicate()


def finish_script(job) -> str:
    """Wait for a started script (at most ``BENCH_TIMEOUT_S`` from its
    start); fails unless it exits 0.  Returns its standard output."""
    label, t0, proc = job
    try:
        out, err = proc.communicate(
            timeout=max(1.0, BENCH_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_script(job)
        fail(f"{label}: still running after {BENCH_TIMEOUT_S} s (killed)")
    check(proc.returncode == 0, f"{label}: exit code {proc.returncode}; "
                                f"stderr tail:\n{err[-3000:]}")
    log(f"{label}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out


def run_scripts(scripts) -> dict:
    """Run (label, argv, env) scripts at once; label -> standard output.
    Every one still running is killed when one fails."""
    jobs = [start_script(*sc) for sc in scripts]
    try:
        return {job[0]: finish_script(job) for job in jobs}
    finally:
        for job in jobs:
            stop_script(job)


def json_lines(out: str):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def has_keys(rec: dict, keys, label: str) -> None:
    missing = [k for k in keys if k not in rec]
    check(not missing, f"{label}: record lacks {missing}")


def bench_scripts(device: str, sz: dict, out_dir: str):
    """Every bench script of the port as a process of its own, each
    required to exit 0 and print its record with every key: all but the
    suite at once (their times, taken while they share the card and the
    host, are no measurement), then the suite alone.  Returns the records
    of bench_torch.py and the suite, whose processes held each timed
    query's result against its numpy oracle and counted its kernel
    launches."""
    keys = {n: record_keys(rel) for n, rel in BENCH_RECORDS.items()}
    dev = ["--device", device]
    path = {n: os.path.join(out_dir, n + ".json")
            for n in ("bench_suite", "bench_scaling", "bench_ingest",
                      "ndv_overhead")}
    q3 = ["--scale", str(sz["q3_scale"]), *dev]
    outs = run_scripts([
        ("bench_torch", ["bench_torch.py", *dev, "--out-dir", out_dir],
         {"BENCH_ROWS": str(sz["bench_rows"]), "BENCH_ISOLATED": "1"}),
        ("bench_scaling", ["bench_scaling_torch.py", "--rows",
                           str(sz["scaling_rows"]), "--devices", "1", "2",
                           "4", *dev, "--out", path["bench_scaling"]], None),
        ("bench_ingest", ["tools/bench_ingest_torch.py", *dev, "--out",
                          path["bench_ingest"]],
         {"INGEST_ROWS": str(sz["ingest_rows"]),
          "INGEST_REPS": str(sz["ingest_reps"]),
          "INGEST_DICT_ROWS": str(sz["dict_rows"])}),
        ("ndv_overhead", ["tools/ndv_overhead_torch.py", *dev, "--out",
                          path["ndv_overhead"]],
         {"NDV_ROWS": str(sz["ndv_rows"])}),
        ("q3_analyze", ["tools/q3_analyze_torch.py", *q3, "--runs",
                        str(sz["q3_runs"])], None),
        ("q3_stages", ["tools/q3_stages_torch.py", *q3], None)])

    (taxi,) = json_lines(outs["bench_torch"])[-1:]
    has_keys(taxi, keys["bench_torch"], "bench_torch.py")
    check(taxi["rows"] == sz["bench_rows"] and taxi["mode"] == "isolated",
          f"bench_torch.py: rows {taxi['rows']}, mode {taxi['mode']}")
    log(f"bench_torch record: {json.dumps(taxi)}")
    with open(path["bench_scaling"]) as f:
        rec = json.load(f)
    has_keys(rec, keys["bench_scaling"], "bench_scaling_torch.py")
    check(sorted(rec["seconds_per_query"]) == ["1", "2", "4"],
          "bench_scaling_torch.py: a shard count is missing")
    log(f"bench_scaling: cards {rec['cards_by_shards']}, efficiency vs 1 "
        f"shard {json.dumps(rec['scaling_efficiency_vs_1dev'])}, omitted "
        f"{len(rec['omitted_non_comparable'])}")
    for name in ("bench_ingest", "ndv_overhead"):
        (rec,) = json_lines(outs[name])[-1:]
        has_keys(rec, keys[name], name)
        log(f"{name} record: {json.dumps(rec)}")
    out = outs["q3_analyze"]
    runs = [l for l in out.splitlines() if l.startswith("run ")]
    check(len(runs) == sz["q3_runs"] and "=== EXPLAIN ANALYZE ===" in out,
          f"q3_analyze_torch.py: {len(runs)} runs, output:\n{out[-2000:]}")
    log("q3_analyze: " + " | ".join(runs))
    stages = [l for l in outs["q3_stages"].splitlines() if ": warm " in l]
    check([l.split(":")[0] for l in stages]
          == ["preagg", "ord_cust", "q3", "q3_original_plan"],
          f"q3_stages_torch.py: output:\n{outs['q3_stages'][-2000:]}")
    log("q3_stages: " + " | ".join(stages))

    label = f"bench_suite_torch.py --scale {sz['suite_scale']}"
    recs = json_lines(run_scripts([(label, [
        "bench_suite_torch.py", "--scale", str(sz["suite_scale"]), *dev,
        "--out", path["bench_suite"]], None)])[label])
    check(len(recs) == 7, f"bench_suite_torch.py: {len(recs)} records of 7")
    for r in recs:
        has_keys(r, keys["bench_suite"],
                 f"bench_suite_torch.py {r.get('config')}")
        log(f"bench_suite record: {json.dumps(r)}")
    for r in [taxi, *recs]:
        check(r["result_check"] == "numpy",
              f"{r.get('config', 'taxi')}: result_check "
              f"{r['result_check']!r}")
    return [taxi, *recs]


def bench_phase(card, hist, device="cuda", sizes=None, want=BENCH_KERNELS):
    """Phase 13: the port's bench scripts, each in a process of its own on
    the card (their records logged).  bench_torch.py's query processes
    and the suite's config processes set the kernel counts to 0 before
    their timed runs, read them after, and hold each result against its
    numpy oracle at the size they timed; K1, K3 and K4 must launch there.
    Returns those launches, summed."""
    t_phase = time.perf_counter()
    sz = {**BENCH_SIZES, **(sizes or {})}
    cuts = [f"{k} {sz[k]} of {v}" for k, v in BENCH_DEFAULTS.items()
            if sz[k] != v]
    log(f"phase 13: the bench on {device} [{card}]; sizes {sz}; cut: "
        f"{'; '.join(cuts) or 'nothing'}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_torch_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    recs = bench_scripts(device, sz, out_dir)
    launches = {name: 0 for name in hist.launches()}
    for r in recs:
        for name, n in r["launches"].items():
            launches[name] += n
    for name in want:
        check(launches[name] > 0,
              f"kernel {name} never launched on the bench path")
    log(f"bench path: {len(recs)} timed queries equal to numpy at the "
        f"timed sizes; kernel launches {launches}; phase 13 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches



# -- phase 14: the streaming top-n ------------------------------------------

# the kernels under phase 14's sorts: HN2's COUNT (K4), TPC-H Q3's SUM (K1)
TOPN_KERNELS = ("groupby_sums", "count_hist")
TOPN_SIZES = {"taxi_rows": TAXI_ROWS, "nulls_rows": NULLS_ROWS,
              "hn_rows": HIGH_NDV_ROWS, "hn_keys": HIGH_NDV_KEYS,
              "q3_scale": 1.0}
TOPN_TAXI_COLS = ("cab_type", "passenger_count", "total_amount",
                  "trip_distance", "pickup_datetime")
# (label, WHERE, ORDER BY, LIMIT, the oracle's ascending keys and live
# rows from the taxi columns) of T1-T3
TOPN_TAXI = (
    ("T1", "", "total_amount DESC", 10,
     lambda d: ([-d["total_amount"]], None)),
    ("T2", "", "passenger_count DESC, trip_distance", 1000,
     lambda d: ([-d["passenger_count"], d["trip_distance"]], None)),
    ("T3", "WHERE cab_type = 1 ", "pickup_datetime", 100,
     lambda d: ([d["pickup_datetime"]], d["cab_type"] == 1)),
)
TOPN_NULLS_Q = "SELECT g, x, y FROM t ORDER BY y DESC, g LIMIT {}"
# the crossover: T4's LIMIT as these shares of the nulls table's rows,
# past the default knob, in a session whose knob covers every row
TOPN_SWEEP = (0.03, 0.1, 0.3)


def topn_oracle(keys, topn: int, live=None) -> np.ndarray:
    """Row ids of the first ``topn`` live rows in ascending order of
    ``keys`` (the first major), ties by row id: the live rows whose first
    key is at most the ``topn``-th smallest (``np.partition``), then a
    stable lexsort of those alone."""
    k0 = keys[0] if live is None else keys[0][live]
    kth = np.partition(k0, topn - 1)[topn - 1]
    cand = keys[0] <= kth
    if live is not None:
        cand &= live
    idx = np.flatnonzero(cand)
    order = np.lexsort((idx, *[k[idx] for k in reversed(keys)]))
    return idx[order[:topn]]


def rows_check(out, data, ids, what: str) -> None:
    """A result's columns equal ``data``'s rows ``ids`` in that order:
    NULL flags and values exactly."""
    for name, got in out.items():
        want = data[name][ids]
        equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want),
              f"{what} {name} NULLs")
        equal(np.ma.filled(got, 0), np.ma.filled(want, 0), f"{what} {name}")


def topn_phase(hdk_mod, card, hist, device="cuda", sizes=None,
               want=TOPN_KERNELS):
    """Phase 14: ORDER BY ... LIMIT through the public entry points in a
    default session (the streaming top-n up to
    ``exec.streaming_topn_max`` rows) and in one with the knob at 0 (the
    full sort), each result held row for row against a numpy stable
    lexsort: T1-T3 over the taxi table, T4 over the nulls table at the
    knob and one row past it, HN2 and TPC-H Q3; then T4 at LIMITs of
    ``TOPN_SWEEP`` x its rows in a third session, whose knob covers every
    row, against the full sort (where the routes cross).  Each query must
    take the expected route (``Executor._topn_route``) in each session;
    logs both routes' warm ms.  Returns {query: {route: warm ms}}."""
    t_phase = time.perf_counter()
    sz = {**TOPN_SIZES, **(sizes or {})}
    cuts = [f"{k} {sz[k]} of {v}" for k, v in TOPN_SIZES.items()
            if sz[k] != v]
    log(f"phase 14: the streaming top-n on {device} [{card}]; sizes {sz}; "
        f"cut: {'; '.join(cuts) or 'nothing'}")
    sessions = {"streaming": hdk_mod.HDK(device=device),
                "full": hdk_mod.HDK(device=device,
                                    **{"exec.streaming_topn_max": 0})}
    knob = sessions["streaming"].config.exec.streaming_topn_max
    times = {}

    def both(label, rows, run, check_out, routes=("streaming", "full"),
             want_kernels=(), join=False, pair=sessions):
        times[label] = {}
        for (name, s), route in zip(pair.items(), routes):
            ex = s._executor
            ex._topn_route = None
            if join:
                res, _, lat = join_query(
                    lambda: run(s), card, f"{label}_{name}", rows, hist, ex,
                    route="perfect(recycled)", want=want_kernels)
            else:
                rep = {}
                res = timed_query(lambda: run(s), card, f"{label}_{name}",
                                  rows, hist, want_kernels, report=rep)
                lat = rep["warm_s"]
            check(ex._topn_route == route,
                  f"{label}: route {ex._topn_route} in the {name} session, "
                  f"want {route}")
            check_out(res.to_numpy(), f"{label} ({name} session)")
            times[label][f"{name} session ({route})"] = lat * 1e3
        log(f"topn {label}: warm_ms={times[label]!r} [{card}]")

    t0 = time.perf_counter()
    taxi = gen_taxi(sz["taxi_rows"])
    log(f"taxi data: {sz['taxi_rows']} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    for s in sessions.values():
        s.import_pydict(taxi, name="trips")
    cols = ", ".join(TOPN_TAXI_COLS)
    for label, where, order_by, limit, oracle in TOPN_TAXI:
        sql = (f"SELECT {cols} FROM trips {where}ORDER BY {order_by} "
               f"LIMIT {limit}")
        keys, live = oracle(taxi)
        ids = topn_oracle(keys, limit, live)
        both(label, sz["taxi_rows"], lambda s, q=sql: s.sql(q),
             lambda out, what, ids=ids: rows_check(out, taxi, ids, what))
    for s in sessions.values():
        s.drop_table("trips")
    del taxi

    nulls = gen_nulls(sz["nulls_rows"])
    for s in sessions.values():
        s.import_pydict(nulls, name="t")
    ynull = np.ma.getmaskarray(nulls["y"])
    # y DESC puts NULLs first: a null flag, then -y (0 under a NULL), g;
    # one stable lexsort of every row serves each LIMIT
    order = np.lexsort((nulls["g"],
                        np.where(ynull, 0.0, -np.ma.getdata(nulls["y"])),
                        (~ynull).astype(np.int8)))
    wide = {"streaming": hdk_mod.HDK(device=device, **{
        "exec.streaming_topn_max": sz["nulls_rows"]}),
        "full": sessions["full"]}
    wide["streaming"].import_pydict(nulls, name="t")
    cases = [("T4", knob, ("streaming", "full"), sessions),
             ("T4_past_knob", knob + 1, ("full", "full"), sessions)]
    cases += [(f"T4_limit_{int(f * sz['nulls_rows'])}",
               int(f * sz["nulls_rows"]), ("streaming", "full"), wide)
              for f in TOPN_SWEEP]
    for label, limit, routes, pair in cases:
        both(label, sz["nulls_rows"],
             lambda s, q=TOPN_NULLS_Q.format(limit): s.sql(q),
             lambda out, what, ids=order[:limit]: rows_check(
                 out, nulls, ids, what), routes=routes, pair=pair)
    for s in (*sessions.values(), wide["streaming"]):
        s.drop_table("t")
    del nulls, order, wide

    t0 = time.perf_counter()
    data = gen_high_ndv(sz["hn_rows"], sz["hn_keys"])
    oracle = hn_oracle(data, sz["hn_keys"])
    log(f"high-NDV data and oracle: {time.perf_counter() - t0:.1f} s")
    for s in sessions.values():
        s.import_pydict(data, name="ndv_t")
    both("HN2", sz["hn_rows"],
         lambda s: s.scan("ndv_t").agg("k", "count").sort(
             ("count", "desc"), limit=100).run(),
         lambda out, what: hn_check("HN2", out, oracle),
         want_kernels=[k for k in want if k == "count_hist"])
    for s in sessions.values():
        s.drop_table("ndv_t")
    del data, oracle

    t0 = time.perf_counter()
    tables = dict(zip(("customer3", "orders3", "lineitem3"),
                      gen_tpch_q3(sz["q3_scale"])))
    log(f"TPC-H Q3 data: {time.perf_counter() - t0:.1f} s")
    for s in sessions.values():
        for name, table in tables.items():
            s.import_pydict(table, name=name,
                            schema=q3_schema(hdk_mod.types, name))
    both("Q3", tables["lineitem3"]["l_orderkey"].size,
         lambda s: s.sql(TPCH_Q3),
         lambda out, what: q3_check(what, out, tables),
         want_kernels=[k for k in want if k == "groupby_sums"], join=True)
    for s in sessions.values():
        drop_tables(s, *tables)
    del tables, sessions

    launches = hist.launches()
    for name in want:
        check(launches[name] > 0,
              f"kernel {name} never launched on the top-n path")
    log(f"top-n path: kernel launches {launches}; phase 14 in "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return times

# -- phase 15 -----------------------------------------------------------

# the kernels phase 15 must launch on the card: the 45 shapes' COUNTs
# (K4), integer SUMs (K3) and float SUMs and AVGs (K1)
SURFACE_KERNELS = ("count_hist", "seg_sums_exact", "groupby_sums")
SURFACE_SIZES = {"taxi_rows": 10_000_000, "shape_rows": 1_000_000}


def ref_shape_queries() -> list:
    """``QUERIES`` of tests/test_ref_shapes.py (the 45 query shapes drawn
    from the HDK reference's ArrowBasedExecuteTest), read from the file's
    text."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_ref_shapes.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets]
                == ["QUERIES"]):
            return ast.literal_eval(node.value)
    raise LookupError(f"no QUERIES in {path}")


def gen_ref_shapes(rows: int, seed: int = 31):
    """The shapes' tables: ``rt`` with tests/test_ref_shapes.py's columns
    and value ranges at ``rows`` rows (``fn`` NULL in a fifth of them),
    and its 40-row ``rt_inner``."""
    rng = np.random.default_rng(seed)
    rt = {
        "x": rng.integers(5, 10, rows),
        "y": rng.integers(40, 45, rows),
        "z": rng.integers(100, 105, rows),
        "t": rng.integers(1000, 1010, rows),
        "f": np.round(rng.normal(1.2, 0.4, rows), 6),
        "d": np.round(rng.normal(2.5, 1.0, rows), 6),
        "fn": np.ma.MaskedArray(np.round(rng.normal(-0.5, 1.0, rows), 6),
                                rng.random(rows) < 0.2),
        "w": rng.integers(-50, 50, rows),
        "s": rng.choice(np.array(["foo", "bar", "baz", "quux"],
                                 dtype=object), rows),
        "b": rng.integers(0, 2, rows),
    }
    inner = {
        "x": rng.integers(5, 10, 40),
        "s": rng.choice(np.array(["foo", "bar", "hidden"], dtype=object), 40),
        "v": rng.integers(0, 100, 40),
    }
    return {"rt": rt, "rt_inner": inner}


def timer_steps(hdk_mod, run) -> list:
    """``run()`` with the debug timer on, inside a ``query`` span: its
    step spans as ``{"name", "ms"}``, in order (the span's children)."""
    hdk_mod.enable_debug_timer(True)
    try:
        with hdk_mod.utils.timer.DebugTimer("query"):
            run()
        report = hdk_mod.timer_report()
    finally:
        hdk_mod.enable_debug_timer(False)
    check(report is not None and report["name"] == "query"
          and report.get("children"),
          f"timer_report() {report} holds no step span")
    return report["children"]


def surface_phase(hdk_mod, card, hist, device="cuda", sizes=None,
                  want=SURFACE_KERNELS):
    """Phase 15: the debug timer's step spans of taxi Q1 on the card,
    whose step kinds must equal a CPU session's, and the 45 query shapes
    of tests/test_ref_shapes.py in a session on the card against the same
    queries in a CPU session of the port, over tables from
    ``gen_ref_shapes``: integers and NULLs equal, floats to rtol 1e-9.
    Returns the card session's kernel launches (counted from 0 here)."""
    t_phase = time.perf_counter()
    sz = {**SURFACE_SIZES, **(sizes or {})}
    log(f"phase 15: the debug timer and the reference's query shapes on "
        f"{device} against the CPU [{card}]; sizes {sz}")
    gpu = hdk_mod.HDK(device=device)
    cpu = hdk_mod.HDK(device="cpu")
    t = hdk_mod.types
    taxi = gen_taxi(sz["taxi_rows"])
    for s in (gpu, cpu):
        s.import_pydict(dict(taxi), name="trips", schema={
            "pickup_datetime": t.timestamp(t.TimeUnit.SECOND, False)})
    hist.reset_launches()
    steps = {}
    for name, s in (("card", gpu), ("cpu", cpu)):
        q1 = lambda s=s: s.scan("trips").agg("cab_type", "count").run()
        q1()  # warm: the spans below time no first call
        spans = timer_steps(hdk_mod, lambda: q1().block())
        steps[name] = spans
        log(f"timer taxi_q1 ({name} session): {json.dumps(spans)}")
        taxi_check("q1", q1().to_numpy(), taxi)
    kinds = {k: [sp["name"].split("#")[0] for sp in v]
             for k, v in steps.items()}
    check(kinds["card"] == kinds["cpu"],
          f"taxi Q1's step kinds on the card {kinds['card']} differ from "
          f"the CPU session's {kinds['cpu']}")
    for s in (gpu, cpu):
        s.drop_table("trips")
    del taxi

    tables = gen_ref_shapes(sz["shape_rows"])
    for s in (gpu, cpu):
        for name, data in tables.items():
            s.import_pydict(dict(data), name=name)
    queries = ref_shape_queries()
    check(len(queries) == 45, f"{len(queries)} reference shapes, want 45")
    card_s = 0.0
    for i, sql in enumerate(queries):
        t0 = time.perf_counter()
        got = gpu.sql(sql)
        got.block()
        card_s += time.perf_counter() - t0
        same_result(got.to_numpy(), cpu.sql(sql).to_numpy(),
                    f"shape {i} ({sql})", ordered="ORDER BY" in sql)
    launches = hist.launches()
    for name in want:
        check(launches[name] > 0,
              f"kernel {name} never launched on the reference's shapes")
    for s in (gpu, cpu):
        drop_tables(s, *tables)
    log(f"reference shapes: {len(queries)} equal to the CPU session over "
        f"{sz['shape_rows']} rows; card time {card_s!r} s (first runs); "
        f"kernel launches {launches}; phase 15 in "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches

# -- phase 16: the exact quantiles' pair sort --------------------------------

# (label, rows, groups) of the pair sort at the main path's shapes:
# db-benchmark q6's MEDIAN over 1e8 rows by 1e4 groups of ~1e4 rows (the
# block kernel) and 1e6 groups of ~100 (the warp kernel)
PAIR_SORT_SHAPES = (("groups_1e4", KERNEL_ROWS, 10_000),
                    ("groups_1e6", KERNEL_ROWS, 1_000_000))


def pair_sort_bound_ms(rows: int) -> float:
    """Least time of the pair sort on the card: the scatter reads a row's
    value and id and writes its key, the per-group sort reads and writes
    each key once, over the device-memory rate."""
    nbytes = rows * ((8 + 4 + 8) + (8 + 8))
    return nbytes / HBM_BYTES_PER_S * 1e3


def pair_sort_phase(card, shapes=PAIR_SORT_SHAPES, device="cuda"):
    """Phase 16: ``kernels/pairsort.py::group_sorted_keys`` against its
    plain version by ``torch.equal`` at each (label, rows, groups) of
    ``shapes``, over db-benchmark's six-decimal values, timed beside its
    bound and the plain version; then the exact median through the key
    sort (``_group_quantile_segsort``) beside the permutation
    (``_group_quantile``), equal by ``==``.  Returns the cases.
    ``device`` is for a rehearsal on the CPU."""
    from hdk_tpu_torch.exec import groupby as gb
    from hdk_tpu_torch.exec.masked import MaskedCol
    from hdk_tpu_torch.kernels import pairsort

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(16)
    cases = []
    for label, rows, groups in shapes:
        gid = torch.randint(0, groups, (rows,), device=dev, generator=gen,
                            dtype=torch.int32)
        vals = torch.round(torch.rand((rows,), device=dev, generator=gen,
                                      dtype=torch.float64) * 1e8) / 1e6
        counts = torch.bincount(gid, minlength=groups)
        largest = int(counts.max())
        check(largest <= pairsort.CAPACITY,
              f"pair sort {label}: a group of {largest} keys")
        want = pairsort.group_sorted_keys_ref(vals, gid, None, counts)
        before = pairsort.group_sorted_keys.launches
        got = pairsort.group_sorted_keys(vals, gid, None, counts, largest)
        sync()
        check(pairsort.group_sorted_keys.launches
              == before + (dev.type == "cuda"),
              f"pair sort {label}: the kernels did not launch")
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"pair sort {label}: kernel disagrees with its plain version")
        del got, want
        run = (lambda: pairsort.group_sorted_keys(vals, gid, None, counts,
                                                  largest))
        ms = cuda_ms(run)
        batched_ms = cuda_ms_batched(run)
        plain_ms = cuda_ms(
            lambda: pairsort.group_sorted_keys_ref(vals, gid, None, counts))
        v = MaskedCol(vals, None)
        seg = gb._group_quantile_segsort(v, gid, groups, 0.5, "linear",
                                         counts, largest)
        perm = gb._group_quantile(v, gid, groups, groups + 1, 0.5, "linear")
        check(bool(((seg == perm) | (counts == 0)).all()),
              f"pair sort {label}: the median differs from the permutation's")
        del seg, perm
        quantile_ms = cuda_ms(lambda: gb._group_quantile_segsort(
            v, gid, groups, 0.5, "linear", counts, largest))
        permutation_ms = cuda_ms(lambda: gb._group_quantile(
            v, gid, groups, groups + 1, 0.5, "linear"))
        bound = pair_sort_bound_ms(rows)
        log(f"pair sort {label} N={rows} groups={groups} largest={largest} "
            f"ok (exact) kernel_ms={ms!r} batched_ms={batched_ms!r} "
            f"plain_ms={plain_ms!r} bound_ms={bound!r} share={bound / ms!r} "
            f"median: key sort ms={quantile_ms!r} permutation "
            f"ms={permutation_ms!r} [{card}]")
        cases.append({"label": label, "N": rows, "groups": groups,
                      "largest": largest, "ms": ms, "batched_ms": batched_ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "share": bound / ms, "quantile_ms": quantile_ms,
                      "permutation_ms": permutation_ms})
        del gid, vals, counts, v
    return cases


# slots of each kernel's headline case in the kernels line
REPORTED_SLOTS = {"count_hist": None, "groupby_sums2": "bool",
                  "seg_sums_exact": "int64", "groupby_sums": "float64"}

SOURCES = {
    "count_hist": "hdk_tpu_torch/csrc/int_hist.cu",
    "groupby_sums2": "hdk_tpu_torch/csrc/int_hist.cu",
    "seg_sums_exact": "hdk_tpu_torch/csrc/int_hist.cu",
    "groupby_sums": "hdk_tpu_torch/csrc/hist.cu",
}

# the kernels TPC-H Q3 launches on the join path (phase 7)
JOIN_KERNELS = ("count_hist", "groupby_sums")

REPLACES = {
    "count_hist": "hdk_tpu/ops/pallas_hist2.py:89",
    "groupby_sums2": "hdk_tpu/ops/pallas_groupby.py:180",
    "seg_sums_exact": "hdk_tpu/ops/pallas_hist.py:136",
    "groupby_sums": "hdk_tpu/ops/pallas_groupby.py:72",
}


def main() -> None:
    # phase 1: device
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs one CUDA card")
    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"device count {torch.cuda.device_count()}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hdk_tpu_torch
    from hdk_tpu_torch.kernels import build, hist

    check("jax" not in sys.modules, "jax was imported")
    hdk = hdk_tpu_torch.HDK(device="cuda")
    log(f"session device: {hdk.device}")

    # phase 2: build
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    if "--phase12" in sys.argv:
        # phase 12 alone, at the sizes given (no contract line)
        del hdk
        multihost_phase(card, {}, sizes=json.loads(_arg("--sizes", "{}")))
        return
    if "--phase13" in sys.argv:
        # phase 13 alone, at the sizes given (no contract line)
        del hdk
        bench_phase(card, hist, sizes=json.loads(_arg("--sizes", "{}")))
        return
    if "--phase14" in sys.argv:
        # phase 14 alone, at the sizes given (no contract line)
        del hdk
        hist.reset_launches()
        topn_phase(hdk_tpu_torch, card, hist,
                   sizes=json.loads(_arg("--sizes", "{}")))
        return
    if "--phase15" in sys.argv:
        # phase 15 alone, at the sizes given (no contract line)
        del hdk
        surface_phase(hdk_tpu_torch, card, hist,
                      sizes=json.loads(_arg("--sizes", "{}")))
        return
    if "--phase16" in sys.argv:
        # phase 16 alone (no contract line)
        del hdk
        pair_sort_phase(card)
        return

    t0 = time.perf_counter()
    taxi = gen_taxi(TAXI_ROWS)
    log(f"taxi data: {TAXI_ROWS} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 3: kernels against their plain versions; the sort route hands
    # them entry_count + 1 segments (the last one discards dead rows), the
    # dense route its keys
    entries = (11, 12, taxi_q4_entries(taxi) + 1, 65536)
    # HN1's group buffer: 50M keys + a NULL slot, + the discard segment;
    # K1, K3 and K4 alone at TPC-H Q1's layout (6 groups), K1 at taxi
    # Q2's (9 groups), K2 at the nulls query's (1000 groups)
    report = kernel_phase(hist, entries, (HIGH_NDV_KEYS + 2,), card,
                          main_shapes=MAIN_SHAPES, keyed_shapes=KEYED_SHAPES)
    torch.cuda.empty_cache()

    # phase 4: the main path; counters count its launches only; every
    # aggregate there is a sum, so every dense and scalar reduction hands
    # the kernels its keys (the debug timer's gid counters, read over one
    # untimed run of each query after its timed ones)
    log("sizes cut: taxi 100M rows of the reference's 1.1B and TPC-H "
        "lineitem SF10 (60M rows) of its SF100, for host-side data "
        "generation time and host RAM; phase 9 streams lineitem at SF100 "
        "(600M rows), uncut")
    hist.reset_launches()
    sources = {"gid_keys": 0, "gid_array": 0}
    taxi_phase(hdk_tpu_torch, hdk, taxi, card, hist, sources)
    del taxi
    tpch_phase(hdk_tpu_torch, hdk, card, hist, sources)
    nulls_phase(hdk, card, hist, sources)
    launches = hist.launches()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    log(f"main path: group id sources {sources}")
    check(sources["gid_array"] == 0 and sources["gid_keys"] > 0,
          f"a main-path reduction built its id array ({sources})")
    log_device_cache("phase 4")

    # phases 5-6: the sort route, its launches counted apart; the holistic
    # MEDIAN and QUANTILE must launch the pair sort
    from hdk_tpu_torch.kernels import pairsort

    torch.cuda.empty_cache()
    hist.reset_launches()
    pairsort.group_sorted_keys.launches = 0
    with EntryRecorder(hist) as recorder:
        high_ndv_phase(hdk, card, hist)
        holistic_phase(hdk_tpu_torch, hdk, card, hist)
    sort_launches = hist.launches()
    for name, n in sort_launches.items():
        check(n > 0, f"kernel {name} never launched on the sort route")
        log(f"sort route: kernel {name} launches={n} "
            f"largest_E={recorder.max_e[name]}")
    pair_launches = pairsort.group_sorted_keys.launches
    check(pair_launches > 0, "the pair sort never launched in phases 5-6")
    log(f"phases 5-6: pair sort launches={pair_launches}")
    check("jax" not in sys.modules, "jax was imported")
    check("pandas" not in sys.modules, "pandas was imported")

    log_device_cache("phases 5-6")

    # phase 7: joins in a session of their own, launches counted apart
    # (TPC-H Q3's string column goes through pyarrow where it is
    # installed, which may load pandas).  The earlier phases dropped
    # their tables, and with them their columns' device copies.
    del hdk
    torch.cuda.empty_cache()
    hist.reset_launches()
    join_phase(hdk_tpu_torch, card, hist, want_q3=JOIN_KERNELS)
    join_launches = hist.launches()
    for name in JOIN_KERNELS:
        check(join_launches[name] > 0,
              f"kernel {name} never launched on the join path")
    log(f"join path: kernel launches {join_launches}")
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 7")

    # phase 8: window functions and array columns in a session of their
    # own, launches counted apart; W3 must launch K1 and K4
    torch.cuda.empty_cache()
    hist.reset_launches()
    window_phase(hdk_tpu_torch, card, hist)
    window_launches = hist.launches()
    for name in WINDOW_KERNELS:
        check(window_launches[name] > 0,
              f"kernel {name} never launched on the window path")
    log(f"window path: kernel launches {window_launches}")
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 8")

    # phase 9: executor controls in a session of their own, launches
    # counted apart; the streamed TPC-H Q1 must launch K1, K3 and K4
    torch.cuda.empty_cache()
    hist.reset_launches()
    controls_phase(hdk_tpu_torch, card, hist)
    controls_launches = hist.launches()
    for name in STREAM_KERNELS:
        check(controls_launches[name] > 0,
              f"kernel {name} never launched on the controls path")
    log(f"controls path: kernel launches {controls_launches}")
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 9")

    # phase 10: the rest of the facade in a session of its own, launches
    # counted apart; the stream must launch K1, K3 and K4, the UDF's
    # GROUP BY K1 and K4 (checked inside)
    torch.cuda.empty_cache()
    hist.reset_launches()
    facade_phase(hdk_tpu_torch, card, hist)
    facade_launches = hist.launches()
    log(f"facade path: kernel launches {facade_launches}")
    log_device_cache("phase 10")

    # phase 11: a 4-shard session on the one card beside a single-device
    # one; its counts are the distributed runs' only (reset before each)
    torch.cuda.empty_cache()
    dist_launches, dist_stats = dist_phase(hdk_tpu_torch, card, hist)
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 11")

    # phase 12: two ranks of a multi-host session on the card, launches
    # counted inside the ranks and summed here
    mh_launches = multihost_phase(card, dist_stats)

    # phase 13: the port's bench, its scripts as processes on the card,
    # launches counted inside the timed query processes and summed here
    torch.cuda.empty_cache()
    bench_launches = bench_phase(card, hist)
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 13")

    # phase 14: the streaming top-n beside the full sort, its launches
    # counted apart (HN2 must launch K4, TPC-H Q3 K1)
    torch.cuda.empty_cache()
    hist.reset_launches()
    topn_phase(hdk_tpu_torch, card, hist)
    topn_launches = hist.launches()
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 14")

    # phase 15: the debug timer's steps and the reference's 45 query
    # shapes on the card against a CPU session, launches counted apart
    torch.cuda.empty_cache()
    surface_launches = surface_phase(hdk_tpu_torch, card, hist)
    check("jax" not in sys.modules, "jax was imported")
    log_device_cache("phase 15")

    # phase 16: the exact quantiles' pair sort against its plain version
    torch.cuda.empty_cache()
    pair_cases = pair_sort_phase(card)

    kernels = []
    for name, rec in report.items():
        # the headline case: taxi Q4's segment count, the kernel's widest
        # slots that one library call also computes
        kind = REPORTED_SLOTS[name]
        q4 = next(c for c in rec["cases"] if c["E"] == entries[2]
                  and c["slots"] == kind and c["ids"] == "array")
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": q4["ms"],
            "plain_ms": q4["plain_ms"], "bound_ms": q4["bound_ms"],
            "bound_by": "bytes", "library_ms": q4["library_ms"],
            "shape": f"N={q4['N']} E={q4['E']} slots={kind}",
            "sort_route_launches": sort_launches[name],
            "sort_route_largest_E": recorder.max_e[name],
            "join_path_launches": join_launches[name],
            "window_path_launches": window_launches[name],
            "controls_path_launches": controls_launches[name],
            "facade_path_launches": facade_launches[name],
            "dist_path_launches": dist_launches[name],
            "multihost_path_launches": mh_launches[name],
            "bench_path_launches": bench_launches[name],
            "topn_path_launches": topn_launches[name],
            "surface_path_launches": surface_launches[name],
            "cases": rec["cases"],
        })
    # the pair sort at db-benchmark q6's shape, its launches those of the
    # holistic MEDIAN and QUANTILE (phases 5-6)
    q6 = pair_cases[0]
    kernels.append({
        "name": "pair_sort", "route": "cuda",
        "source": "hdk_tpu_torch/csrc/pair_sort.cu", "replaces": None,
        "launches": pair_launches, "max_abs_err": 0.0, "ms": q6["ms"],
        "plain_ms": q6["plain_ms"], "bound_ms": q6["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": f"N={q6['N']} groups={q6['groups']}",
        "cases": pair_cases,
    })
    print(card)  # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _arg(name: str, default):
    if name in sys.argv:
        return type(default)(sys.argv[sys.argv.index(name) + 1])
    return default


if __name__ == "__main__":
    if "--rank" in sys.argv:
        print(json.dumps(mh_rank(
            _arg("--rank", 0), _arg("--address", ""),
            _arg("--device", "cuda"), json.loads(_arg("--sizes", "{}")),
            json.loads(_arg("--config", "{}")))), flush=True)
    else:
        main()
