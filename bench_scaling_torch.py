#!/usr/bin/env python
"""Scaling of hdk_tpu_torch's distributed paths: 1 -> N shards (the
port's twin of the JAX package's bench_scaling.py).

    python bench_scaling_torch.py                    # 1, 2, 4 shards
    python bench_scaling_torch.py --devices 1 2 4 8 --link-gbps 450 \
        --collective-us 20                           # with a prediction
    python bench_scaling_torch.py --device cpu --rows 20000

Each shard count runs in a fresh process (``--one``): a session
``HDK(device=..., **{"dist.enable": True, "dist.num_devices": n})`` (one
shard is a single-device session), the same data (seed 17) and six
queries: the high-NDV and the unbounded-key GROUP BY (the two-phase
shuffle), a join + aggregate, a skewed COUNT DISTINCT, a zipf-skewed
join and a bounded-key GROUP BY + ORDER BY count DESC LIMIT 10.  Route
feedback is off, so every run keeps one route.  A shard count whose
process fails fails the run.

On CUDA the shards spread over the cards (shard i on card i mod count);
the record says how many cards they used.  On one card the shards share
it and run one after another, so the efficiency there measures the
distributed path's overhead, not a speed-up.  An efficiency above 1.05
means the 1-shard baseline ran another route and is omitted, loudly.
The prediction (``parallel/link_model.py``) needs the link rate and the
per-collective cost; without them it is left out and the record says
so.  Output: stdout and ``--out`` (default
``bench_torch_out/bench_scaling.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import bench_common_torch as common  # noqa: E402
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.parallel.link_model import LinkModel  # noqa: E402
from hdk_tpu_torch.utils import benchtime, commlog  # noqa: E402

# the keys of the record written to --out
RECORD_KEYS = ("rows", "device", "cards_by_shards", "note",
               "seconds_per_query", "scaling_efficiency_vs_1dev",
               "scaling_efficiency_vs_2dev", "omitted_non_comparable",
               "predicted_efficiency")


def gen_tables(rows: int):
    """The JAX package's bench_scaling data (seed 17): sc_t (a key of
    rows/2 values, an unbounded int62 key, a zipf(1.3) key, a payload and
    a key of 5000 values) and sc_dim (rows/10 keys)."""
    import numpy as np

    rng = np.random.default_rng(17)
    zipf = np.minimum(rng.zipf(1.3, rows), 1 << 20).astype(np.int64)
    sc_t = {
        "k": rng.integers(0, rows // 2, rows),
        "u": rng.integers(0, 1 << 62, rows),
        "z": zipf,
        "v": rng.integers(0, 1000, rows),
        "b": rng.integers(0, 5000, rows),
    }
    sc_dim = {
        "k": rng.permutation(rows // 10).astype(np.int64),
        "w": rng.integers(0, 100, rows // 10),
    }
    return {"sc_t": sc_t, "sc_dim": sc_dim}


def queries(hdk):
    t = hdk.scan("sc_t")
    d = hdk.scan("sc_dim")
    return {
        "groupby_highndv": lambda: t.agg("k", "count", "sum(v)").run(),
        # keys over the whole int62 range: no stats bound a perfect
        # layout, so a dist session takes the two-phase shuffle
        "groupby_unbounded_shuffle": lambda: t.agg(
            "u", "count", "sum(v)").run(),
        "join_agg": lambda: t.join(d, "k", "k").agg(
            [], "count", "sum(w)").run(),
        "skewed_count_distinct": lambda: t.agg(
            "z", "count_distinct(v)").run(),
        "zipf_skew_join": lambda: t.join(d, "z", "k").agg(
            [], "count", "sum(w)").run(),
        # taxi-Q4 class: bounded key + ORDER BY count DESC LIMIT
        "q4_agg_sort": lambda: t.agg("b", "count", "sum(v)").sort(
            ("count", "desc"), limit=10).run(),
    }


def run_one(n_dev: int, rows: int, device: str) -> dict:
    hdk = hdk_tpu_torch.HDK(device=device, **{
        "exec.enable_route_feedback": False,
        "dist.enable": True, "dist.num_devices": n_dev})
    for name, data in gen_tables(rows).items():
        hdk.import_pydict(data, name=name)
    ex = hdk._executor
    mesh = ex._mesh
    out = {}
    comm = {}
    for name, q in queries(hdk).items():
        with commlog.capture() as records:
            benchtime.sync(q())
        comm[name] = commlog.summarize(records, n_dev)
        comm[name]["agg_route"] = ex._dist_agg_route
        comm[name]["join_route"] = ex._dist_join_route or ex._join_route
        out[name] = benchtime.measure(q, warmup=2, iters=4)["throughput_s"]
    out["_comm"] = comm
    out["_shards"] = n_dev
    # the cards the shards spread over (0 on the CPU)
    devs = mesh.devices if mesh is not None else [hdk.device]
    out["_cards"] = len({str(d) for d in devs if d.type == "cuda"})
    return out


def predict(results: dict, link_bytes_per_sec: float,
            alpha_s: float) -> dict:
    """Per shard count and query, ``parallel/link_model.py``'s predicted
    efficiency from the 1-shard seconds and the count's capture."""
    model = LinkModel(link_bytes_per_sec, alpha_s)
    base = results.get("1", {})
    pred = {}
    for n, qs in results.items():
        if n == "1":
            continue
        pred[n] = {}
        for q, comm in qs.get("_comm", {}).items():
            if q not in base:
                continue
            # a records list rebuilt from the summary, with the capture's
            # true collective count for the launch term
            recs = [{"op": op, "axis": "frag", "bytes_per_device": b}
                    for op, b in comm["bytes_per_device_by_op"].items()]
            p = model.predict(base[q], recs, int(n))
            p["n_collectives"] = comm["n_collectives"]
            p["t_launch_s"] = comm["n_collectives"] * alpha_s
            p["t_total_s"] = p["t_compute_s"] + p["t_wire_s"] + p["t_launch_s"]
            p["predicted_efficiency"] = min(
                base[q] / (int(n) * p["t_total_s"]), 1.0)
            pred[n][q] = p
    return pred


def efficiencies(results: dict):
    """(efficiency vs 1 shard, vs 2 shards, omitted rows): base / (n x
    secs); a row above 1.05 against 1 shard is omitted as
    non-comparable."""
    base = results.get("1", {})
    base2 = results.get("2", {})
    eff, rel, invalid = {}, {}, []
    for n, qs in results.items():
        if n == "1":
            continue
        eff[n] = {}
        for q, secs in qs.items():
            if q.startswith("_") or q not in base or secs <= 0:
                continue
            e = base[q] / secs / int(n)
            if e > 1.05:
                invalid.append({"n_devices": int(n), "query": q,
                                "raw_efficiency": e,
                                "reason": "non-comparable baseline (route "
                                          "or cache mismatch); row omitted"})
                print(f"SANITY GATE: {q}@{n} shards efficiency {e} > 1.05"
                      f" -- omitted as non-comparable", file=sys.stderr,
                      flush=True)
                continue
            eff[n][q] = e
        if int(n) > 2:
            rel[n] = {q: base2[q] * 2 / (secs * int(n))
                      for q, secs in qs.items()
                      if not q.startswith("_") and q in base2 and secs > 0
                      and base2[q] > 0}
    return eff, rel, invalid


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="usable link rate a device, GB/s (prediction)")
    ap.add_argument("--collective-us", type=float, default=None,
                    help="fixed cost a collective, us (prediction)")
    ap.add_argument("--one", type=int, default=0,
                    help="(internal) run one shard count")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "bench_torch_out", "bench_scaling.json"))
    args = ap.parse_args(argv)
    common.require_card(args.device, "bench_scaling_torch")
    if args.one:
        print(json.dumps(run_one(args.one, args.rows, args.device)))
        return

    results = {}
    for n in args.devices:
        results[str(n)] = common.run_child(
            [os.path.abspath(__file__), "--one", str(n), "--rows",
             str(args.rows), "--device", args.device],
            f"bench_scaling_torch: {n} shards", timeout=1800)[-1]
        print(n, json.dumps(results[str(n)]), flush=True)

    eff, rel, invalid = efficiencies(results)
    if args.link_gbps and args.collective_us is not None:
        predicted = predict(results, args.link_gbps * 1e9,
                            args.collective_us * 1e-6)
    else:
        predicted = ("left out: no --link-gbps and --collective-us given "
                     "(parallel/link_model.py assumes no link figure)")
    if args.device == "cpu":
        note = ("CPU shards share this host's cores; the efficiency checks "
                "the collective pattern, not a speed-up")
    else:
        note = (f"{torch.cuda.device_count()} card(s); shards on one card "
                "share it and run one after another, so its efficiency "
                "measures the distributed path's overhead")
    rec = {
        "rows": args.rows,
        "device": args.device,
        "cards_by_shards": {n: r["_cards"] for n, r in results.items()},
        "note": note,
        "seconds_per_query": results,
        "scaling_efficiency_vs_1dev": eff,
        "scaling_efficiency_vs_2dev": rel,
        "omitted_non_comparable": invalid,
        "predicted_efficiency": predicted,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({"wrote": args.out, "efficiency": eff,
                      "cards_by_shards": rec["cards_by_shards"],
                      "omitted_non_comparable": len(invalid)}))


if __name__ == "__main__":
    main()
