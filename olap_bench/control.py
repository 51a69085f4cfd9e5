#!/usr/bin/env python3
"""The control of a cell's check: the reference put in the program's
place and computed in float32, the precision below the float64 the
configurations state (inputs rounded to float32, sums accumulated in
float32 one value after another).  Its answers go through the same
comparison as the program's, and have to come out not correct.

    python3 olap_bench/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed with the numbers compared and their limits.
Needs no card: it runs on the host, at the cell's own size unless
``--scale`` shrinks the tables.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from olap_bench import harness  # noqa: E402


def readings(cell: str, seed: int, scale: float = 1.0) -> dict:
    spec = harness.cell_spec(cell)
    config, mix = spec["config"], spec["mix"]
    limit = spec["limits"]["max_rel_err"]
    gen = importlib.import_module(f"olap_bench.data.{config['generator']}")
    tables = gen.generate(config, seed % (1 << 128), scale)
    answers = {}
    for q in mix["queries"]:
        mod, fn = q["reference"].split(":")
        ref = importlib.import_module(f"olap_bench.reference.{mod}")
        out = getattr(ref, fn)(tables, acc=np.float32)
        n = q["compare"].get("limit")
        answers[q["name"]] = [(0, {k: v[:n] for k, v in out.items()}
                               if n else out)]
    mism, rel, checked, wrong, first = harness.judge(mix, tables, answers,
                                                     limit)
    return {"workload": cell, "seed": seed, "scale": scale,
            "mismatches": mism, "max_rel_err": rel, "limit": limit,
            "answers_checked": checked, "answers_wrong": wrong,
            "correct": wrong == 0, "first_problem": first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = readings(args.workload, seed, args.scale)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
