#!/usr/bin/env python3
"""Run one cell of the benchmark once on the CUDA card.

    python3 olap_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Makes the cell's tables from ``--seed``,
imports them into ``hdk_tpu_torch``, runs each query shape once and warms
them up (set-up), then drives a closed loop of one client for
``--seconds`` and checks a sample of the answers against the plain numpy
reference.  The last lines on standard error are the numbers compared,
each beside its limit; the last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

Exits non-zero, and prints no result, without a CUDA card (it never
falls back to the CPU), with fewer cards than the cell asks for, or when
jax, jaxlib, flax or the JAX package is loaded after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from olap_bench import harness

    if not torch.cuda.is_available():
        print("olap_bench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 2
    try:
        chips = harness.cell_spec(args.workload)["cell"]["chips"]
        if torch.cuda.device_count() < chips:
            raise harness.RunError(f"{args.workload} needs {chips} cards, "
                                   f"{torch.cuda.device_count()} visible")
        result, lines = harness.run_cell(args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         t_start=T_START)
    except harness.RunError as err:
        print(f"olap_bench: {err}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
