#!/usr/bin/env python
"""CSV import + first query on hdk_tpu_torch, the device prefetch on
against off (the port's twin of tools/bench_ingest.py).

With ``storage.prefetch_device`` on, ``import_arrow`` hands each column's
copy to the device to the ingest worker while the next column decodes,
and warms the fragment stats in the background; off, the first query
pays the copies and the stats.  Each mode and repetition runs in a fresh
process.  The CSV is written with numpy and imported through
``import_csv`` where pyarrow is installed, else through ``import_pydict``
from ``numpy.loadtxt`` (which has no prefetch: both modes then run the
same code); ``importer`` in the record says which.  Also times the
native bulk dictionary encode, serial against parallel.

    python tools/bench_ingest_torch.py                       # the card
    INGEST_ROWS=20000 INGEST_REPS=1 python tools/bench_ingest_torch.py \
        --device cpu

Prints one JSON line and writes it to ``--out`` (default
``bench_torch_out/bench_ingest.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_common_torch as common  # noqa: E402
import hdk_tpu_torch  # noqa: E402
from hdk_tpu_torch.utils import benchtime  # noqa: E402

COLUMNS = ("cab", "passengers", "amount", "distance", "pickup", "vendor")
# the keys of the record
RECORD_KEYS = ("rows", "device", "importer", "csv_write_seconds",
               "dict_encode", "on", "off", "median_on_s", "median_off_s",
               "speedup_import_plus_first_query")


def make_csv(path: str, rows: int) -> None:
    """The JAX tool's columns (seed 31), written in chunks with numpy."""
    import numpy as np

    rng = np.random.default_rng(31)
    cols = {
        "cab": rng.integers(0, 2, rows).astype(np.int8),
        "passengers": rng.integers(0, 9, rows).astype(np.int8),
        "amount": rng.gamma(2.0, 8.0, rows).astype(np.float32),
        "distance": rng.gamma(1.5, 2.5, rows).astype(np.float32),
        "pickup": np.int64(1356998400) + rng.integers(0, 4 * 365 * 86400,
                                                      rows),
        "vendor": np.asarray(["ACME", "BETA", "GAMMA", "DELTA"])[
            rng.integers(0, 4, rows)],
    }
    with open(path, "w") as f:
        f.write(",".join(COLUMNS) + "\n")
        for s in range(0, rows, 1_000_000):
            sl = slice(s, s + 1_000_000)
            text = [cols["cab"][sl].astype(str),
                    cols["passengers"][sl].astype(str),
                    cols["amount"][sl].astype(str),
                    cols["distance"][sl].astype(str),
                    cols["pickup"][sl].astype(str), cols["vendor"][sl]]
            f.writelines(",".join(r) + "\n" for r in zip(*text))


def importer() -> str:
    try:
        import pyarrow.csv  # noqa: F401
    except ImportError:
        return "numpy_loadtxt_import_pydict"
    return "pyarrow_import_csv"


def import_file(hdk, path: str, name: str):
    if importer() == "pyarrow_import_csv":
        return hdk.import_csv(path, name=name)
    import numpy as np

    nums = np.loadtxt(path, delimiter=",", skiprows=1, usecols=range(5),
                      dtype=np.float64, ndmin=2)
    vendor = np.loadtxt(path, delimiter=",", skiprows=1, usecols=5,
                        dtype=str, ndmin=1)
    data = {"cab": nums[:, 0].astype(np.int64),
            "passengers": nums[:, 1].astype(np.int64),
            "amount": nums[:, 2], "distance": nums[:, 3],
            "pickup": nums[:, 4].astype(np.int64), "vendor": vendor}
    return hdk.import_pydict(data, name=name)


def run_one(csv_path: str, prefetch: bool, device: str) -> None:
    hdk = hdk_tpu_torch.HDK(device=device,
                            **{"storage.prefetch_device": prefetch})

    def import_and_query(name: str) -> float:
        t0 = time.perf_counter()
        t = import_file(hdk, csv_path, name)
        res = t.agg(["cab", "vendor"], "count", "sum(amount)",
                    "min(distance)", "max(pickup)").run()
        benchtime.sync(res)
        return time.perf_counter() - t0

    # the first pass pays the session's one-time costs; the timed pass
    # pays decode, dictionary encode, the copies and the query
    import_and_query("ing_warm")
    secs = import_and_query("ing_t")
    print(json.dumps({"prefetch": prefetch, "seconds": secs}))


_DICT_CODE = r"""
import json, random, sys, time
sys.path.insert(0, sys.argv[1])
from hdk_tpu_torch.storage.native import load_native
m = load_native()
if m is None:
    print(json.dumps({"native": None})); sys.exit(0)
rows = int(sys.argv[2])
rng = random.Random(3)
uniq = [f"str_{i:06d}" for i in range(50_000)]
vals = [uniq[rng.randrange(50_000)] for _ in range(rows)]
d = m.dict_new()
t0 = time.perf_counter(); m.dict_bulk_get_or_add(d, vals)
cold = time.perf_counter() - t0
warm = 1e9
for _ in range(3):
    t0 = time.perf_counter(); m.dict_bulk_get_or_add(d, vals)
    warm = min(warm, time.perf_counter() - t0)
print(json.dumps({"cold_s": cold, "warm_s": warm}))
"""


def bench_dict_encode(rows: int) -> dict:
    """Serial against parallel native bulk dictionary encode (the port's
    ``storage/native.py``), a process per thread count so the thread knob
    is read fresh."""
    out = {"rows": rows, "unique": 50_000}
    for label, threads in (("serial", "1"), ("parallel", "0")):
        # "0": the native default, a thread per core
        out[label] = common.run_child(
            ["-c", _DICT_CODE, ROOT, str(rows)],
            f"bench_ingest_torch: dict encode ({label})",
            {"HDK_TPU_DICT_THREADS": threads}, timeout=600)[-1]
    ser, par = out["serial"], out["parallel"]
    if ser.get("warm_s") and par.get("warm_s"):  # the native module built
        out["warm_speedup"] = ser["warm_s"] / par["warm_s"]
        out["cold_speedup"] = ser["cold_s"] / par["cold_s"]
        out["warm_Mrows_per_s"] = rows / 1e6 / par["warm_s"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--one", nargs=2, metavar=("CSV", "MODE"),
                    help="(internal) one timed import, MODE on or off")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "bench_torch_out", "bench_ingest.json"))
    args = ap.parse_args(argv)
    common.require_card(args.device, "bench_ingest_torch")
    if args.one:
        run_one(args.one[0], args.one[1] == "on", args.device)
        return
    rows = int(os.environ.get("INGEST_ROWS", "10000000"))
    reps = int(os.environ.get("INGEST_REPS", "3"))
    dict_rows = int(os.environ.get("INGEST_DICT_ROWS", "4000000"))
    with tempfile.TemporaryDirectory(prefix="hdk_ingest_") as d:
        csv_path = os.path.join(d, "ingest.csv")
        t0 = time.perf_counter()
        make_csv(csv_path, rows)
        out = {"rows": rows, "device": args.device, "importer": importer(),
               "csv_write_seconds": time.perf_counter() - t0,
               "dict_encode": bench_dict_encode(dict_rows), "on": [],
               "off": []}
        for _ in range(reps):
            for mode in ("on", "off"):
                out[mode].append(common.run_child(
                    [os.path.abspath(__file__), "--one", csv_path, mode,
                     "--device", args.device],
                    f"bench_ingest_torch: prefetch {mode}",
                    timeout=1800)[-1]["seconds"])
    med = lambda xs: sorted(xs)[len(xs) // 2]
    out["median_on_s"] = med(out["on"])
    out["median_off_s"] = med(out["off"])
    out["speedup_import_plus_first_query"] = (out["median_off_s"]
                                              / out["median_on_s"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
