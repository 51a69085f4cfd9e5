"""One run of one cell: make the tables, import them, warm up, drive the
closed loop for the window, check the answers, and give the metrics.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, generator
(``data/<generator>.py``), traffic mix (``traffic.py``), reference
functions (``reference/``), limits (``limits/<cell>.json``) and one
reader per metric (``metrics/<metric>.py``: ``read(records)`` gives the
value, or None where the run has nothing to read).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import random
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from olap_bench import checks, trace, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hdk_tpu")
SAMPLES = 16          # answers of each shape kept for the check
MAX_WARM_ROUNDS = 30  # rounds of the mix before the window at most


class RunError(Exception):
    """A run that must print no result."""


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return {"cell": cell,
            "config": read_json(os.path.join(ROOT, conf["file"])),
            "mix": traffic.load(cell["traffic"]),
            "limits": read_json(os.path.join(HERE, "limits",
                                             f"{name}.json")),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def to_arrow(cols: Dict[str, np.ndarray], schema: Dict[str, dict]):
    """A generated table as Arrow: strings as dictionary arrays over the
    schema's dictionary, dates as date32, timestamps in seconds."""
    import pyarrow as pa

    arrays = {}
    for name, spec in schema.items():
        v, typ = cols[name], spec["type"]
        if typ == "dict":
            arrays[name] = pa.DictionaryArray.from_arrays(
                pa.array(v), pa.array(spec["dictionary"]))
        elif typ == "date32":
            arrays[name] = pa.array(v.astype(np.int32), pa.date32())
        elif typ == "timestamp_s":
            arrays[name] = pa.array(v, pa.timestamp("s"))
        else:
            arrays[name] = pa.array(v)
    return pa.table(arrays)


def exploring(ex) -> tuple:
    """Counters that grow while the program still explores or compiles:
    route and plan candidates measured, step builds."""
    fb = getattr(ex, "_feedback", None)
    pfb = getattr(ex, "_plan_feedback", None)
    cache = getattr(ex, "code_cache", None)
    return (len(getattr(fb, "_t", ())), len(getattr(pfb, "_cold", ())),
            getattr(cache, "misses", 0))


def ingest_idle() -> None:
    """Wait until the program's ingest worker has finished what the
    imports gave it (copies to the card, fragment stats): the first runs
    time the route candidates, and the window should not share the host
    with that work.  The worker is one thread that keeps its tasks in
    order, so a task queued now ends after them."""
    from hdk_tpu_torch.storage import table

    table._ingest_pool().submit(lambda: None).result()


def choices(ex) -> str:
    """The routes and plan variants the program measured and settled
    on: the last join's route, and each candidate's measured ms."""
    fb = getattr(ex, "_feedback", None)
    measured = {f"{sig[-40:]}:{route}": round(sec * 1e3, 3)
                for (sig, route), sec in getattr(fb, "_t", {}).items()}
    return f"join route {getattr(ex, '_join_route', None)}; measured ms {measured}"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Reservoir:
    """A uniform sample of ``k`` of the answers seen, drawn from the
    seed."""

    def __init__(self, k: int, rng: random.Random) -> None:
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def add(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def _step_spans(node, depth: int, label: str, out: list) -> None:
    for ch in node.children:
        kind = ch.name.split("#")[0]
        out.append((ch.start, ch.start + ch.elapsed_ms / 1e3, depth,
                    f"{label} {kind}"))
        _step_spans(ch, depth + 1, label, out)


def judge(mix: dict, tables, answers: Dict[str, list], max_rel_err: float
          ) -> Tuple[int, float, int, int, str]:
    """Each kept answer against the reference's answer of its shape:
    (mismatches, largest relative error, answers checked, answers wrong,
    the first problem found)."""
    mismatches, rel_err, checked, wrong, first = 0, 0.0, 0, 0, ""
    worst = ""
    for q in mix["queries"]:
        mod, fn = q["reference"].split(":")
        ref = importlib.import_module(f"olap_bench.reference.{mod}")
        want = getattr(ref, fn)(tables)
        for idx, out in answers.get(q["name"], []):
            bad, rel, problem, where = checks.compare(out, want,
                                                      q["compare"])
            checked += 1
            mismatches += bad
            if not rel <= rel_err:
                rel_err, worst = rel, f"{q['name']} {where}"
            wrong += bad > 0 or not rel <= max_rel_err
            if bad and not first:
                first = f"query {idx} ({q['name']}): {problem}"
    if worst:
        first = first or f"largest relative error in {worst}"
    return mismatches, rel_err, checked, wrong, first


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", scale: float = 1.0,
             t_start: Optional[float] = None) -> Tuple[dict, List[str]]:
    """One run; returns (the result line's object, the check lines).
    ``scale`` < 1 shrinks the tables (the CPU tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(name)
    config, mix, limits = spec["config"], spec["mix"], spec["limits"]
    import torch

    import hdk_tpu_torch
    from hdk_tpu_torch.kernels import hist
    from hdk_tpu_torch.utils.timer import DebugTimer, enable_debug_timer

    stamps = [("imports", time.perf_counter())]
    # load the program's compiled libraries (built in a fresh checkout)
    # before anything is timed as a first run
    if torch.device(device).type == "cuda":
        from hdk_tpu_torch.kernels import build
        build.library()
    from hdk_tpu_torch.storage import native
    native.load_native()
    stamps.append(("kernel build", time.perf_counter()))
    gen = importlib.import_module(f"olap_bench.data.{config['generator']}")
    tables = gen.generate(config, seed % (1 << 128), scale)
    stamps.append(("generation", time.perf_counter()))
    hdk = hdk_tpu_torch.HDK(device=device, **config.get("session", {}))
    for tname, cols in tables.items():
        hdk.import_arrow(to_arrow(cols, config["tables"][tname]["columns"]),
                         name=tname)
    ingest_idle()
    stamps.append(("import", time.perf_counter()))
    rows = {t: len(next(iter(c.values()))) for t, c in tables.items()}
    shapes = traffic.build(mix, hdk, rows, config)
    ex = hdk._executor

    first_ms = {}
    for s in shapes:
        t0 = time.perf_counter()
        s.call().to_numpy()
        first_ms[s.name] = (time.perf_counter() - t0) * 1e3
    stamps.append(("first runs", time.perf_counter()))
    rounds = 0
    while rounds < MAX_WARM_ROUNDS:
        before = exploring(ex)
        for s in shapes:
            s.call().to_numpy()
        rounds += 1
        if rounds >= 2 and exploring(ex) == before:
            break
    if exploring(ex) != before:
        raise RunError(f"the warm-up did not settle in {rounds} rounds")
    stamps.append(("warm-up", time.perf_counter()))
    chosen = choices(ex)

    rng = random.Random(seed)
    kept = {s.name: Reservoir(SAMPLES, rng) for s in shapes}
    lat: List[float] = []
    done_rows = failed = 0
    errors: List[str] = []
    plan_ms: List[float] = []
    fetch_ms: List[float] = []
    spans: List[tuple] = []
    profiling = trace_on and torch.device(device).type == "cuda"
    n_prof = int(mix.get("profiled_queries", 8)) if profiling else 0
    prof = summary = None
    prof_bytes = 0
    builds0, launches0 = ex._join_builds, sum(hist.launches().values())
    if trace_on:
        enable_debug_timer(True)
    gc.collect()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if profiling:
        prof, t_marker = trace.start()
    deadline = time.perf_counter() + seconds
    i = 0
    t_prof_end = None
    while True:
        s = shapes[i % len(shapes)]
        timer = DebugTimer("query") if trace_on else contextlib.nullcontext()
        q0 = time.perf_counter()
        try:
            with timer:
                res = s.call()
            if trace_on and i >= n_prof:
                res.block()  # the fetch span: materialize, not the wait
            q1 = time.perf_counter()
            out = res.to_numpy()
            del res
            q2 = time.perf_counter()
        except Exception:  # noqa: BLE001 - a failed query is counted
            q1 = q2 = time.perf_counter()
            failed += 1
            errors.append(f"{s.name}: {traceback.format_exc(limit=3)}")
            out = None
        lat.append(q2 - q0)
        if out is not None:
            done_rows += s.rows
            kept[s.name].add((i, out))
        if trace_on and out is not None and timer.node is not None:
            node = timer.node
            if i < n_prof:
                prof_bytes += s.read_bytes + traffic.answer_bytes(out)
                spans.append((q0, q1, 1, f"{s.name} plan"))
                spans.append((q1, q2, 1, f"{s.name} fetch"))
                _step_spans(node, 2, s.name, spans)
            else:
                plan_ms.append(node.elapsed_ms
                               - sum(c.elapsed_ms for c in node.children))
                fetch_ms.append((q2 - q1) * 1e3)
        del out
        i += 1
        if profiling and i == n_prof:
            t_prof_end = time.perf_counter()
            prof.stop()
        if q2 >= deadline and (not profiling or i >= n_prof):
            break
    window_s = q2 - t_window
    if profiling:
        summary = trace.summarize(trace.device_events(prof), t_marker,
                                  t_prof_end, spans)
        if summary is not None:
            summary["least_bytes"] = prof_bytes
    if trace_on:
        enable_debug_timer(False)
    builds = ex._join_builds - builds0
    launches = sum(hist.launches().values()) - launches0
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that must not be: {found}")
    n_answers = {s.name: kept[s.name].seen for s in shapes}
    del shapes, hdk, ex
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    answers = {n: r.items for n, r in kept.items()}
    mismatches, rel_err, checked, wrong, first_problem = judge(
        mix, tables, answers, limits["max_rel_err"])
    correct = wrong == 0 and failed == 0 and checked > 0

    records = {
        "setup_s": setup_s, "window_s": window_s, "latencies_s": lat,
        "rows_done": done_rows, "queries": len(lat),
        "first_run_ms": first_ms,
        "join_builds": builds, "hist_launches": launches,
        "plan_ms": plan_ms, "fetch_ms": fetch_ms, "trace": summary,
    }
    metrics = {}
    for m in (spec["per_layer"] if trace_on else spec["end_to_end"]):
        # a quantity split by cells ("rows_per_s.tpch") has one reader
        base = m["name"].split(".")[0]
        reader = importlib.import_module(f"olap_bench.metrics.{base}")
        v = reader.read(records)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec["cell"]["chips"] if cuda else 1,
           "memory_peak_bytes": int(peak)}
    if trace_on and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    if cuda:
        dev["card"] = card_line()
    result = {"correct": bool(correct), "attempted": len(lat),
              "failed": failed + wrong,
              "metrics": metrics, "device": dev}
    if trace_on and summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    check = {"mismatches": {"value": mismatches, "limit": 0},
             "max_rel_err": {"value": rel_err,
                             "limit": limits["max_rel_err"]},
             "answers_checked": {"value": checked, "limit": 1},
             "failed_queries": {"value": failed, "limit": 0}}
    result["checks"] = check
    lines = [f"{k} {v['value']!r} limit {v['limit']!r}"
             for k, v in check.items()]
    phases = ", ".join(f"{n} {t - t0!r}" for (n, t), (_, t0) in
                       zip(stamps, [("start", t_start)] + stamps))
    notes = [f"set-up s: {phases}",
             f"window {window_s!r} s, {len(lat)} queries {n_answers}, "
             f"warm-up rounds {rounds}", chosen]
    if first_problem:
        notes.append(f"answers: {first_problem}")
    notes += errors[:3]
    return result, notes + lines
