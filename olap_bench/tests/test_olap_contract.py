"""BENCHMARK.json against the benchmark's contract, the command without
a card, and a cell added by data alone."""

import json
import os
import re
import shutil
import subprocess
import sys

from olap_bench import harness
from olap_bench.tests.common import SEED

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "olap_bench/run.py"]
    assert BENCH["paths"] == ["olap_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("olap_bench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(
            ROOT, "olap_bench", "data", f"{conf['generator']}.py"))
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
        spec = harness.cell_spec(w["name"])  # mix, limits and config found
        for q in spec["mix"]["queries"]:
            mod = q["reference"].split(":")[0]
            assert os.path.exists(os.path.join(
                ROOT, "olap_bench", "reference", f"{mod}.py"))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)


def test_metrics():
    names = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
        base = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(ROOT, "olap_bench", "metrics",
                                           f"{base}.py"))
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:  # every cell: setup_s, another end-to-end, a per-layer
        mine = {m["name"] for m in BENCH["end_to_end"]
                if w in m.get("workloads", [w])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if w in m.get("workloads", [w])]
        assert layer and all(m["moves"] in mine for m in layer)


def test_command_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "olap_bench/run.py", "--workload", "taxi.q1_q4",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_mix_file_and_an_entry_add_a_cell(tmp_path):
    """A new traffic mix, its limits and a BENCHMARK.json entry make a
    new cell: no file of the harness is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "olap_bench"), root / "olap_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "taxi.q2_q3", "config": "taxi",
                               "traffic": "taxi_q2_q3", "chips": 1,
                               "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.load(open(os.path.join(ROOT, "olap_bench", "mixes",
                                      "taxi_q1_q4.json")))
    mix["queries"] = mix["queries"][1:3]
    (root / "olap_bench" / "mixes" / "taxi_q2_q3.json").write_text(
        json.dumps(mix))
    (root / "olap_bench" / "limits" / "taxi.q2_q3.json").write_text(
        json.dumps({"max_rel_err": 1e-9}))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {ROOT!r}]\n"
        "from olap_bench import harness\n"
        f"assert harness.ROOT == {str(root)!r}\n"
        f"res, _ = harness.run_cell('taxi.q2_q3', {SEED}, 0.2, False, "
        "device='cpu', scale=0.0002)\n"
        "print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["checks"]["answers_checked"]["value"] >= 2
