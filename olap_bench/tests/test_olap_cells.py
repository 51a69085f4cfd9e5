"""Each cell's query path on the CPU at a tiny scale, against the
reference: the run is correct and its line has the contract's keys."""

import json
import os

import pytest

from olap_bench import harness
from olap_bench.tests.common import CELLS, RESULT_KEYS, SCALE, SEED

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_cpu(cell, trace):
    res, lines = harness.run_cell(cell, SEED, 0.3, bool(trace),
                                  device="cpu", scale=SCALE[cell])
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res) == RESULT_KEYS  # no breakdown without a device trace
    assert list(res)[-1] == "checks"
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
        assert lines[-len(res["checks"]):][list(res["checks"]).index(k)] \
            .startswith(f"{k} ")
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"] for m in BENCH[kind]
             if cell in m.get("workloads", [cell])}
    if trace:
        # the device-trace readers find nothing on the CPU
        want = {n for n, m in names.items() if not any(
            p["name"] == n and p["source"] == "device_trace"
            for p in BENCH["per_layer"])}
    else:
        want = set(names)
    assert set(res["metrics"]) == want
    for n, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == names[n]
        assert m["value"] == m["value"] and m["value"] >= 0
    json.dumps(res)


def test_join_builds_read_in_the_join_cell():
    res, _ = harness.run_cell("tpch_sf10.q3", SEED, 0.3, True,
                              device="cpu", scale=SCALE["tpch_sf10.q3"])
    assert res["metrics"]["join_builds_per_query"]["value"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res, lines = harness.run_cell(cell, SEED, 1.0, False, device=card,
                                  scale=SCALE[cell] * 20)
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu"
