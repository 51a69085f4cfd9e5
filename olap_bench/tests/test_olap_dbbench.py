"""The db-benchmark cell ``dbbench_g1_1e8.q6_q9`` on the CPU at 2e5 rows
(~20 rows a group: every group answers, no NULL): a traced and an
untraced run with the contract's keys and metrics, planted faults of the
program that the check catches (the lower middle value in place of the
median, r in place of r squared, STDDEV over n in place of n - 1), the
control, the two new readers, and a reference that imports neither jax
nor the port."""

import ast
import importlib
import json
import os

import pytest

from hdk_tpu_torch.exec import groupby as gb
from hdk_tpu_torch.ir.expr import AggKind
from hdk_tpu_torch.utils import timer
from olap_bench import control, harness, traffic
from olap_bench.reference import dbbench as ref
from olap_bench.tests.common import RESULT_KEYS, SCALE, SEED

CELL = "dbbench_g1_1e8.q6_q9"
TINY = 0.002
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


def _run(trace=False, seconds=1.0):
    return harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                            scale=TINY)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_cpu(trace):
    res, lines = _run(bool(trace))
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res) == RESULT_KEYS and list(res)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"] for m in BENCH[kind]
             if CELL in m.get("workloads", [CELL])}
    want = {n for n in names if not trace or not any(
        p["name"] == n and p["source"] == "device_trace"
        for p in BENCH["per_layer"])}
    assert set(res["metrics"]) == want
    for n, m in res["metrics"].items():
        assert m["unit"] == names[n] and m["value"] >= 0
    if trace:
        # q6 and q9 each build the id array once, on the dense route
        assert res["metrics"]["gid_array_per_query"]["value"] == 1.0
    else:
        assert {"setup_s", "rows_per_s.tpch", "query_p95_ms.tpch"} == want


def test_the_tpch_cells_read_no_id_array():
    res, lines = harness.run_cell("tpch_sf10.q1_q6", SEED, 0.3, True,
                                  device="cpu",
                                  scale=SCALE["tpch_sf10.q1_q6"])
    assert res["correct"], lines
    assert res["metrics"]["gid_array_per_query"]["value"] == 0.0


def _lower_middle(monkeypatch):
    real = gb._group_quantile

    def lower(v, gid, n, num, q, interpolation):
        return real(v, gid, n, num, q, "lower")

    monkeypatch.setattr(gb, "_group_quantile", lower)


def _r_for_r2(monkeypatch):
    real = traffic.load

    def load(name):
        mix = real(name)
        for q in mix["queries"]:
            q["sql"] = q["sql"].replace("pow(corr(v1, v2), 2)",
                                        "corr(v1, v2)")
        return mix

    monkeypatch.setattr(traffic, "load", load)


def _stddev_over_n(monkeypatch):
    real = gb.AggResult.finalize

    def finalize(self, spec):
        out = real(self, spec)
        if spec.kind == AggKind.STDDEV_SAMP:
            c = self.slots[2].to(out.data.dtype)
            out.data = out.data * (c - 1).clamp_min(0).sqrt() / c.sqrt()
        return out

    monkeypatch.setattr(gb.AggResult, "finalize", finalize)


@pytest.mark.parametrize("fault", [_lower_middle, _r_for_r2, _stddev_over_n],
                         ids=["lower_middle", "r_for_r2", "stddev_over_n"])
def test_planted_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    res, lines = _run()
    assert not res["correct"], lines
    assert res["failed"] > 0


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 2 ** 33 + 5])
def test_control_is_not_correct(seed):
    """At 1e7 rows: below ~830 rows a group q9's float32 moments, and
    n Sxy - Sx Sy from them, are still exact integers, and the control
    reads ~1e-7 (the cell's 1e8 rows give 1e4 a group)."""
    rec = control.readings(CELL, seed, 0.1)
    assert not rec["correct"]
    assert rec["max_rel_err"] > 3 * rec["limit"]


def _reader(name):
    return importlib.import_module(f"olap_bench.metrics.{name}")


def test_gid_array_reader(monkeypatch):
    timer.enable_debug_timer(True)
    with timer.DebugTimer("step:Aggregate#1"):
        timer.count("gid_array")
        timer.count("gid_keys")
    with timer.DebugTimer("step:Aggregate#2"):
        timer.count("gid_array")
    timer.enable_debug_timer(False)
    read = _reader("gid_array_per_query").read
    assert read({"queries": 4}) == 0.5
    assert read({"queries": 0}) is None
    # a program whose timer has no such counter
    monkeypatch.setattr(timer, "COUNTERS", ())
    assert read({"queries": 4}) is None


def test_sort_kernel_reader():
    ops = {"void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>": 0.3,
           "void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<x>": 0.1,
           "void at::native::radixSortKVInPlace<x>": 0.05,
           "void (anonymous namespace)::k1_kernel<double>": 0.55}
    read = _reader("sort_kernel_pct").read
    assert read({"trace": {"busy_s": 1.0, "ops_s": ops}}) == \
        pytest.approx(45.0)
    assert read({"trace": None}) is None


def test_reference_imports_neither_jax_nor_the_port():
    tree = ast.parse(open(ref.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "typing", "numpy"}, names
