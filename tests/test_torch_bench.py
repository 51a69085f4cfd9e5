"""The port's bench (bench_torch.py, bench_suite_torch.py,
bench_scaling_torch.py, tools/*_torch.py, hdk_tpu_torch/utils/benchtime.py)
on the CPU at tiny sizes:

  * its data is the JAX scripts' to the byte: the suite's and the scaling
    bench's generators are called with a stub session that records what
    ``import_pydict`` receives and raises before any query (no JAX
    script's ``main()`` runs: they write files at the repository's
    root);
  * each bench query gives the same result through hdk_tpu and
    hdk_tpu_torch (``torch_twin.assert_same``);
  * ``benchtime`` forces a join result's lazy columns;
  * the record carries bench.py's keys, each script's record has the
    keys its ``RECORD_KEYS`` names, and a query, config or shard count
    whose process fails, or a timed result that differs from its numpy
    oracle (``bench_common_torch``), fails the script;
  * no file of the JAX bench changes.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench
import bench_scaling
import bench_suite
import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same, assert_same_storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import bench_common_torch as common  # noqa: E402
import bench_ingest_torch  # noqa: E402
import bench_scaling_torch  # noqa: E402
import bench_suite_torch as suite  # noqa: E402
import bench_torch  # noqa: E402
import ndv_overhead_torch  # noqa: E402
import q3_analyze_torch  # noqa: E402
import q3_stages_torch  # noqa: E402

# the JAX bench's files, which no test may change
_FROZEN = ["bench.py", "bench_suite.py", "bench_scaling.py",
           "tools/bench_ingest.py", "tools/ndv_overhead.py",
           "tools/q3_analyze.py", "tools/q3_stages.py",
           "BASELINE_MEASURED.json", "NDV_OVERHEAD.json"] + sorted(
    f for f in os.listdir(REPO) if f.startswith("BENCH_")
    and f.endswith(".json"))


def _digest(rel):
    with open(os.path.join(REPO, rel), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


_DIGESTS_AT_IMPORT = {rel: _digest(rel) for rel in _FROZEN}


# -- the data, byte for byte ---------------------------------------------

class _Stop(Exception):
    pass


class _Recorder:
    """A session that records ``import_pydict``'s tables and stops at the
    first query."""

    def __init__(self, **_config):
        self.tables = {}

    def import_pydict(self, data, name=None, schema=None):
        self.tables[name] = (data, {k: str(v)
                                    for k, v in (schema or {}).items()})

    def __getattr__(self, name):
        raise _Stop(name)


def _assert_same_tables(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        (gd, gs), (wd, ws) = got[name], want[name]
        assert gs == ws, name
        assert list(gd) == list(wd), name
        for col in wd:
            a, b = np.asarray(gd[col]), np.asarray(wd[col])
            assert a.dtype == b.dtype, (name, col)
            assert a.tobytes() == b.tobytes(), (name, col)


@pytest.mark.parametrize("rows", [1000, 12_345])
def test_taxi_data_is_the_jax_benchs(rows):
    got, want = bench_torch.gen_data(rows), bench.gen_data(rows)
    _assert_same_tables({"t": (got, {})}, {"t": (want, {})})


_JAX_SUITE = {
    "join": lambda h, s: bench_suite.bench_join(h, s),
    "zipf": lambda h, s: bench_suite.bench_zipf_join(h, s),
    "groupby": lambda h, s: bench_suite.bench_high_ndv(h, s),
    "tpch": lambda h, s: bench_suite.gen_lineitem(h, int(60_000_000 * s)),
    "tpch3": lambda h, s: bench_suite.bench_tpch_q3(h, s),
}


@pytest.mark.parametrize("config", suite.CONFIGS)
def test_suite_tables_are_the_jax_suites(config):
    scale = 0.0002
    jx = _Recorder()
    try:
        _JAX_SUITE[config](jx, scale)
    except _Stop:
        pass
    pt = _Recorder()
    suite.import_tables(pt, suite.SUITE[config][0](scale))
    _assert_same_tables(pt.tables, jx.tables)
    assert jx.tables


def test_scaling_tables_are_the_jax_scalings(monkeypatch):
    jx = _Recorder()
    monkeypatch.setattr(hdk_tpu, "HDK", lambda **cfg: jx)
    with pytest.raises(_Stop):
        bench_scaling.run_one(4, 5000)
    got = {n: (d, {}) for n, d in bench_scaling_torch.gen_tables(5000).items()}
    _assert_same_tables(got, jx.tables)


# -- the queries through both packages -------------------------------------

def test_taxi_queries_agree():
    data = bench_torch.gen_data(20_000)
    jx = bench_torch.engine_suite(hdk_tpu.HDK(), data, hdk_tpu.types)
    pt = bench_torch.engine_suite(hdk_tpu_torch.HDK(device="cpu"), data)
    for name in bench_torch.QUERIES:
        assert_same(jx[name](), pt[name](), ordered=name == "q4",
                    f32_avg=("total_amount_avg",))


# SUM and AVG over float32 columns come out as float32: the JAX package
# adds in float32 blocks, the port in float64 (ROADMAP C.5), so they
# compare at float32's rounding
_F32_COLUMNS = ("fee_sum", "revenue")


@pytest.mark.parametrize("config", suite.CONFIGS)
def test_suite_queries_agree(config):
    scale = 0.0005
    tables = suite.SUITE[config][0](scale)
    jx, pt = hdk_tpu.HDK(), hdk_tpu_torch.HDK(device="cpu")
    suite.import_tables(jx, tables, hdk_tpu.types)
    suite.import_tables(pt, tables)
    assert_same_storage(jx, pt)
    queries = suite.SUITE[config][1]
    for (label, qj, rows, nbytes), (label_p, qp, rows_p, nbytes_p) in zip(
            queries(jx, scale), queries(pt, scale)):
        assert (label, rows, nbytes) == (label_p, rows_p, nbytes_p)
        assert_same(qj(), qp(), ordered=True, f32_avg=_F32_COLUMNS)


def test_scaling_queries_agree():
    """The scaling bench's six queries, one device and 4 shards, against
    hdk_tpu's single-device session."""
    tables = bench_scaling_torch.gen_tables(6000)
    cfg = {"exec.enable_route_feedback": False}
    jx = hdk_tpu.HDK(**cfg)
    ports = [hdk_tpu_torch.HDK(device="cpu", **cfg),
             hdk_tpu_torch.HDK(device="cpu", **cfg, **{
                 "dist.enable": True, "dist.num_devices": 4})]
    for h in [jx, *ports]:
        for name, data in tables.items():
            h.import_pydict(data, name=name)
    want = bench_scaling_torch.queries(jx)
    for pt in ports:
        for name, q in bench_scaling_torch.queries(pt).items():
            assert_same(want[name](), q(), ordered=name == "q4_agg_sort")


def test_numpy_baseline_computes_the_pandas_one():
    data = bench_torch.gen_data(5000)
    pd_q, np_q = bench_torch.pandas_suite(data), common.taxi_oracle(data)
    assert np.array_equal(np_q["q1"]()["count"], pd_q["q1"]().to_numpy())
    # pandas' mean of a float32 column is a float32
    np.testing.assert_allclose(np_q["q2"]()["total_amount_avg"],
                               pd_q["q2"]().to_numpy(), rtol=1e-6)
    assert np.array_equal(np_q["q3"]()["count"], pd_q["q3"]().to_numpy())
    q4 = np_q["q4"]()
    assert np.array_equal(q4["count"], pd_q["q4"]().to_numpy())
    assert len(q4["passenger_count"]) == len(q4["count"])


# -- the oracles the timed runs are held against ---------------------------

def test_taxi_results_equal_their_oracles():
    data = bench_torch.gen_data(20_000)
    pt = bench_torch.engine_suite(hdk_tpu_torch.HDK(device="cpu"), data)
    for name in bench_torch.QUERIES:
        common.taxi_check(name, pt[name]().to_numpy(), data)


@pytest.mark.parametrize("config", suite.CONFIGS)
def test_suite_results_equal_their_oracles(config):
    scale = 0.0005
    tables = suite.SUITE[config][0](scale)
    pt = hdk_tpu_torch.HDK(device="cpu")
    suite.import_tables(pt, tables)
    for label, q, _, _ in suite.SUITE[config][1](pt, scale):
        suite.check_result(config, label, q(), tables, scale)


def test_a_result_that_differs_fails_the_run(monkeypatch, tmp_path):
    """A timed query whose result differs from its oracle fails the
    config's run and bench_torch.py."""
    real = common.hn_oracle

    def one_off(data, keys):
        present, counts, sums = real(data, keys)
        return present, counts + (np.arange(counts.size) == 3), sums

    monkeypatch.setattr(common, "hn_oracle", one_off)
    with pytest.raises(RuntimeError, match="HN1 count: differs"):
        suite.run_config(hdk_tpu_torch.HDK(device="cpu"), "groupby", 0.0002)

    taxi = common.taxi_oracle

    def off_q2(data):
        out = taxi(data)
        q2 = out["q2"]
        out["q2"] = lambda: {**q2(), "total_amount_avg":
                             q2()["total_amount_avg"] * 1.001}
        return out

    monkeypatch.setattr(common, "taxi_oracle", off_q2)
    monkeypatch.setenv("BENCH_ROWS", "3000")
    monkeypatch.setenv("BENCH_ISOLATED", "0")
    with pytest.raises(RuntimeError, match="taxi_q2 total_amount_avg"):
        bench_torch.main(["--device", "cpu", "--out-dir", str(tmp_path)])


# -- the timer ------------------------------------------------------------

def test_benchtime_forces_a_joins_lazy_columns(monkeypatch):
    from hdk_tpu_torch.exec import common
    from hdk_tpu_torch.utils import benchtime

    calls = []
    made = []
    init = common._LazyThunkColumns.__init__

    def counting_init(self, thunks):
        def wrap(i, th):
            def run():
                calls.append(i)
                return th()
            return run
        made.append(len(thunks))
        init(self, [wrap(i, th) for i, th in enumerate(thunks)])

    monkeypatch.setattr(common._LazyThunkColumns, "__init__", counting_init)
    hdk = hdk_tpu_torch.HDK(device="cpu")
    rng = np.random.default_rng(0)
    t = hdk.import_pydict({"k": rng.integers(0, 50, 400),
                           "a": rng.random(400)}, name="f")
    d = hdk.import_pydict({"k": np.arange(50), "b": rng.random(50)},
                          name="d")

    def q():
        return t.join(d, "k", "k").run()

    assert type(q()._table.columns) is common._LazyThunkColumns
    made.clear()
    calls.clear()
    m = benchtime.measure(q, warmup=1, iters=2, latency_iters=3)
    assert m["latency_s"] > 0 and m["throughput_s"] > 0
    # every result of the 6 runs has every column gathered, once
    assert len(made) == 6
    assert sorted(calls) == sorted(list(range(made[0])) * 6)
    assert made[0] == 4


def test_benchtime_tips_of_tensors_and_containers():
    import torch

    from hdk_tpu_torch.utils import benchtime

    x, y = torch.zeros(3), torch.ones(2)
    assert [id(v) for v in benchtime._tips({"a": (x, [y])})] == [
        id(x), id(y)]
    assert benchtime._tips(np.zeros(3)) == []
    assert benchtime.sync(x) is x


# -- the scripts ---------------------------------------------------------

BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline",
                 "detail_Mrows_per_sec", "detail_latency_ms",
                 "baseline_oracle", "timing", "rows")


def test_record_carries_the_bench_py_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ROWS", "3000")
    monkeypatch.setenv("BENCH_ISOLATED", "0")
    out = str(tmp_path / "out")
    bench_torch.main(["--device", "cpu", "--out-dir", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in BENCH_PY_KEYS + ("card", "mode", "device"):
        assert k in rec, k
    assert tuple(rec) == bench_torch.RECORD_KEYS
    assert rec["card"] == "cpu" and rec["mode"] == "in_process"
    assert rec["result_check"] == "numpy"
    # the plain versions run on the CPU: no kernel launches
    assert rec["launches"] == {k: 0 for k in rec["launches"]}
    assert "count_hist" in rec["launches"]
    assert rec["baseline_oracle"] == "pandas" and not rec["baseline_cached"]
    assert sorted(rec["detail_Mrows_per_sec"]) == list(bench_torch.QUERIES)
    assert os.listdir(out) == ["baseline_pandas_3000.json"]
    # a second run reads this host's cached baseline; without pandas the
    # numpy oracle is measured and cached apart
    bench_torch.main(["--device", "cpu", "--out-dir", out])
    assert json.loads(capsys.readouterr().out.strip())["baseline_cached"]
    monkeypatch.setitem(sys.modules, "pandas", None)
    bench_torch.main(["--device", "cpu", "--out-dir", out])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["baseline_oracle"] == "numpy" and not rec["baseline_cached"]


def test_isolated_mode_on_the_cpu(tmp_path, monkeypatch, capsys):
    """A process per query, each printing its record."""
    monkeypatch.setenv("BENCH_ROWS", "2000")
    monkeypatch.setenv("BENCH_ISOLATED", "1")
    bench_torch.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mode"] == "isolated" and rec["rows"] == 2000
    assert tuple(rec) == bench_torch.RECORD_KEYS
    assert sorted(rec["launches"]) == sorted(
        ["count_hist", "groupby_sums", "groupby_sums2", "seg_sums_exact"])
    assert all(v > 0 for v in rec["detail_latency_ms"].values())


@pytest.fixture
def failing_python(monkeypatch):
    """Every child process the scripts start exits 1 at once."""
    monkeypatch.setattr(sys, "executable", shutil.which("false"))


def test_a_failed_query_process_fails_bench_torch(failing_python,
                                                  monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_ROWS", "1000")
    monkeypatch.setenv("BENCH_ISOLATED", "1")
    with pytest.raises(SystemExit) as e:
        bench_torch.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    assert "query q1 failed (rc 1)" in str(e.value.code)


def test_a_failed_config_process_fails_the_suite(failing_python, tmp_path):
    with pytest.raises(SystemExit) as e:
        suite.main(["--device", "cpu", "--scale", "0.0001", "--out",
                    str(tmp_path / "s.json")])
    assert "config join failed (rc 1)" in str(e.value.code)
    assert not (tmp_path / "s.json").exists()


def test_a_failed_shard_count_fails_the_scaling_bench(failing_python,
                                                      tmp_path):
    with pytest.raises(SystemExit) as e:
        bench_scaling_torch.main(["--device", "cpu", "--rows", "1000",
                                  "--out", str(tmp_path / "s.json")])
    assert "1 shards failed (rc 1)" in str(e.value.code)


_SCRIPTS = [bench_torch, suite, bench_scaling_torch, bench_ingest_torch,
            ndv_overhead_torch, q3_analyze_torch, q3_stages_torch]


@pytest.mark.parametrize("script", _SCRIPTS, ids=lambda m: m.__name__)
def test_cuda_by_default_raises_without_a_card(script, monkeypatch):
    """No ``--device cpu`` and no card: the script raises, and falls back
    to nothing."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_ROWS", "1000")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main([])


def test_a_script_without_a_card_exits_non_zero(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "BENCH_ROWS": "1000"})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not proc.stdout.strip()


def test_suite_and_scaling_on_the_cpu(tmp_path):
    """One config of the suite and two shard counts, each in its own
    process; their records and files."""
    out = tmp_path / "suite.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_suite_torch.py"),
         "--device", "cpu", "--scale", "0.0002", "--only", "groupby"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(l) for l in proc.stdout.splitlines()]
    assert [r["config"].split()[0] for r in recs] == ["groupby",
                                                      "groupby+top100"]
    for r in recs:
        assert tuple(r) == suite.RECORD_KEYS
        assert r["warm_builds"] == 0 and len(r["seconds_samples"]) == 3
        assert r["bytes_ideal"] > 0 and r["card"] == "cpu"
        assert r["result_check"] == "numpy"
    out = tmp_path / "scaling.json"
    bench_scaling_torch.main(["--device", "cpu", "--rows", "4000",
                              "--devices", "1", "2", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert tuple(rec) == bench_scaling_torch.RECORD_KEYS
    assert sorted(rec["seconds_per_query"]) == ["1", "2"]
    assert rec["cards_by_shards"] == {"1": 0, "2": 0}
    assert rec["predicted_efficiency"].startswith("left out")
    two = rec["seconds_per_query"]["2"]["_comm"]
    assert two["groupby_unbounded_shuffle"]["agg_route"] == "two_phase"


def test_scaling_prediction_from_the_link_model():
    results = {"1": {"q": 0.01},
               "2": {"q": 0.008, "_comm": {"q": {
                   "n_collectives": 3,
                   "bytes_per_device_by_op": {"all_to_all": 1_000_000}}}}}
    pred = bench_scaling_torch.predict(results, 1e9, 1e-5)
    p = pred["2"]["q"]
    assert p["t_compute_s"] == 0.005
    assert p["t_wire_s"] == pytest.approx(0.5e6 / 1e9)
    assert p["t_launch_s"] == pytest.approx(3e-5)
    assert p["predicted_efficiency"] == pytest.approx(
        0.01 / (2 * (0.005 + 0.0005 + 3e-5)))
    eff, rel, invalid = bench_scaling_torch.efficiencies(
        {"1": {"q": 0.01, "r": 0.001}, "2": {"q": 0.008, "r": 0.0001}})
    assert eff == {"2": {"q": 0.625}} and rel == {}
    assert [i["query"] for i in invalid] == ["r"]


def test_tools_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The ingest and NDV tools write their records; the two TPC-H Q3
    tools print theirs."""
    monkeypatch.setenv("INGEST_ROWS", "3000")
    monkeypatch.setenv("INGEST_REPS", "1")
    monkeypatch.setenv("NDV_ROWS", "20000")
    monkeypatch.setenv("INGEST_DICT_ROWS", "20000")
    bench_ingest_torch.main(["--device", "cpu", "--out",
                             str(tmp_path / "ingest.json")])
    ingest = json.loads((tmp_path / "ingest.json").read_text())
    assert tuple(ingest) == bench_ingest_torch.RECORD_KEYS
    assert len(ingest["on"]) == len(ingest["off"]) == 1
    assert ingest["importer"] == "pyarrow_import_csv"
    assert ingest["dict_encode"]["rows"] == 20_000
    ndv_overhead_torch.main(["--device", "cpu", "--out",
                             str(tmp_path / "ndv.json")])
    ndv = json.loads((tmp_path / "ndv.json").read_text())
    assert tuple(ndv) == ndv_overhead_torch.RECORD_KEYS
    assert ndv["rows"] == 20_000 and ndv["attempts"] >= 1
    capsys.readouterr()
    q3_analyze_torch.main(["--device", "cpu", "--scale", "0.0005",
                           "--runs", "2"])
    out = capsys.readouterr().out
    assert out.count("run ") == 2 and "=== EXPLAIN ANALYZE ===" in out
    q3_stages_torch.main(["--device", "cpu", "--scale", "0.0005"])
    out = capsys.readouterr().out
    assert [l.split(":")[0] for l in out.splitlines()] == [
        "preagg", "ord_cust", "q3", "q3_original_plan"]


def test_ingest_reads_the_csv_without_pyarrow(tmp_path, monkeypatch):
    """The numpy importer reads what pyarrow's does."""
    ingest = bench_ingest_torch
    path = str(tmp_path / "x.csv")
    ingest.make_csv(path, 500)
    via_arrow = hdk_tpu_torch.HDK(device="cpu")
    a = ingest.import_file(via_arrow, path, "a")
    monkeypatch.setitem(sys.modules, "pyarrow.csv", None)
    assert ingest.importer() == "numpy_loadtxt_import_pydict"
    via_numpy = hdk_tpu_torch.HDK(device="cpu")
    b = ingest.import_file(via_numpy, path, "b")
    aggs = ("count", "sum(amount)", "min(distance)", "max(pickup)")
    assert_same(a.agg(["cab", "vendor"], *aggs).run(),
                b.agg(["cab", "vendor"], *aggs).run(), ordered=False)


def test_no_file_of_the_jax_bench_changed():
    assert {rel: _digest(rel) for rel in _FROZEN} == _DIGESTS_AT_IMPORT
