"""hdk_tpu_torch never imports jax nor anything of hdk_tpu: in a fresh
interpreter, importing the port and running a GROUP BY and a scalar
subquery loads no jax module and no module whose file lies under
hdk_tpu/.  No source of the port, nor the smoke scripts, names hdk_tpu or
the bench scripts in an import or on an import path.  The sort and sketch
modules are the port's own files, and importing them and running the
sort route on numpy data loads neither jax nor pandas."""

import glob
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import hdk_tpu_torch
hdk = hdk_tpu_torch.HDK(device="cpu")
t = hdk.import_pydict({"k": [1, 2, 1, None], "v": [1.0, 2.0, 3.0, 4.0]},
                      name="t")
res = hdk.sql("SELECT k, SUM(v), COUNT(*) FROM t WHERE v > 1 GROUP BY k "
              "ORDER BY k")
out = res.to_numpy()
sub = hdk.sql("SELECT COUNT(*) FROM t WHERE v > (SELECT AVG(v) FROM t)")
ref_dir = os.path.join(sys.argv[1], "hdk_tpu") + os.sep
port_dir = os.path.join(sys.argv[1], "hdk_tpu_torch") + os.sep
under_ref, port_modules = [], []
for name, mod in list(sys.modules.items()):
    path = getattr(mod, "__file__", None) or ""
    if path.startswith(ref_dir):
        under_ref.append(name)
    if path.startswith(port_dir):
        port_modules.append(name)
try:
    hdk_tpu_torch.HDK(device="cuda")
    cuda_raised = False
except RuntimeError:
    cuda_raised = True
print(json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "hdk_tpu": sorted(m for m in sys.modules
                      if m == "hdk_tpu" or m.startswith("hdk_tpu.")),
    "under_ref": sorted(under_ref),
    "port_modules": sorted(port_modules),
    "sum": [float(x) for x in list(out.values())[1]],
    "subquery_count": int(list(sub.to_numpy().values())[0][0]),
    "cuda_available": __import__("torch").cuda.is_available(),
    "cuda_raised": cuda_raised,
}))
"""


_OPS_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from hdk_tpu_torch.ops import sketches, sortops
imported = {"jax": "jax" in sys.modules, "pandas": "pandas" in sys.modules}
import numpy as np
import hdk_tpu_torch
hdk = hdk_tpu_torch.HDK(device="cpu")
hdk.import_pydict({"k": np.array([1.5, 2.5, 1.5, 0.0]),
                   "v": np.ma.MaskedArray([1, 2, 3, 4], [0, 0, 1, 0])},
                  name="t")
out = hdk.sql("SELECT k, COUNT(DISTINCT v), MEDIAN(v), "
              "APPROX_COUNT_DISTINCT(v) FROM t GROUP BY k ORDER BY k"
              ).to_numpy()
print(json.dumps({
    "files": [sortops.__file__, sketches.__file__],
    "imported": imported,
    "after_query": {"jax": "jax" in sys.modules,
                    "pandas": "pandas" in sys.modules},
    "distinct": [int(x) for x in list(out.values())[1]],
}))
"""


_FACADE_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import hdk_tpu_torch
hdk = hdk_tpu_torch.HDK(device="cpu", **{"exec.enable_interop": True})
st = hdk.create_stream({"k": "int64", "v": "fp64"}, ["k"],
                       ["count", "sum(v)", "stddev(v)",
                        "approx_count_distinct(v)"])
st.push({"k": np.array([1, 2, 1]), "v": np.array([1.0, 2.0, 3.0])})
st.push({"k": np.array([1, 2]), "v": np.array([5.0, 4.0])})
stream = st.finish().to_numpy()
hdk.import_pydict({"k": np.array([1, 22])}, name="t")
sub = hdk.sql("SELECT SUBSTR('abc' || k, 2, 3) AS x FROM t").to_numpy()
print(json.dumps({
    "modules": sorted(m for m in sys.modules
                      if m in ("jax", "pandas", "hdk_tpu")
                      or m.startswith(("jax.", "pandas.", "hdk_tpu."))),
    "stream_module": hdk_tpu_torch.streaming.__file__,
    "count": [int(x) for x in stream["count"]],
    "substr": [str(x) for x in sub["x"]],
}))
"""


def test_streaming_and_interop_load_neither_pandas_nor_jax():
    """A stream, and a query that SQLite answers with a text column (the
    engine has neither SUBSTR nor ||), in a fresh interpreter: the port's
    own streaming module, and no jax, pandas or hdk_tpu module."""
    got = _run(_FACADE_PROBE)
    assert got["modules"] == []
    assert got["stream_module"] == os.path.join(
        REPO, "hdk_tpu_torch", "streaming.py")
    assert got["count"] == [3, 2]
    assert got["substr"] == ["bc1", "bc2"]


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_facade_parity():
    """Every public method and property of hdk_tpu's HDK and QueryResult
    exists in the port, and each facade method takes the reference's
    parameters (plus the port's ``device``); so does the unification of
    process-local dictionaries."""
    import inspect

    import hdk_tpu
    import hdk_tpu_torch

    for ref, port in ((hdk_tpu.HDK, hdk_tpu_torch.HDK),
                      (hdk_tpu.QueryResult, hdk_tpu_torch.QueryResult)):
        missing = _public(ref) - _public(port)
        assert not missing, f"{port.__name__} lacks {sorted(missing)}"
        names = sorted(_public(ref))
        if ref is hdk_tpu.HDK:
            names.append("_unify_process_local_dicts")
        for name in names:
            a, b = getattr(ref, name), getattr(port, name)
            if not inspect.isfunction(a):
                continue
            want = list(inspect.signature(a).parameters)
            got = list(inspect.signature(b).parameters)
            if name == "__init__":
                got.remove("device")
            assert got == want, (port.__name__, name, got, want)
    assert "process_local" in inspect.signature(
        hdk_tpu_torch.HDK.import_pydict).parameters



# what hdk_tpu/__init__.py holds that is not the package's own surface:
# imported third-party modules and typing names, and the TPU
# compile-cache helpers (ROADMAP, "Not ported")
_NOT_SURFACE = {"jax", "np", "threading", "_os", "annotations", "Dict",
                "Optional", "Sequence", "_cache_dir", "_platform_tag"}


def test_package_parity():
    """Every function, class and submodule that hdk_tpu/__init__.py
    defines or re-exports exists in hdk_tpu_torch under the same name: a
    function or class as the port's own, a submodule as the port's
    module of the same path."""
    import inspect
    import types

    import hdk_tpu
    import hdk_tpu_torch

    missing, wrong = [], []
    for name, value in vars(hdk_tpu).items():
        if name.startswith("__") or name in _NOT_SURFACE:
            continue
        if isinstance(value, types.ModuleType):
            assert value.__name__.startswith("hdk_tpu."), name
            want = "hdk_tpu_torch" + value.__name__[len("hdk_tpu"):]
        elif inspect.isclass(value) or inspect.isfunction(value):
            want = None
        else:
            continue
        if not hasattr(hdk_tpu_torch, name):
            missing.append(name)
            continue
        port = getattr(hdk_tpu_torch, name)
        if want is not None:
            ok = isinstance(port, types.ModuleType) and port.__name__ == want
        else:
            ok = (inspect.isclass(port) == inspect.isclass(value)
                  and port.__module__.startswith("hdk_tpu_torch"))
        if not ok:
            wrong.append(name)
    assert not missing, f"hdk_tpu_torch lacks {sorted(missing)}"
    assert not wrong, f"not the port's own: {sorted(wrong)}"


_ONE_RANK_PROBE = r"""
import json, socket, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import hdk_tpu_torch
from hdk_tpu_torch.parallel import mesh
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
s.close()
hdk = hdk_tpu_torch.HDK(device="cpu", **{
    "dist.enable": True, "dist.multi_host": True, "dist.num_devices": 2,
    "dist.coordinator_address": f"127.0.0.1:{port}",
    "dist.num_processes": 1, "dist.process_id": 0, "dist.timeout_s": 60})
hdk.import_pydict({"k": np.array([1, 2, 1, 3]),
                   "s": np.array(["a", "b", "a", "c"])}, name="pl",
                  process_local=True)
out = hdk.sql("SELECT s, COUNT(*) AS c, SUM(k) AS sk FROM pl GROUP BY s "
              "ORDER BY s").to_numpy()
print(json.dumps({
    "world": mesh.process_count(),
    "mesh": hdk._executor._mesh.size,
    "process_local": hdk._schema.get("pl").process_local,
    "s": [str(x) for x in out["s"]],
    "c": [int(x) for x in out["c"]],
    "sk": [int(x) for x in out["sk"]],
    "modules": sorted(m for m in sys.modules
                      if m in ("jax", "hdk_tpu")
                      or m.startswith(("jax.", "hdk_tpu."))),
}))
"""


def test_multi_host_calls_work_in_a_one_rank_session():
    """``dist.multi_host`` joins a job of one rank over gloo (in a fresh
    interpreter, whose process group ends with it), and
    ``import_pydict(process_local=True)`` ingests that rank's rows."""
    got = _run(_ONE_RANK_PROBE)
    assert got["world"] == 1 and got["mesh"] == 2
    assert got["process_local"] is True
    assert got["s"] == ["a", "b", "c"]
    assert got["c"] == [2, 1, 1] and got["sk"] == [2, 2, 3]
    assert got["modules"] == []


_DIST_PROBE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import hdk_tpu_torch
from hdk_tpu_torch.parallel import (dist_groupby, dist_join, dist_sort,
                                    dist_window, link_model, mesh, shuffle)
from hdk_tpu_torch.utils import commlog
hdk = hdk_tpu_torch.HDK(device="cpu", **{"dist.enable": True,
                                         "dist.num_devices": 4})
rng = np.random.default_rng(0)
hdk.import_pydict({"k": rng.integers(0, 500, 1001),
                   "v": rng.integers(0, 9, 1001)}, name="t")
with commlog.capture() as rec:
    out = hdk.sql("SELECT k, COUNT(DISTINCT v) AS c FROM t GROUP BY k "
                  "ORDER BY k").to_numpy()
port_dir = os.path.join(sys.argv[1], "hdk_tpu_torch") + os.sep
mods = [dist_groupby, dist_join, dist_sort, dist_window, link_model, mesh,
        shuffle, commlog]
print(json.dumps({
    "modules": sorted(m for m in sys.modules
                      if m in ("jax", "hdk_tpu")
                      or m.startswith(("jax.", "jaxlib", "hdk_tpu."))),
    "own": all(m.__file__.startswith(port_dir) for m in mods),
    "route": hdk._executor._dist_agg_route,
    "ops": sorted({r["op"] for r in rec}),
    "groups": len(out["k"]),
}))
"""


def test_dist_session_loads_neither_jax_nor_hdk_tpu():
    """A 4-shard session on the CPU, in a fresh interpreter: the port's
    own parallel/ and commlog modules, no jax, no hdk_tpu."""
    got = _run(_DIST_PROBE)
    assert got["modules"] == []
    assert got["own"]
    assert got["route"] in ("shuffled", "distinct_split")
    assert "all_to_all" in got["ops"]
    assert got["groups"] > 400


_BENCH_PROBE = r"""
import json, os, runpy, sys
repo, out_dir = sys.argv[1], sys.argv[2]
os.environ.update(BENCH_ROWS="3000", BENCH_ISOLATED="0")
sys.argv = ["bench_torch.py", "--device", "cpu", "--out-dir", out_dir]
runpy.run_path(os.path.join(repo, "bench_torch.py"), run_name="__main__")
print(json.dumps({"modules": sorted(
    m for m in sys.modules if m in ("jax", "hdk_tpu")
    or m.startswith(("jax.", "jaxlib", "hdk_tpu.")))}))
"""


def test_bench_loads_neither_jax_nor_hdk_tpu(tmp_path):
    """``bench_torch.py --device cpu`` (its queries in this process) in a
    fresh interpreter: it prints its record and loads no jax and no
    hdk_tpu module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_PROBE, REPO, str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    record, probe = proc.stdout.strip().splitlines()[-2:]
    assert json.loads(record)["metric"] == "taxi_q1q4_geomean_rows_per_sec"
    assert json.loads(probe)["modules"] == []


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, REPO],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sort_and_sketch_modules_are_the_ports_own():
    got = _run(_OPS_PROBE)
    ops_dir = os.path.join(REPO, "hdk_tpu_torch", "ops") + os.sep
    assert all(f.startswith(ops_dir) for f in got["files"]), got["files"]
    assert got["imported"] == {"jax": False, "pandas": False}
    assert got["after_query"] == {"jax": False, "pandas": False}
    assert got["distinct"] == [1, 1, 1]


@pytest.fixture(scope="module")
def probe():
    return _run(_PROBE)


def test_no_jax_is_imported(probe):
    assert probe["jax"] == []
    assert probe["hdk_tpu"] == []


def test_only_shared_modules_load_from_hdk_tpu(probe):
    """No module at all loads from hdk_tpu's files: the host modules
    (types, builder, IR, SQL, planner, host storage) are the port's own."""
    assert probe["under_ref"] == []
    for m in ("types", "builder", "sql.binder", "exec.optimizer",
              "storage.importers", "utils.logger"):
        assert f"hdk_tpu_torch.{m}" in probe["port_modules"], m


def test_scalar_subquery_runs_without_jax(probe):
    # AVG(v) = 2.5: rows with v = 3.0 and 4.0
    assert probe["subquery_count"] == 2


def test_query_runs_without_jax(probe):
    # k=1: 3.0 (v=1.0 filtered out); k=2: 2.0; k=NULL: 4.0
    assert probe["sum"] == [3.0, 2.0, 4.0]


def test_cuda_session_without_cuda_raises(probe, monkeypatch):
    if not probe["cuda_available"]:
        assert probe["cuda_raised"]
    import hdk_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hdk_tpu_torch.HDK(device="cuda")


# -- static: no source names hdk_tpu or a bench script as an import ------

_SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "hdk_tpu_torch", "**", "*.py"),
                       recursive=True)) + [
    "chip_smoke.py", "k1_ab.py", "profile_smoke.py", "bench_common_torch.py",
    "bench_torch.py", "bench_suite_torch.py", "bench_scaling_torch.py",
    "tools/bench_ingest_torch.py", "tools/ndv_overhead_torch.py",
    "tools/q3_analyze_torch.py", "tools/q3_stages_torch.py",
    "examples/taxi_demo_torch.py", "examples/features_demo_torch.py"]

_FORBIDDEN = [
    (re.compile(r"^\s*import\s+hdk_tpu\b", re.M), "import hdk_tpu"),
    (re.compile(r"^\s*from\s+hdk_tpu[\s.]", re.M), "from hdk_tpu"),
    (re.compile(r"^\s*(import|from)\s+(bench|bench_suite|bench_scaling)\b",
                re.M), "import of a bench script"),
    # the reference's directory joined onto a path, or put on an import path
    (re.compile(r"[\"']hdk_tpu[\"']"), "the hdk_tpu directory as a literal"),
    (re.compile(r"^.*(sys\.path|spec_from_file_location|import_module|"
                r"__path__).*\bhdk_tpu\b(?!_).*$", re.M),
     "hdk_tpu on an import path"),
    (re.compile(r"^\s*__path__\s*=", re.M), "a __path__ rewrite"),
    (re.compile(r"^\s*(import\s+jax\b|from\s+jax[\s.])", re.M),
     "an import of jax"),
]


@pytest.mark.parametrize("rel", _SOURCES)
def test_source_imports_nothing_of_hdk_tpu(rel):
    with open(os.path.join(REPO, rel)) as f:
        text = f.read()
    for pattern, what in _FORBIDDEN:
        m = pattern.search(text)
        assert m is None, f"{rel}: {what}: {m.group(0).strip()!r}"


def test_forbidden_patterns_catch_imports():
    bad = ["import hdk_tpu", "from hdk_tpu.ops import onehot",
           "from hdk_tpu import types", "    import bench",
           "from bench_suite import gen_lineitem",
           'sys.path.insert(0, os.path.join(ROOT, "hdk_tpu"))',
           "__path__ = _overlay(__file__)", "import jax.numpy as jnp",
           "from jax import shard_map"]
    good = ["import hdk_tpu_torch", "from hdk_tpu_torch.kernels import hist",
            '"replaces": "hdk_tpu/ops/pallas_hist2.py:89"',
            "import benchmark_helpers", "import jaxtyping_free"]
    hit = lambda line: any(p.search(line) for p, _ in _FORBIDDEN)
    assert all(hit(b) for b in bad), [b for b in bad if not hit(b)]
    assert not any(hit(g) for g in good), [g for g in good if hit(g)]
