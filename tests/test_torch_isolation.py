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


# public calls and parameters of hdk_tpu's facade the port leaves to
# multi-host sessions (ROADMAP A9b); the port's ``import_pydict`` takes
# ``process_local`` only to raise
_A9_ONLY = {
    # process-local ingest shards a table across hosts
    "process_local",
    # unifies the string dictionaries of process-local shards
    "_unify_process_local_dicts",
}


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_facade_parity():
    """Every public method and property of hdk_tpu's HDK and QueryResult
    exists in the port, but for the multi-device ones; and each facade
    method takes the reference's parameters (plus the port's ``device``)."""
    import inspect

    import hdk_tpu
    import hdk_tpu_torch

    for ref, port in ((hdk_tpu.HDK, hdk_tpu_torch.HDK),
                      (hdk_tpu.QueryResult, hdk_tpu_torch.QueryResult)):
        missing = _public(ref) - _public(port) - _A9_ONLY
        assert not missing, f"{port.__name__} lacks {sorted(missing)}"
        for name in sorted(_public(ref)):
            a, b = getattr(ref, name), getattr(port, name)
            if not inspect.isfunction(a):
                continue
            want = [p for p in inspect.signature(a).parameters
                    if p not in _A9_ONLY]
            got = [p for p in inspect.signature(b).parameters
                   if p not in _A9_ONLY]
            if name == "__init__":
                got.remove("device")
            assert got == want, (port.__name__, name, got, want)
    ref_params = inspect.signature(hdk_tpu.HDK.import_pydict).parameters
    assert "process_local" in ref_params
    assert hasattr(hdk_tpu.HDK, "_unify_process_local_dicts")


def test_multi_host_calls_raise_naming_a9b():
    import hdk_tpu_torch

    with pytest.raises(NotImplementedError, match="A9b"):
        hdk_tpu_torch.HDK(device="cpu", **{"dist.enable": True,
                                           "dist.multi_host": True})
    hdk = hdk_tpu_torch.HDK(device="cpu", **{"dist.enable": True,
                                             "dist.num_devices": 2})
    with pytest.raises(NotImplementedError, match="A9b"):
        hdk.import_pydict({"k": [1, 2]}, name="pl", process_local=True)


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
                       recursive=True)) + ["chip_smoke.py", "k1_ab.py", "profile_smoke.py"]

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
