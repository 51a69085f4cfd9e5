"""hdk_tpu_torch never imports jax: in a fresh interpreter, importing the
port and running a query loads no jax module, and nothing of hdk_tpu's
directories except the shared host modules it names."""

import json
import os
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
ref_dir = os.path.join(sys.argv[1], "hdk_tpu") + os.sep
shared = []
for name, mod in list(sys.modules.items()):
    path = getattr(mod, "__file__", None) or ""
    if path.startswith(ref_dir):
        shared.append(name)
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
    "shared": sorted(shared),
    "allowed": sorted(hdk_tpu_torch.SHARED_MODULES),
    "sum": [float(x) for x in list(out.values())[1]],
    "cuda_available": __import__("torch").cuda.is_available(),
    "cuda_raised": cuda_raised,
}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE, REPO],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_jax_is_imported(probe):
    assert probe["jax"] == []
    assert probe["hdk_tpu"] == []


def test_only_shared_modules_load_from_hdk_tpu(probe):
    allowed = {f"hdk_tpu_torch.{m}" for m in probe["allowed"]}
    assert probe["shared"], "the overlay loaded no shared module"
    assert set(probe["shared"]) <= allowed, (
        sorted(set(probe["shared"]) - allowed))


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
