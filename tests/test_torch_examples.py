"""The port's demos (examples/taxi_demo_torch.py and
examples/features_demo_torch.py, twins of the JAX package's demos) run
once each on the CPU at a tiny size, in a process of their own (each
opens the global session)."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo(name, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), "--device",
         "cpu", *args], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_taxi_demo():
    out = _demo("taxi_demo_torch.py", "--rows", "5000")
    for title in ("Q1: count by cab_type", "Q2: avg fare by passengers",
                  "Q3: counts by passengers x year",
                  "Q4: top groups by count", "builder API: rank by count",
                  "plan for Q1"):
        assert f"== {title}" in out, title
    # Q1's counts are those of the demo's synthetic rows
    cab = np.random.default_rng(0).integers(0, 2, 5000, dtype=np.int8)
    q1 = out.split("== Q1")[1].split("==")[0].splitlines()[2:4]
    assert [int(l.split()[-1]) for l in q1] == np.bincount(cab).tolist()


def test_features_demo():
    out = _demo("features_demo_torch.py", "--rows", "3000")
    assert "ma3" in out and "fare_sum" in out
    assert "Aggregate(keys=[cab], aggs=[count(*)])" in out
    # ROLLUP's grand total holds every row
    assert any(l.split()[-1] == "3000" for l in out.splitlines()
               if "NaN" in l)
