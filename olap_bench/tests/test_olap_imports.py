"""Nothing the benchmark holds imports jax or the JAX package, and the
references import nothing of the program or of the repo's scripts.
Top-level module names (before the first dot) are compared whole."""

import ast
import os

import pytest

from olap_bench import harness

BENCH_DIR = os.path.join(harness.ROOT, "olap_bench")
SCRIPTS = {f[:-3] for f in os.listdir(harness.ROOT) if f.endswith(".py")}


def modules():
    for base, _dirs, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def test_forbidden_names_are_whole():
    assert "hdk_tpu" in harness.FORBIDDEN and "jax" in harness.FORBIDDEN
    assert "hdk_tpu_torch".split(".")[0] not in harness.FORBIDDEN


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    names = set(imported(path))
    assert not names & set(harness.FORBIDDEN), names
    assert not names & SCRIPTS, names  # repo-root scripts are copied from


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p),
    ids=os.path.basename)
def test_reference_is_independent(path):
    assert set(imported(path)) <= {"__future__", "typing", "numpy"}
