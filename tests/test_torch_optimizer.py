"""The reference's DAG optimizer tests (``tests/test_optimizer.py``:
filter pushdown, join reordering, IN rewrites) over hdk_tpu_torch's own
copy of the optimizer: every test of that file runs on its data and
against its pandas oracle, with the port's session in the place of
``hdk_tpu.HDK``, on the CPU and on a card.  On the CPU each test also
runs on ``hdk_tpu``, and the optimized plans it asks for,
``HDK.explain``'s text, must be the port's, line for line.

``test_estimate_rows`` builds a fake table with ``nrows`` only; the
port's cost model reads ``global_nrows`` (a multi-host table's row count
over every process, ``exec/cost.py``), so its twin is rewritten below
with a fake table that has both.
"""

import pytest

import torch_reftwin as twin  # first: may name the port hdk_tpu
import hdk_tpu_torch
import test_optimizer as ref
from test_optimizer import *  # noqa: F401,F403

device = twin.twin_module(ref)
hdk = twin.per_device(ref.hdk)

_REWRITTEN = {
    "test_estimate_rows": "its fake table has no global_nrows, which the "
                          "port's cost model reads (exec/cost.py)",
}


@pytest.fixture(scope="module")
def fixture_caches():
    """The reference's module fixtures for the comparisons, built once on
    the port and once on the reference."""
    return {}, {}


def test_estimate_rows():
    from hdk_tpu_torch.exec import cost
    from hdk_tpu_torch.ir import node as nd

    class FakeTable:
        nrows = 1000
        global_nrows = 1000

        def column_names(self):
            return []

    scan = nd.Scan.__new__(nd.Scan)
    nd.Node.__init__(scan, [])
    scan.table = FakeTable()
    scan._fields, scan._types = [], []
    assert cost.estimate_rows(scan) == 1000.0
    srt = nd.Sort(scan, [], limit=10)
    assert cost.estimate_rows(srt) == 10.0


@pytest.mark.parametrize(
    "name", sorted(twin.reference_test_names("test_optimizer")
                   - set(_REWRITTEN)))
def test_plans_match_the_reference(name, device, fixture_caches):
    twin.on_reference_only(device)
    func = getattr(ref, name)
    port, reference = fixture_caches
    with twin.recorded(hdk_tpu_torch.HDK, "explain") as plans:
        twin.run_on_port(func, port)
    with twin.recorded(twin.REFERENCE.HDK, "explain") as want:
        twin.run_on_reference(func, reference)
    assert plans == want


def test_every_reference_optimizer_test_is_twinned():
    """Every test of tests/test_optimizer.py is collected here, but the
    rewritten one."""
    twin.assert_every_test_twinned(ref, globals(), _REWRITTEN)
