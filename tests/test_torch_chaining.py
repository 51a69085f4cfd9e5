"""The reference's multi-step plan tests (``tests/test_chaining.py``:
result chaining, unions, the optimizer's folds, the debug timer) over
hdk_tpu_torch: every test of that file runs unchanged, on its data and
against its expected values, with the port's session in the place of
``hdk_tpu.HDK`` and the port's modules in the place of the reference's,
on the CPU and on a card.

The reference's ``test_timer_report`` accepts no report; here the port
must give one, its last step's span with its ``ms``, and on the CPU open
``hdk_tpu``'s step spans for the same query: the same step kinds in the
same order.
"""

import pytest

import torch_reftwin as twin  # first: may name the port hdk_tpu
import hdk_tpu_torch
import test_chaining as ref
from test_chaining import *  # noqa: F401,F403

device = twin.twin_module(ref)
hdk = twin.per_device(ref.hdk)

_TABLES = {"chain_t": {"g": [1, 1, 2, 2, 3, 3, 3],
                       "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]}}


def _deep_pipeline(s):
    ht = s.scan("chain_t")
    return (ht.filter(ht["v"] > 1.5).proj("g", w=ht["v"] * 2)
            .agg("g", "sum(w)").run())


def _self_join(s):
    ht = s.scan("chain_t")
    return ht.join(s.scan("chain_t"), "g", "g").agg([], "count").run()


# the reference's timer query first
_TIMED = {
    "agg_count": lambda s: s.scan("chain_t").agg("g", "count").run(),
    "deep_pipeline": _deep_pipeline,
    "self_join": _self_join,
    "sql_group_by": lambda s: s.sql(
        "SELECT g, SUM(v) AS s FROM chain_t WHERE v > 1 GROUP BY g"),
    "sql_scalar": lambda s: s.sql("SELECT COUNT(*) AS c FROM chain_t"),
}


def test_every_reference_chaining_test_is_run():
    """Every test of tests/test_chaining.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())


@pytest.mark.parametrize("query", list(_TIMED))
def test_timer_report_has_the_reference_steps(query, device):
    twin.assert_timer_steps_match(_TABLES, _TIMED[query], device)


def _sorted_count(s):
    return s.scan("chain_t").agg("g", "count").sort("g").run()


def test_fused_aggregate_sort_has_its_span(device):
    """A Sort that runs with the Aggregate it alone consumes is one step,
    timed in one span, the Sort's.  The reference times no span for that
    step (its fused branch leaves the step loop before the span opens,
    hdk_tpu/exec/executor.py:215), so its spans lack the last one."""
    got, report = twin.timer_steps(_TABLES, _sorted_count, device)
    assert "ms" in report and twin.step_kinds([report["name"]]) == \
        ["step:Sort"] == twin.step_kinds(got[-1:])
    twin.on_reference_only(device)
    with twin.reference_context() as reference:
        want, _ = twin.timer_steps(_TABLES, _sorted_count, device, reference)
    assert twin.step_kinds(got) == twin.step_kinds(want) + ["step:Sort"]


def test_timer_is_off_by_default(device):
    """No span opens while the timer is off: the last report stays the
    one made before the query."""
    s = hdk_tpu_torch.HDK(device=device)
    s.import_pydict(_TABLES["chain_t"], name="chain_t")
    hdk_tpu_torch.enable_debug_timer(True)
    with hdk_tpu_torch.utils.timer.DebugTimer("before"):
        pass
    hdk_tpu_torch.enable_debug_timer(False)
    _TIMED["agg_count"](s)
    assert hdk_tpu_torch.timer_report()["name"] == "before"
