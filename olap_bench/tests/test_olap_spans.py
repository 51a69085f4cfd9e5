"""The readers of the program's span totals (``span_totals.py``:
``parse_ms``, ``bind_ms``, ``optimize_ms``, ``prepare_ms``,
``host_syncs_per_query``) on trees of the program's debug timer, a
program without the totals, and ``plan_ms``, which reads what it read
before the program opened the front end's stages."""

import importlib

import pytest

import hdk_tpu_torch
from olap_bench import harness
from olap_bench.tests.common import SCALE, SEED
from hdk_tpu_torch.utils import timer

READERS = {"parse_ms": "sql:parse", "bind_ms": "sql:bind",
           "optimize_ms": "plan:optimize", "prepare_ms": "exec:prepare"}


def _reader(name):
    return importlib.import_module(f"olap_bench.metrics.{name}")


def _walk(node):
    yield node
    for c in node.stages + node.children:
        yield from _walk(c)


def _self_ms(node):
    return node.elapsed_ms - node.inner_ms


def _plan_ms(root):
    """What the harness reads into ``plan_ms``: the root less its
    children."""
    return root.elapsed_ms - sum(c.elapsed_ms for c in root.children)


def _top_steps(node, under_step=False):
    """The ``step:*`` spans with no ``step:*`` span above them, at any
    depth, stages included."""
    for c in node.stages + node.children:
        step = c.name.startswith("step:")
        if step and not under_step:
            yield c
        yield from _top_steps(c, under_step or step)


@pytest.fixture(autouse=True)
def timer_off():
    yield
    timer.enable_debug_timer(False)


def _sql_query(syncs: int):
    """One traced query's tree of the program's shape: the front end,
    with a subquery the binder runs (its preparation and step), then a
    step that runs a subquery (its own preparation and step)."""
    with timer.DebugTimer("query") as q:
        with timer.DebugTimer("sql:bind", stage=True):
            with timer.DebugTimer("sql:parse", stage=True):
                pass
            with timer.DebugTimer("exec:prepare", stage=True):
                pass
            with timer.DebugTimer("step:Scan#7"):
                pass
        with timer.DebugTimer("plan:optimize", stage=True):
            pass
        with timer.DebugTimer("exec:prepare", stage=True):
            pass
        with timer.DebugTimer("step:Join#3") as step:
            step.node.syncs += syncs
            with timer.DebugTimer("exec:prepare", stage=True):
                pass
            with timer.DebugTimer("step:Scan#1") as inner:
                inner.node.syncs += 1
    return q.node


def _stageless_query():
    """The same query as a program without stages traces it."""
    with timer.DebugTimer("query") as q:
        with timer.DebugTimer("step:Scan#7"):
            pass
        with timer.DebugTimer("step:Join#3"):
            with timer.DebugTimer("step:Scan#1"):
                pass
    return q.node


def test_readers_give_self_times_and_syncs_per_query():
    timer.enable_debug_timer(True)
    roots = [_sql_query(syncs) for syncs in (2, 0, 4)]
    timer.enable_debug_timer(False)
    rec = {"queries": len(roots)}
    nodes = [n for r in roots for n in _walk(r)]
    for metric, span in READERS.items():
        want = sum(_self_ms(n) for n in nodes if n.name == span) / 3
        assert _reader(metric).read(rec) == pytest.approx(want, rel=1e-9)
    prep = [n for n in nodes if n.name == "exec:prepare"]
    assert len(prep) == 9  # the nested preparations count too
    assert _reader("host_syncs_per_query").read(rec) == (2 + 4 + 3) / 3


def test_a_builder_query_has_no_parse_or_bind():
    timer.enable_debug_timer(True)
    with timer.DebugTimer("query"):
        with timer.DebugTimer("plan:optimize", stage=True):
            pass
        with timer.DebugTimer("exec:prepare", stage=True):
            pass
        with timer.DebugTimer("step:Aggregate#2"):
            pass
    timer.enable_debug_timer(False)
    rec = {"queries": 1}
    assert _reader("parse_ms").read(rec) is None
    assert _reader("bind_ms").read(rec) is None
    assert _reader("optimize_ms").read(rec) >= 0
    assert _reader("host_syncs_per_query").read(rec) == 0


@pytest.mark.parametrize("metric", list(READERS) + ["host_syncs_per_query"])
def test_nothing_to_read_gives_none(monkeypatch, metric):
    timer.enable_debug_timer(True)
    _sql_query(1)
    timer.enable_debug_timer(False)
    assert _reader(metric).read({"queries": 0}) is None
    timer.enable_debug_timer(True)  # no span closed since
    assert _reader(metric).read({"queries": 1}) is None
    _sql_query(1)
    timer.enable_debug_timer(False)
    # a program without the totals (the debug timer before them)
    monkeypatch.delattr(timer, "span_totals")
    assert _reader(metric).read({"queries": 1}) is None


@pytest.mark.parametrize("tree", ["no_stages", "program"])
def test_plan_ms_reads_the_root_less_its_top_level_steps(tree):
    """On a tree without stages and on the program's
    (stages, steps inside a stage and inside a step), the harness's
    ``plan_ms`` (the root less its children) equals the root less every
    ``step:*`` span with no ``step:*`` above it: the stages do not move
    it."""
    timer.enable_debug_timer(True)
    root = _stageless_query() if tree == "no_stages" else _sql_query(1)
    timer.enable_debug_timer(False)
    top = list(_top_steps(root))
    assert [c.name for c in top] == ["step:Scan#7", "step:Join#3"]
    assert [c.name for c in root.children] == [c.name for c in top]
    assert _plan_ms(root) == root.elapsed_ms - sum(c.elapsed_ms
                                                   for c in top)


def test_plan_ms_holds_the_front_end_stages():
    """On a query of the program, the four stages' self times lie inside
    ``plan_ms``: the front end's remainder is not negative."""
    session = hdk_tpu_torch.HDK(device="cpu")
    session.import_pydict({"g": [1, 1, 2], "v": [1.0, 2.0, 3.0]}, name="t")
    timer.enable_debug_timer(True)
    with timer.DebugTimer("query") as q:
        session.sql("SELECT g, SUM(v) AS s FROM t GROUP BY g")
    timer.enable_debug_timer(False)
    root = q.node
    front = sum(_self_ms(n) for n in _walk(root)
                if n.name in READERS.values())
    assert front > 0 and [c.name for c in root.stages] == [
        "sql:bind", "plan:optimize", "exec:prepare"]
    assert front <= _plan_ms(root) + 1e-9


@pytest.mark.parametrize("cell,found", [
    ("taxi.q1_q4", {"optimize_ms", "prepare_ms", "host_syncs_per_query"}),
    ("tpch_sf10.q1_q6", {"parse_ms.tpch", "bind_ms.tpch", "optimize_ms.tpch",
                         "prepare_ms.tpch", "host_syncs_per_query.tpch"}),
])
def test_traced_cpu_run_reads_the_spans(cell, found):
    res, lines = harness.run_cell(cell, SEED, 0.3, True, device="cpu",
                                  scale=SCALE[cell])
    assert res["correct"], lines
    mine = set(READERS) | {"host_syncs_per_query"}
    got = {n: m["value"] for n, m in res["metrics"].items()
           if n.split(".")[0] in mine}
    assert set(got) == found
    assert all(v >= 0 for v in got.values())
    assert got[next(n for n in found if n.startswith("host_syncs"))] == 0
