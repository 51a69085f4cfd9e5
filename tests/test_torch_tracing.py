"""The debug timer's spans over a query and its host-sync counter, on the
CPU: the front end's stages (``sql:bind`` around ``sql:parse``,
``plan:optimize``, ``exec:prepare``) beside the step spans, a step tree
(a span's children) the stages leave as it was, their self times,
``timer_report()`` after a bare run, nothing opened or counted while the
timer is off, and the sync counter's capture of PyTorch's sync warnings
while a root is open (with ``torch.cuda``'s sync debug mode replaced by
a stand-in: the CPU build has none).  On the card,
``tests/test_torch_cuda.py`` counts real syncs.  A group-by that builds
the group-id array (MEDIAN, STDDEV) opens ``agg:gid_array`` and
``agg:pair_sort`` under its Aggregate step and counts ``gid_array`` on
it; an all-sum one counts ``gid_keys``."""

import threading
import warnings

import pytest
import torch

import hdk_tpu_torch
from hdk_tpu_torch.utils import timer

_DATA = {"g": [1, 1, 2, 2, 3, 3, 3], "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]}
_OTHER = {"g": [1, 2, 3], "name": ["a", "b", "c"]}

_SQL = {
    "group_by": "SELECT g, SUM(v) AS s FROM t WHERE v > 1 GROUP BY g",
    "sorted": "SELECT g, COUNT(*) AS c FROM t GROUP BY g ORDER BY g",
    "scalar": "SELECT COUNT(*) AS c FROM t",
    "join": "SELECT o.name, SUM(t.v) AS s FROM t JOIN o ON t.g = o.g "
            "GROUP BY o.name",
    # the binder runs the uncorrelated EXISTS: steps inside sql:bind
    "exists": "SELECT COUNT(*) AS c FROM t WHERE EXISTS "
              "(SELECT g FROM o WHERE g > 1)",
}


def _filter_sort(s):
    t = s.scan("t")
    return t.filter(t["v"] > 2).sort("v").run()


_BUILDER = {
    "agg": lambda s: s.scan("t").agg("g", "count").run(),
    "filter_sort": _filter_sort,
    "join": lambda s: s.scan("t").join(s.scan("o"), "g", "g")
    .agg([], "count").run(),
}


@pytest.fixture
def session():
    s = hdk_tpu_torch.HDK(device="cpu")
    s.import_pydict(_DATA, name="t")
    s.import_pydict(_OTHER, name="o")
    return s


@pytest.fixture(autouse=True)
def timer_off():
    yield
    hdk_tpu_torch.enable_debug_timer(False)


def _traced(run):
    """``run()`` inside a ``query`` root with the timer on: the root."""
    hdk_tpu_torch.enable_debug_timer(True)
    try:
        with timer.DebugTimer("query") as t:
            run()
    finally:
        hdk_tpu_torch.enable_debug_timer(False)
    return t.node


def _walk(node):
    """Every span of the tree: the node, its stages, its children."""
    yield node
    for c in node.stages + node.children:
        yield from _walk(c)


def _self_ms(node):
    return node.elapsed_ms - node.inner_ms


def _steps(node, under_step=False):
    """The ``step:*`` spans with no ``step:*`` span above them, at any
    depth, stages included."""
    for c in node.stages + node.children:
        step = c.name.startswith("step:")
        if step and not under_step:
            yield c
        yield from _steps(c, under_step or step)


@pytest.mark.parametrize("query", list(_SQL))
def test_sql_query_opens_the_front_end_spans_in_order(session, query):
    root = _traced(lambda: session.sql(_SQL[query]))
    stages = [c.name for c in root.stages]
    assert stages == ["sql:bind", "plan:optimize", "exec:prepare"], stages
    bind = root.stages[0]
    assert [c.name for c in bind.stages][0] == "sql:parse"
    assert not bind.children
    names = [c.name for c in root.children]
    assert names and all(n.startswith("step:") for n in names), names
    last = root.children[-1]
    starts = [c.start for c in root.stages] + [last.start]
    assert starts == sorted(starts)


@pytest.mark.parametrize("query", list(_SQL))
def test_the_stages_leave_the_step_tree_as_it_was(session, query):
    """A root's children are its top-level step spans, those run inside
    a stage included: the root less its children, which the benchmark's
    ``plan_ms`` reads, is the root less every step span with no step
    above it, as before the stages existed."""
    root = _traced(lambda: session.sql(_SQL[query]))
    top = list(_steps(root))
    assert [c.name for c in root.children] == [c.name for c in top]
    assert all(c.stage for n in _walk(root) for c in n.stages)
    assert not any(c.stage for n in _walk(root) for c in n.children)
    plan = root.elapsed_ms - sum(c.elapsed_ms for c in root.children)
    assert plan == root.elapsed_ms - sum(c.elapsed_ms for c in top)
    if query == "exists":  # the subquery's steps ran inside sql:bind
        bind = root.stages[0]
        inside = [c for c in top if bind.start <= c.start
                  and c.start + c.elapsed_ms / 1e3
                  <= bind.start + bind.elapsed_ms / 1e3]
        assert inside and [c.name for c in bind.stages] == [
            "sql:parse", "exec:prepare"]


@pytest.mark.parametrize("query", list(_BUILDER))
def test_builder_query_opens_no_sql_span(session, query):
    root = _traced(lambda: _BUILDER[query](session))
    names = [n.name for n in _walk(root)]
    assert not [n for n in names if n.startswith("sql:")], names
    assert [c.name for c in root.stages] == ["plan:optimize", "exec:prepare"]
    kids = [c.name for c in root.children]
    assert kids and all(n.startswith("step:") for n in kids), kids


@pytest.mark.parametrize("query", list(_SQL))
def test_self_times_are_non_negative_and_within_the_root(session, query):
    root = _traced(lambda: session.sql(_SQL[query]))
    spans = list(_walk(root))[1:]
    assert all(_self_ms(n) >= -1e-9 for n in spans)
    assert sum(_self_ms(n) for n in spans) <= root.elapsed_ms + 1e-9


@pytest.mark.parametrize("run", [
    lambda s: s.sql(_SQL["group_by"]),
    lambda s: s.sql(_SQL["sorted"]),
    _BUILDER["agg"],
    _BUILDER["join"],
], ids=["sql_group_by", "sql_sorted", "builder_agg", "builder_join"])
def test_report_after_a_bare_run_is_the_last_step(session, run):
    hdk_tpu_torch.enable_debug_timer(True)
    with timer.DebugTimer("query") as t:
        run(session)
    run(session)
    hdk_tpu_torch.enable_debug_timer(False)
    report = hdk_tpu_torch.timer_report()
    last = [c.name for c in t.node.children][-1]
    assert report["name"].startswith("step:") and "ms" in report
    assert report["name"].split("#")[0] == last.split("#")[0]


def test_timer_off_opens_nothing_and_counts_nothing(session):
    hdk_tpu_torch.enable_debug_timer(True)
    with timer.DebugTimer("before"):
        pass
    hdk_tpu_torch.enable_debug_timer(False)
    totals = timer.span_totals()
    session.sql(_SQL["join"])
    _BUILDER["agg"](session)
    with timer.DebugTimer("after") as t:
        pass
    assert t.node is None
    report = hdk_tpu_torch.timer_report()
    assert report["name"] == "before" and "children" not in report
    assert timer.span_totals() == totals == {
        "before": {"spans": 1, "self_ms": totals["before"]["self_ms"],
                   "syncs": 0}}


def test_the_cpu_counts_no_sync(session):
    root = _traced(lambda: session.sql(_SQL["join"]).to_numpy())
    assert all(n.syncs == 0 for n in _walk(root))
    assert "syncs" not in repr(hdk_tpu_torch.timer_report())
    assert all(t["syncs"] == 0 for t in timer.span_totals().values())


def test_span_totals_sum_self_times_by_name(session):
    hdk_tpu_torch.enable_debug_timer(True)
    roots = []
    for q in ("group_by", "join", "group_by"):
        with timer.DebugTimer("query") as t:
            session.sql(_SQL[q])
        roots.append(t.node)
    totals = timer.span_totals()
    hdk_tpu_torch.enable_debug_timer(False)
    want = {}
    for n in (n for r in roots for n in _walk(r)):
        w = want.setdefault(n.name.split("#")[0], [0, 0.0])
        w[0] += 1
        w[1] += _self_ms(n)
    assert set(totals) == set(want)
    for name, (count, ms) in want.items():
        assert totals[name]["spans"] == count
        assert totals[name]["self_ms"] == pytest.approx(ms, rel=1e-9)
    assert totals["sql:parse"]["spans"] == totals["query"]["spans"] == 3
    hdk_tpu_torch.enable_debug_timer(True)  # turning on starts afresh
    assert timer.span_totals() == {}


class _FakeSyncMode:
    """``torch.cuda``'s sync debug mode, as a card has it: ``sync()`` is a
    synchronising operation, which warns in "warn" mode."""

    def __init__(self, mode=0):
        self.mode, self.sets = mode, []

    def install(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                            lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.sets.append(mode)
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)

    def sync(self):
        if self.mode == 1:
            warnings.warn("called a synchronizing CUDA operation (Triggered "
                          "internally at CUDAFunctions.cpp:1.)", UserWarning)


def test_syncs_count_into_the_innermost_span(monkeypatch):
    fake = _FakeSyncMode()
    fake.install(monkeypatch)
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **k: shown.append(str(msg)))
    hdk_tpu_torch.enable_debug_timer(True)
    assert fake.sets == []  # no span open yet
    with timer.DebugTimer("query") as q:
        assert fake.sets == ["warn"]
        fake.sync()
        with timer.DebugTimer("sql:bind", stage=True) as stage:
            fake.sync()
        with timer.DebugTimer("step:Scan#1") as step:
            fake.sync()
            fake.sync()  # the same line again: every sync counts
            warnings.warn("another warning")
        fake.sync()
    assert fake.sets == ["warn", 0] and fake.mode == 0
    fake.sync()  # no span open: the mode is back, nothing warns
    hdk_tpu_torch.enable_debug_timer(False)
    assert (q.node.syncs, stage.node.syncs, step.node.syncs) == (2, 1, 2)
    assert shown == ["another warning"]
    report = hdk_tpu_torch.timer_report()
    assert report["syncs"] == 2 and report["stages"][0]["syncs"] == 1
    assert timer.span_totals()["step:Scan"]["syncs"] == 2
    fake.mode = 1  # the warning state is back: the old hook shows it
    fake.sync()
    assert len(shown) == 2 and "synchronizing" in shown[1]


def test_timer_off_leaves_the_sync_mode_alone(monkeypatch, session):
    fake = _FakeSyncMode()
    fake.install(monkeypatch)
    filters = list(warnings.filters)
    hdk_tpu_torch.enable_debug_timer(False)
    session.sql(_SQL["group_by"])
    assert fake.sets == [] and warnings.filters == filters
    hdk_tpu_torch.enable_debug_timer(True)
    hdk_tpu_torch.enable_debug_timer(True)
    assert fake.sets == [] and warnings.filters == filters
    session.sql(_SQL["group_by"])  # every step a root: set, put back
    n = len(fake.sets)
    assert n >= 4 and fake.sets == ["warn", 0] * (n // 2)
    hdk_tpu_torch.enable_debug_timer(False)
    hdk_tpu_torch.enable_debug_timer(False)
    assert len(fake.sets) == n and fake.mode == 0
    assert warnings.filters == filters


def test_a_caller_warning_state_around_a_root_is_kept(monkeypatch):
    """The sync capture opens and closes with the outermost span, so a
    caller's ``catch_warnings`` around or inside it nests cleanly."""
    fake = _FakeSyncMode()
    fake.install(monkeypatch)
    filters, hook = list(warnings.filters), warnings.showwarning
    hdk_tpu_torch.enable_debug_timer(True)
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with timer.DebugTimer("query") as q:
            with warnings.catch_warnings(record=True) as inner:
                warnings.warn("inside")
            fake.sync()
        fake.sync()
        warnings.warn("after")
    hdk_tpu_torch.enable_debug_timer(False)
    assert q.node.syncs == 1
    assert [str(w.message) for w in inner] == ["inside"]
    assert [str(w.message) for w in outer] == ["after"]
    assert warnings.filters == filters and warnings.showwarning is hook


def test_roots_of_two_threads_share_one_capture(monkeypatch):
    fake = _FakeSyncMode()
    fake.install(monkeypatch)
    hdk_tpu_torch.enable_debug_timer(True)
    opened, closing = threading.Event(), threading.Event()
    got = {}

    def other():
        with timer.DebugTimer("other") as t:
            opened.set()
            closing.wait(5)
            fake.sync()
        got["other"] = t.node.syncs

    th = threading.Thread(target=other)
    with timer.DebugTimer("query") as q:
        th.start()
        opened.wait(5)
        fake.sync()
    assert fake.sets == ["warn"]  # the other thread's root is open
    closing.set()
    th.join(5)
    hdk_tpu_torch.enable_debug_timer(False)
    assert fake.sets == ["warn", 0]
    assert (q.node.syncs, got["other"]) == (1, 1)


@pytest.mark.parametrize("mode", [1, 2])
def test_a_sync_mode_already_set_is_kept(monkeypatch, mode):
    fake = _FakeSyncMode(mode)
    fake.install(monkeypatch)
    hdk_tpu_torch.enable_debug_timer(True)
    with timer.DebugTimer("query") as q:
        with warnings.catch_warnings(record=True):
            fake.sync()
    hdk_tpu_torch.enable_debug_timer(False)
    assert fake.sets == [] and fake.mode == mode and q.node.syncs == 0


# db-benchmark q6's shape: a quantile and STDDEV by a key
_MEDIAN = "SELECT g, MEDIAN(v) AS m, STDDEV(v) AS s FROM t GROUP BY g"


def _counted(totals, name):
    return sum(t.get(name, 0) for t in totals.values())


def test_the_id_array_and_the_pair_sort_are_spans_of_the_step(session):
    hdk_tpu_torch.enable_debug_timer(True)
    with timer.DebugTimer("query") as q:
        session.sql(_MEDIAN)
    totals = timer.span_totals()
    hdk_tpu_torch.enable_debug_timer(False)
    aggs = [c for c in q.node.children
            if c.name.startswith("step:Aggregate#")]
    assert len(aggs) == 1
    assert [c.name for c in aggs[0].children] == ["agg:gid_array",
                                                 "agg:pair_sort"]
    # on the CPU the quantile takes the permutation of the sorted pairs
    assert aggs[0].counts == {"gid_array": 1, "pair_lexsort": 1}
    assert (_counted(totals, "gid_array"), _counted(totals, "gid_keys")) \
        == (1, 0)
    assert totals["step:Aggregate"]["gid_array"] == 1
    assert totals["agg:gid_array"]["spans"] == 1
    assert totals["agg:pair_sort"]["spans"] == 1
    # the report and the harness's gap labels see them
    step = next(c for c in hdk_tpu_torch.timer_report()["children"]
                if c["name"].startswith("step:Aggregate#"))
    assert step["gid_array"] == 1


def test_an_all_sum_group_by_counts_keys_and_no_array(session):
    hdk_tpu_torch.enable_debug_timer(True)
    with timer.DebugTimer("query"):
        session.sql(_SQL["group_by"])
    totals = timer.span_totals()
    hdk_tpu_torch.enable_debug_timer(False)
    assert (_counted(totals, "gid_array"), _counted(totals, "gid_keys")) \
        == (0, 1)
    assert not [n for n in totals if n.startswith("agg:")]


def test_timer_off_records_no_group_by_span_or_count(session):
    hdk_tpu_torch.enable_debug_timer(True)
    hdk_tpu_torch.enable_debug_timer(False)
    before = hdk_tpu_torch.timer_report()
    session.sql(_MEDIAN)
    timer.count("gid_array")
    assert timer.span_totals() == {}
    assert hdk_tpu_torch.timer_report() == before


def test_count_takes_only_known_counters():
    with pytest.raises(ValueError, match="gid_arrays"):
        timer.count("gid_arrays")
    assert timer.COUNTERS == ("gid_array", "gid_keys", "pair_segsort",
                              "pair_lexsort")
