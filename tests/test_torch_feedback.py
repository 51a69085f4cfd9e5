"""Measured feedback, the port against the JAX package: the aggregate
cases of tests/test_feedback.py (a dense GROUP BY in the tuning window
explores the perfect and the sort route, then keeps the faster; every
run gives the same exact answer) and the eager-aggregation plan A/B of
tests/test_eager_agg.py (its state machine, and a rewrite that measures
slower turning itself off), through ``hdk_tpu_torch.HDK(device="cpu")``
beside ``hdk_tpu.HDK()`` on the same numpy data."""

import numpy as np
import pytest

import hdk_tpu
import hdk_tpu_torch
from hdk_tpu.exec.explain import explain_dag as jx_explain_dag
from hdk_tpu_torch.exec import feedback as fb
from hdk_tpu_torch.exec.explain import explain_dag as pt_explain_dag
from torch_twin import assert_same, twin_sessions


def test_choose_explores_then_exploits():
    f = fb.RouteFeedback()
    assert f.choose("sig", ["a", "b"]) == ("a", True)
    f.record("sig", "a", 0.5)
    assert f.choose("sig", ["a", "b"]) == ("b", True)
    f.record("sig", "b", 0.1)
    assert f.choose("sig", ["a", "b"]) == ("b", False)
    for _ in range(20):  # the EWMA moves the winner back
        f.record("sig", "b", 2.0)
    assert f.choose("sig", ["a", "b"])[0] == "a"
    assert set(f.measured("sig")) == {"a", "b"}


def test_disabled_feedback_records_nothing():
    f = fb.RouteFeedback(enabled=False)
    assert f.choose("sig", ["a", "b"]) == ("a", False)
    f.record("sig", "a", 1.0)
    assert f._t == {}


def test_timed_runs_twice_and_times_the_second():
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    out, secs = fb.timed_sync(fn, 4, device=hdk_tpu_torch.HDK(
        device="cpu").device)
    assert out == 5 and calls == [4, 4] and secs >= 0
    out, secs = fb.timed_wall(lambda: calls.append(0) or len(calls))
    assert out == 4 and calls == [4, 4, 0, 0] and secs >= 0


def _fb_data():
    rng = np.random.default_rng(13)
    n = 1 << 17
    return {"k": rng.integers(0, 1000, n),   # ~1000 entries: in (512, 4096]
            "v": rng.integers(0, 50, n)}


def test_groupby_routes_explored_and_settled():
    """The first two runs explore "perfect" then "sort", each timed; the
    third takes the faster; every run equals the JAX package's answer."""
    data = _fb_data()
    jx, pt = twin_sessions({"fb_t": data})
    ref = jx.scan("fb_t").agg("k", "count", "sum(v)").run()
    f = pt._executor._feedback
    routes = []
    for _ in range(3):
        res = pt.scan("fb_t").agg("k", "count", "sum(v)").run()
        assert_same(ref, res, ordered=False)
        routes.append(pt._executor._groupby_cap)
    sigs = {g for (g, _r) in f._t}
    assert len(sigs) == 1
    measured = f.measured(next(iter(sigs)))
    assert set(measured) == {"perfect", "sort"}
    assert all(s > 0 for s in measured.values())
    # the sort run sized its buffer to the layout's entries
    assert routes[1] == 1000


def test_groupby_feedback_signature_is_the_reference_one():
    """Both packages key the tuning by the same plan signature."""
    data = _fb_data()
    jx, pt = twin_sessions({"fb_s": data})
    for sess in (jx, pt):
        sess.scan("fb_s").agg("k", "count").run()
    assert ({g for g, _ in pt._executor._feedback._t}
            == {g for g, _ in jx._executor._feedback._t})


@pytest.mark.parametrize("where", ["below_window", "few_rows",
                                   "sorted_aggregate"])
def test_outside_the_gate_nothing_is_explored(where):
    """Fewer than 513 entries, fewer than 2^16 rows, or an aggregate run
    with its ORDER BY as one step: one route, no timing."""
    rng = np.random.default_rng(17)
    n = 1000 if where == "few_rows" else 1 << 17
    hi = 400 if where == "below_window" else 1000
    pt = hdk_tpu_torch.HDK(device="cpu")
    pt.import_pydict({"k": rng.integers(0, hi, n)}, name="g_t")
    sql = "SELECT k, COUNT(*) AS c FROM g_t GROUP BY k" + (
        " ORDER BY k" if where == "sorted_aggregate" else "")
    for _ in range(2):
        pt.sql(sql)
    assert pt._executor._feedback._t == {}


def test_feedback_disabled():
    rng = np.random.default_rng(19)
    pt = hdk_tpu_torch.HDK(device="cpu",
                           **{"exec.enable_route_feedback": False})
    t = pt.import_pydict({"k": rng.integers(0, 1000, 1 << 17)},
                         name="fb_off")
    for _ in range(2):
        t.agg("k", "count").run()
    assert pt._executor._feedback._t == {}


# -- the eager-aggregation plan A/B ------------------------------------------

def test_plan_choice_feedback_state_machine():
    f = fb.PlanChoiceFeedback(fb.RouteFeedback(enabled=True))
    sig = "plan-x"
    # rewrite cold -> rewrite timed -> original cold -> original timed
    # -> the winner
    assert f.choose(sig, ["rewrite", "original"]) == ("rewrite", "cold")
    assert f.choose(sig, ["rewrite", "original"]) == ("rewrite", "timed")
    f.record(sig, "rewrite", 2.0)
    assert f.choose(sig, ["rewrite", "original"]) == ("original", "cold")
    assert f.choose(sig, ["rewrite", "original"]) == ("original", "timed")
    f.record(sig, "original", 0.5)
    assert f.choose(sig, ["rewrite", "original"]) == ("original", None)
    sig2 = "plan-y"
    for _ in range(2):
        f.choose(sig2, ["rewrite", "original"])
    f.record(sig2, "rewrite", 0.1)
    for _ in range(2):
        f.choose(sig2, ["rewrite", "original"])
    f.record(sig2, "original", 0.9)
    assert f.choose(sig2, ["rewrite", "original"]) == ("rewrite", None)
    assert set(f.measured(sig2)) == {"rewrite", "original"}


def _eager_tables():
    rng = np.random.default_rng(71)
    n_l, n_r = 4000, 64
    return {
        "pf_l": {"fk": rng.integers(0, n_r, n_l), "val": rng.normal(size=n_l),
                 "qty": rng.integers(1, 10, n_l)},
        "pf_r": {"pk": rng.permutation(n_r),
                 "cat": rng.integers(0, 4, n_r).astype(np.int8),
                 "w": rng.normal(size=n_r)},
    }


EAGER_SQL = ("SELECT cat, SUM(val) AS s, COUNT(*) AS c FROM pf_l JOIN pf_r "
             "ON pf_l.fk = pf_r.pk GROUP BY cat")


def _eager_twins():
    jx, pt = twin_sessions(_eager_tables())
    for sess in (jx, pt):  # fire on tiny tables
        sess.config.exec.eager_agg_min_rows = 64
        sess.config.exec.eager_agg_min_ratio = 1.0
    return jx, pt


def _spy(sess):
    """The plan text of every query the session's executor runs."""
    explain_dag = (jx_explain_dag if isinstance(sess, hdk_tpu.HDK)
                   else pt_explain_dag)
    plans = []
    ex = sess._executor
    real = type(ex).execute

    def spy(dag):
        plans.append(explain_dag(dag.root))
        return real(ex, dag)

    ex.execute = spy
    return plans


def test_rewrite_self_disables_when_measured_slower():
    jx, pt = _eager_twins()
    jx_plans, pt_plans = _spy(jx), _spy(pt)
    ex = pt._executor
    for _ in range(4):  # rewrite cold/timed, original cold/timed
        assert_same(jx.sql(EAGER_SQL), pt.sql(EAGER_SQL), ordered=False)
    assert pt_plans == jx_plans
    assert pt_plans[0] == pt_plans[1] != pt_plans[2] == pt_plans[3]
    assert "Aggregate" in pt_plans[0].split("Join")[1]
    sig = next(s for s, v in ex._plan_feedback._fb._t if v == "rewrite")
    assert set(ex._plan_feedback.measured(sig)) == {"rewrite", "original"}
    # the rewrite measured slower: the original plan runs from now on
    ex._plan_feedback._fb._t[(sig, "rewrite")] = 9.9
    ex._plan_feedback._fb._t[(sig, "original")] = 0.1
    assert_same(jx.sql(EAGER_SQL), pt.sql(EAGER_SQL), ordered=False)
    assert pt_plans[-1] == pt_plans[2]
    # and the other way round
    ex._plan_feedback._fb._t[(sig, "rewrite")] = 0.1
    ex._plan_feedback._fb._t[(sig, "original")] = 9.9
    pt.sql(EAGER_SQL)
    assert pt_plans[-1] == pt_plans[0]


def test_plan_choice_off_without_route_feedback():
    jx, pt = _eager_twins()
    pt.config.exec.enable_route_feedback = False
    plans = _spy(pt)
    for _ in range(3):
        pt.sql(EAGER_SQL)
    assert len(set(plans)) == 1 and pt._executor._plan_feedback._cold == set()
    assert_same(jx.sql(EAGER_SQL), pt.sql(EAGER_SQL), ordered=False)


def test_no_join_no_plan_choice():
    pt = hdk_tpu_torch.HDK(device="cpu")
    pt.import_pydict(_eager_tables()["pf_l"], name="pf_l")
    for _ in range(2):
        pt.sql("SELECT fk, SUM(val) AS s FROM pf_l GROUP BY fk")
    assert pt._executor._plan_feedback._cold == set()
    assert hdk_tpu.HDK()._executor._plan_feedback._cold == set()
