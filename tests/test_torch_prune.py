"""Fragment skipping, the port against the JAX package: the cases of
tests/test_prune.py through ``hdk_tpu.HDK()`` and
``hdk_tpu_torch.HDK(device="cpu")`` on the same numpy data, with 100-row
fragments.  Results must be equal (``torch_twin.assert_same``) and so
must the fragments selected (``_frag_prune_stats``).  The JAX package
pads the survivors to a shared bucket size; the port takes them as they
are, so in place of its bucket-shape test the port's pruned and unpruned
answers are held equal."""

import numpy as np
import pyarrow as pa
import pytest

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same, twin_sessions

FRAGS = {"storage.fragment_size": 100}


def _frame():
    rng = np.random.default_rng(3)
    n = 1200
    return {
        "d": np.arange(n) // 10,          # ordered: prunes well
        "v": rng.normal(size=n),
        "k": rng.integers(0, 5, n),
        "u": rng.integers(0, 10**6, n),   # unordered: every fragment overlaps
    }


@pytest.fixture(scope="module")
def sessions():
    return twin_sessions({"t": _frame()}, **FRAGS)


def _stats(sess):
    return sess._executor._frag_prune_stats


CASES = {
    # name: (query, selected fragments of 12 or None: no pruning)
    "range_filter": (lambda s, t: t.filter((t["d"] >= 40) & (t["d"] < 50))
                     .agg("k", "count", "sum(v)"), 1),
    "eq_filter_projection": (lambda s, t: t.filter(t["d"] == 77)
                             .proj("d", "v"), 1),
    "unprunable_column": (lambda s, t: t.filter(t["u"] < 500000)
                          .agg("k", "count"), None),
    "empty_selection": (lambda s, t: t.filter(t["d"] > 10**6)
                        .agg("k", "count"), 0),
    "in_list": (lambda s, t: s.sql("SELECT k, COUNT(*) AS c FROM t "
                                   "WHERE d IN (13, 14) GROUP BY k"), 1),
    "two_ranges": (lambda s, t: t.filter((t["d"] < 15) | (t["d"] >= 110))
                   .agg("k", "count", "sum(v)"), None),
    "range_then_sort": (lambda s, t: t.filter((t["d"] >= 33) & (t["d"] < 61))
                        .sort(("v", "desc")).proj("d", "v"), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prunes_like_the_reference(sessions, case):
    make, selected = CASES[case]
    jx, pt = sessions
    jx._executor._frag_prune_stats = None
    a, b = _twin(sessions, make)
    assert_same(a, b, ordered="sort" in case)
    assert _stats(pt) == _stats(jx)
    if selected is None:
        assert _stats(pt) is None
    else:
        assert _stats(pt) == {"selected": selected, "total": 12}


def _twin(sessions, make):
    """The query through both sessions (SQL runs at once, a builder query
    on ``run``)."""
    jx, pt = sessions
    out = []
    for s in (jx, pt):
        q = make(s, s.scan("t"))
        out.append(q if hasattr(q, "to_arrow") else q.run())
    return out


def test_isnull_pruning():
    rng = np.random.default_rng(4)
    n = 600
    a = np.ma.masked_array(rng.normal(size=n), mask=np.arange(n) < 50)
    at = pa.table({"a": pa.array(a.data, mask=a.mask),
                   "g": pa.array(rng.integers(0, 3, n))})
    jx = hdk_tpu.HDK(**FRAGS)
    pt = hdk_tpu_torch.HDK(device="cpu", **FRAGS)
    out = []
    for s in (jx, pt):
        t = s.import_arrow(at, name="t5")
        out.append(t.filter(t["a"].is_null()).agg("g", "count").run())
    assert_same(*out, ordered=False)
    assert _stats(pt) == _stats(jx) == {"selected": 1, "total": 6}


def test_sql_between_dates():
    rng = np.random.default_rng(6)
    n = 1000
    dt = (np.datetime64("2015-01-01", "ns")
          + (np.arange(n) // 2).astype("timedelta64[D]"))
    jx, pt = twin_sessions({"t7": {"dt": dt, "x": rng.normal(size=n)}},
                           **FRAGS)
    sql = ("SELECT COUNT(*) AS c, SUM(x) AS s FROM t7 "
           "WHERE dt >= DATE '2015-09-01' AND dt < DATE '2015-10-01'")
    assert_same(jx.sql(sql), pt.sql(sql))
    assert _stats(pt) == _stats(jx)
    assert _stats(pt)["selected"] < _stats(pt)["total"]


def test_prune_disabled_flag():
    off = {**FRAGS, "exec.enable_fragment_skipping": False}
    jx, pt = twin_sessions({"t8": _frame()}, **off)
    out = []
    for s in (jx, pt):
        t = s.scan("t8")
        out.append(t.filter(t["d"] == 5).agg("k", "count").run())
    assert_same(*out, ordered=False)
    assert _stats(pt) is None and _stats(jx) is None


@pytest.mark.parametrize("case", ["range_filter", "range_then_sort",
                                  "eq_filter_projection"])
def test_pruned_equals_unpruned(case):
    """The port's answer over the surviving fragments equals its answer
    over the whole table (fragment skipping off)."""
    make, _selected = CASES[case]
    out = []
    for skip in (True, False):
        pt = hdk_tpu_torch.HDK(device="cpu", **{
            **FRAGS, "exec.enable_fragment_skipping": skip})
        pt.import_pydict(_frame(), name="t")
        out.append(make(pt, pt.scan("t")).run())
        assert (_stats(pt) is not None) == skip
    assert_same(*out, ordered="sort" in case)


def test_resident_column_is_sliced_on_the_device():
    """With the whole column already on the device, a pruned scan slices
    it there (one contiguous range: a view) and copies nothing from the
    host; without it, only the survivors are copied, once."""
    pt = hdk_tpu_torch.HDK(device="cpu", **FRAGS)
    t = pt.import_pydict(_frame(), name="t")
    col = pt._schema.get("t").column("d")
    make = lambda: t.filter((t["d"] >= 33) & (t["d"] < 61)).agg(
        "k", "count").run().to_numpy()
    first = make()
    assert [k for k in col._device] == ["cpu|((300, 700),)"]
    assert make()["count"].tolist() == first["count"].tolist()
    assert len(col._device) == 1  # the warm run found its copy
    whole, _ = col.device_arrays(pt.device)
    data, _mask = col.device_rows(pt.device, ((300, 700),))
    assert data._base is whole
    assert make()["count"].tolist() == first["count"].tolist()
