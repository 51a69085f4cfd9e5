"""Fragment-streamed aggregation and the watchdog's deadline, the port
against the JAX package: the cases of tests/test_fragstream.py through
``hdk_tpu.HDK()`` and ``hdk_tpu_torch.HDK(device="cpu")`` on the same
numpy data, with tiny fragments and a tiny scan budget so a scan streams
in many chunks.  Results compare with ``torch_twin.assert_same`` (ints
exactly, floats to rtol 1e-9) and the chunk counts must be equal."""

import numpy as np
import pyarrow as pa
import pytest

import hdk_tpu
import hdk_tpu_torch
from torch_twin import assert_same, assert_same_storage, twin_sessions

STREAM = {"storage.fragment_size": 1000, "exec.scan_stream_bytes": 32_000}


def _data():
    rng = np.random.default_rng(11)
    n = 20_000
    return {
        "g": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.normal(size=n),
        "i": rng.integers(-50, 50, n).astype(np.int32),
    }


@pytest.fixture(scope="module")
def streamed():
    return twin_sessions({"fs_t": _data()}, **STREAM)


def _chunks(sess):
    return sess._executor._frag_stream_chunks


def _twin(sessions, make, **run):
    jx, pt = sessions
    a = make(jx.scan("fs_t")).run(**run)
    b = make(pt.scan("fs_t")).run(**run)
    return a, b


QUERIES = {
    "grouped": lambda t: t.agg("g", "count", "sum(v)", "min(i)", "max(i)",
                               "avg(v)"),
    "filtered_grouped": lambda t: t.filter(t["i"] > 0).agg(
        "g", "count", "sum(i)"),
    "nogroup": lambda t: t.agg([], "count", "sum(v)", "min(i)"),
    "stddev": lambda t: t.agg("g", "count", "sum(i)", "stddev(v)"),
    "var_sample_hll": lambda t: t.agg("g", "var(v)", "sample(i)",
                                      "approx_count_distinct(i)"),
}


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_streams_like_the_reference(streamed, q):
    """Each query streams in the same chunks in both packages and gives
    the same answer."""
    a, b = _twin(streamed, QUERIES[q])
    assert_same(a, b, ordered=False)
    jx, pt = streamed
    assert _chunks(pt) == _chunks(jx) and _chunks(pt) > 1


def test_stream_matches_unstreamed(streamed):
    """The streamed answer equals the port's whole-column answer and the
    JAX package's."""
    data = _data()
    whole = hdk_tpu_torch.HDK(device="cpu")
    whole.import_pydict(data, name="fs_t")
    make = QUERIES["stddev"]
    ref = make(whole.scan("fs_t")).run()
    assert whole._executor._frag_stream_chunks is None
    jx_res, pt_res = _twin(streamed, make)
    assert_same(ref, pt_res, ordered=False)
    assert_same(jx_res, pt_res, ordered=False)


def test_chunks_stay_out_of_the_device_cache(streamed):
    """A streamed scan leaves no device copy of its columns behind."""
    _jx, pt = streamed
    QUERIES["grouped"](pt.scan("fs_t")).run()
    assert _chunks(pt) > 1
    table = pt._schema.get("fs_t")
    assert all(not c._device for c in table.columns)


def test_holistic_aggs_bypass_stream(streamed):
    a, b = _twin(streamed, lambda t: t.agg("g", "count_distinct(i)"))
    assert_same(a, b, ordered=False)
    assert _chunks(streamed[1]) is None


def test_window_in_chain_bypasses_stream(streamed):
    """A window function sees every row: the chunked route refuses it."""
    jx, pt = streamed
    out = []
    for sess in (jx, pt):
        t = sess.scan("fs_t")
        q = t.proj(g=t["g"], rn=sess.row_number().over().order_by(
            t["v"], t["rowid"]))
        out.append(q.agg("g", "max(rn)").run())
    assert_same(*out, ordered=False)
    assert _chunks(pt) is None
    assert out[1].to_numpy()["rn_max"].max() == 20_000


def test_sorted_aggregate_streams(streamed):
    """GROUP BY ... ORDER BY streams too: the aggregate runs apart from
    the sort (the JAX package runs the pair as one step over the whole
    columns), and the answer is the same."""
    jx, pt = streamed
    sql = ("SELECT g, COUNT(*) AS c, SUM(v) AS s, MAX(i) AS m FROM fs_t "
           "GROUP BY g ORDER BY g")
    assert_same(jx.sql(sql), pt.sql(sql))
    assert _chunks(pt) > 1


def _one_chunk_groups():
    """Group 7 only in the first 500 rows (one chunk), group 8 only in
    the last 500; NULLs in v and i, and all of group 8's i NULL."""
    d = _data()
    n = d["g"].size
    g = d["g"].copy()
    g[:500] = 7
    g[-500:] = 8
    rng = np.random.default_rng(5)
    v_null = rng.random(n) < 0.2
    i_null = rng.random(n) < 0.2
    i_null[-500:] = True
    return pa.table({
        "g": pa.array(g),
        "v": pa.array(d["v"], mask=v_null),
        "i": pa.array(d["i"], mask=i_null),
    })


def test_group_in_one_chunk_with_nulls():
    """MIN/MAX/SAMPLE merge across chunks where a group is absent: its
    empty slots hold the identity, so the merge keeps the other chunk's
    value, and an all-NULL group stays NULL."""
    at = _one_chunk_groups()
    jx = hdk_tpu.HDK(**STREAM)
    pt = hdk_tpu_torch.HDK(device="cpu", **STREAM)
    jx.import_arrow(at, name="oc")
    pt.import_arrow(at, name="oc")
    assert_same_storage(jx, pt)
    out = []
    for sess in (jx, pt):
        t = sess.scan("oc")
        out.append(t.agg("g", "count", "count(i)", "min(i)", "max(v)",
                         "sample(i)", "min(v)", "sum(i)").run())
    assert_same(*out, ordered=False)
    assert _chunks(pt) == _chunks(jx) and _chunks(pt) > 1
    got = out[1].to_numpy()
    g = got["g"]
    assert set(g.tolist()) >= {7, 8}
    eight = int(np.flatnonzero(g == 8)[0])
    assert np.ma.is_masked(got["i_min"][eight])
    assert np.ma.is_masked(got["i_sample"][eight])


# -- the watchdog: a time limit streams at fragment granularity, so the
# deadline is checked between chunks, mid-step -------------------------------

def test_dynamic_watchdog_forces_chunking():
    data = _data()
    jx, pt = twin_sessions({"fs_t": data}, **{"storage.fragment_size": 1000})
    make = lambda t: t.agg("g", "count", "sum(v)")
    a, b = _twin((jx, pt), make)
    assert_same(a, b, ordered=False)
    assert not _chunks(pt) and not _chunks(jx)
    a, b = _twin((jx, pt), make, enable_watchdog=True,
                 watchdog_time_limit_ms=60_000)
    assert_same(a, b, ordered=False)
    assert _chunks(pt) == _chunks(jx) == 20


def test_dynamic_watchdog_interrupts_mid_step():
    from hdk_tpu_torch.exec.scalar import ExecError

    pt = hdk_tpu_torch.HDK(device="cpu", **{"storage.fragment_size": 1000})
    ht = pt.import_pydict(_data(), name="wd_t2")
    with pytest.raises(ExecError, match="watchdog"):
        ht.agg("g", "count", "sum(v)").run(
            enable_watchdog=True, watchdog_time_limit_ms=1).to_numpy()


def test_deadline_checked_between_chunks(monkeypatch):
    """The stream itself raises once the deadline has passed: the check
    runs after every chunk."""
    from hdk_tpu_torch.exec import agg_exec
    from hdk_tpu_torch.exec.scalar import ExecError

    pt = hdk_tpu_torch.HDK(device="cpu", **{"storage.fragment_size": 1000})
    ht = pt.import_pydict(_data(), name="wd_t3")
    seen = []
    clock = agg_exec._time.monotonic

    class Clock:
        # the executor's own checks see the true time; from the second
        # chunk on, the stream sees a time past any deadline
        @staticmethod
        def monotonic():
            return clock() + (1e9 if len(seen) > 1 else 0)

        perf_counter = staticmethod(agg_exec._time.perf_counter)

    real = agg_exec.AggExecMixin._check_watchdog_budget

    def count(self):
        seen.append(1)
        real(self)

    monkeypatch.setattr(agg_exec, "_time", Clock)
    monkeypatch.setattr(agg_exec.AggExecMixin, "_check_watchdog_budget",
                        count)
    with pytest.raises(ExecError, match="watchdog"):
        ht.agg("g", "count").run(enable_watchdog=True,
                                 watchdog_time_limit_ms=60_000)
    assert len(seen) == 2
