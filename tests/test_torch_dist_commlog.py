"""The port's collective accounting (hdk_tpu_torch/utils/commlog.py)
against the JAX package's (the twin of tests/test_commlog.py, but for
its HLO cross-check, which has no counterpart: the port compiles no
program).  For the same query on 4 shards, the operators' collectives,
their order and their bytes per shard equal the JAX package's capture;
the port's own gathers (a step reading the gathered view) are marked
and counted apart."""

import numpy as np
import pytest

import jax

import hdk_tpu
import hdk_tpu_torch
from hdk_tpu.utils import commlog as jc
from hdk_tpu_torch.utils import commlog as tc

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

DIST = {"dist.enable": True, "dist.num_devices": 4}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(0)
    n = 40_000
    data = {"k": rng.integers(0, n, n), "v": rng.integers(0, 50, n),
            "p": rng.integers(0, 64, n), "f": rng.normal(size=n)}
    dim = {"k": np.arange(0, 2000), "w": np.arange(2000) * 3}
    jx = hdk_tpu.HDK(**DIST)
    pt = hdk_tpu_torch.HDK(device="cpu", **DIST)
    for s in (jx, pt):
        s.import_pydict(data, name="cl_t")
        s.import_pydict(dim, name="cl_d")
    return jx, pt


def _captures(sessions, q):
    jx, pt = sessions
    with jc.capture() as rj:
        jx.sql(q).to_arrow()
    with tc.capture() as rt:
        pt.sql(q).to_arrow()
    return rj, rt


def _ops(records):
    return [(r["op"], r["bytes_per_device"]) for r in records
            if not r.get("gather")]


@pytest.mark.parametrize("q,route", [
    ("SELECT k, MEDIAN(v) AS m FROM cl_t GROUP BY k", "shuffled"),
    ("SELECT p, COUNT(*) AS c, SUM(v) AS sv, MIN(v) AS mn FROM cl_t "
     "GROUP BY p", "dense_psum"),
    ("SELECT p, COUNT(DISTINCT v) AS c FROM cl_t GROUP BY p", "shuffled"),
    ("SELECT p, APPROX_QUANTILE(f, 0.5) AS q FROM cl_t GROUP BY p",
     "dense_psum"),
    ("SELECT k, v, f FROM cl_t ORDER BY f", None),
    ("SELECT cl_t.p, COUNT(*) AS c FROM cl_t JOIN cl_d ON cl_t.k = cl_d.k "
     "GROUP BY cl_t.p", "dense_psum"),
    ("SELECT k, ROW_NUMBER() OVER (PARTITION BY p ORDER BY k) AS rn "
     "FROM cl_t", None),
])
def test_collectives_match_the_reference(sessions, q, route):
    rj, rt = _captures(sessions, q)
    assert _ops(rt) == _ops(rj)
    assert len(rt) >= 1
    assert all(r["shards"] == 4 for r in rt)
    if route is not None:
        assert sessions[1]._executor._dist_agg_route == route
    sj = jc.summarize(rj, 4)
    st = tc.summarize([r for r in rt if not r.get("gather")], 4)
    assert sj == st


def test_capture_records_dist_shuffle(sessions):
    """A holistic aggregate over high-NDV keys: the raw shuffle's
    all_to_all bytes and a wire estimate."""
    _, rt = _captures(sessions, "SELECT k, MEDIAN(v) AS m FROM cl_t "
                      "GROUP BY k")
    s = tc.summarize(rt, 4)
    assert s["n_collectives"] >= 1
    assert s["bytes_per_device_by_op"].get("all_to_all", 0) > 0
    assert s["wire_bytes_per_device"] > 0


def test_dense_perfect_route_records_psum(sessions):
    _, pt = sessions
    with tc.capture() as rec:
        df = pt.sql("SELECT p, COUNT(*) AS c FROM cl_t GROUP BY p"
                    ).to_arrow().to_pandas()
    assert pt._executor._dist_agg_route == "dense_psum"
    assert tc.summarize(rec, 4)["bytes_per_device_by_op"]["psum"] > 0
    assert df["c"].sum() == 40_000 and len(df) == 64


def test_capture_empty_without_dist():
    pt = hdk_tpu_torch.HDK(device="cpu")
    pt.import_pydict({"k": np.arange(100) % 5}, name="cl_l")
    with tc.capture() as rec:
        pt.sql("SELECT k, COUNT(*) FROM cl_l GROUP BY k").to_arrow()
    assert rec == []


def test_fall_back_shows_as_a_gather_and_copies_nothing(sessions):
    """A scalar aggregate has no distributed route: it reads the scan's
    gathered view, which the capture shows, and which on one device is
    the scan's own tensor."""
    _, pt = sessions
    with tc.capture() as rec:
        pt.sql("SELECT SUM(v) AS s FROM cl_t").to_arrow()
    assert rec and all(r.get("gather") and r["op"] == "all_gather"
                       for r in rec)
    assert rec[0]["bytes_per_device"] == 10_000 * 8
    from hdk_tpu_torch.exec.dist_exec import _ShardedScanColumns

    from hdk_tpu_torch.ir import node as nd

    scan = pt._executor._exec_scan(nd.Scan(pt._schema.get("cl_t")))
    assert isinstance(scan.columns, _ShardedScanColumns)
    assert scan.columns[1].data is scan.columns.peek(1).data


def test_summarize_wire_model():
    recs = [{"op": "all_to_all", "axis": "frag", "bytes_per_device": 800},
            {"op": "psum", "axis": "frag", "bytes_per_device": 100},
            {"op": "all_gather", "axis": "frag", "bytes_per_device": 10}]
    s = tc.summarize(recs, 4)
    assert s == jc.summarize(recs, 4)
    assert s["n_collectives"] == 3
    assert s["wire_bytes_per_device"] == 600 + 150 + 30


@pytest.mark.parametrize("compute_s,nbytes", [(1.0, 1 << 20),
                                              (0.01, 10 << 30)])
def test_link_model_matches_the_reference_model(compute_s, nbytes):
    from hdk_tpu.parallel.ici_model import IciModel

    from hdk_tpu_torch.parallel.link_model import LinkModel

    recs = [{"op": "all_to_all", "axis": "frag", "bytes_per_device": nbytes}]
    a = IciModel(ici_bytes_per_sec=200e9, alpha_per_collective=5e-6)
    b = LinkModel(link_bytes_per_sec=200e9, alpha_per_collective=5e-6)
    pa, pb = a.predict(compute_s, recs, 8), b.predict(compute_s, recs, 8)
    assert pa == pb
    if compute_s == 1.0:
        assert pb["predicted_efficiency"] > 0.99
    else:
        assert pb["predicted_efficiency"] < 0.1
        assert pb["t_wire_s"] > pb["t_compute_s"]
