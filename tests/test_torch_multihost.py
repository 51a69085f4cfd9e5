"""Multi-host sessions of hdk_tpu_torch: two processes of two CPU shards
each, joined by ``torch.distributed`` over gloo into one 4-shard mesh
(the twin of tests/test_multihost.py and tests/multihost_worker.py).

This file is its own worker:

    python tests/test_torch_multihost.py RANK ADDRESS [DEVICE]

runs one rank of the job (ADDRESS ``host:port`` of rank 0's store) and
prints one JSON line of results.  tests/test_ref_shapes.py's queries are
read from that file's source: importing the suite imports jax, which
neither a worker nor the card's machine has.  The module fixture starts both ranks
as fresh interpreters, with a time limit on each and on every
collective, and kills them on exit.  The tests then hold the ranks'
results to a numpy oracle, to a one-process 4-shard session of the port
(collectives bit for bit; routes, retries and the ``commlog`` records
of every query at an even split) and to hdk_tpu's dist session on
conftest's CPU devices (results; integers exactly, floats to 1e-9).
"""

import ast
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WORLD = 2
SHARDS = 4
N_E2E = 1000
PARITY_ROWS = 40_000
SHAPES_ROWS = 3000
SHAPES_SPLIT = 1300  # rank 0's rows of ``rt``; rank 1 holds the rest
# the sessions' config beside the mesh: a small broadcast threshold puts
# the 20k-row build on the partitioned route, and a low NDV sample
# threshold makes the strided sample size the wide-key group caps
CONFIG = {"dist.enable": True, "dist.num_devices": SHARDS,
          "dist.broadcast_join_threshold": 1000,
          "exec.group_by.ndv_sample_min_rows": 1000}
ROUTES = ("_dist_agg_route", "_dist_window_route", "_dist_join_route",
          "_dist_sort_route", "_dist_retries")
# (label, SQL, executor attribute, the route it must read)
PARITY = [
    ("dense_psum", "SELECT p, COUNT(*) AS c, SUM(v) AS sv, MIN(v) AS mn, "
     "AVG(f) AS af FROM pt GROUP BY p", "_dist_agg_route", "dense_psum"),
    ("fused_sort", "SELECT p, COUNT(*) AS c FROM pt GROUP BY p "
     "ORDER BY c DESC, p", "_dist_agg_route", "dense_psum_fused_sort"),
    ("two_phase", "SELECT k, COUNT(*) AS c, SUM(v) AS sv FROM pt "
     "GROUP BY k", "_dist_agg_route", "two_phase"),
    ("shuffled", "SELECT k, MEDIAN(v) AS m FROM pt GROUP BY k",
     "_dist_agg_route", "shuffled"),
    ("distinct_split", "SELECT h, COUNT(DISTINCT v) AS dv, COUNT(*) AS c "
     "FROM pt GROUP BY h", "_dist_agg_route", "distinct_split"),
    ("range_sort", "SELECT k, v, f FROM pt ORDER BY f, k",
     "_dist_sort_route", "range"),
    ("partitioned", "SELECT COUNT(*) AS c, SUM(d.w) AS sw FROM pt "
     "JOIN pdim d ON pt.j = d.j", "_dist_join_route", "partitioned"),
    ("broadcast", "SELECT COUNT(*) AS c, SUM(v) AS sv FROM pt WHERE p IN "
     "(SELECT p FROM psmall WHERE w > 10)", "_dist_join_route",
     "broadcast"),
    ("dist_window", "SELECT k, ROW_NUMBER() OVER (PARTITION BY p ORDER BY "
     "k) AS rn FROM pt", "_dist_window_route", "dist_window"),
    ("string_key", "SELECT s, COUNT(*) AS c, SUM(v) AS sv FROM pt "
     "GROUP BY s", "_dist_agg_route", "dense_psum"),
]
E2E = {
    "groupby": "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM mt GROUP BY k "
               "ORDER BY k",
    "join": "SELECT d.w AS w, COUNT(*) AS c FROM mt JOIN mdim d "
            "ON mt.k = d.k GROUP BY d.w ORDER BY w",
    "dict_groupby": "SELECT city, COUNT(*) AS c, SUM(amt) AS s FROM mstr "
                    "GROUP BY city ORDER BY city",
    "dict_join": "SELECT d.tz AS tz, COUNT(*) AS c FROM mstr "
                 "JOIN mcity d ON mstr.city = d.city GROUP BY d.tz "
                 "ORDER BY tz",
    "dict_filter": "SELECT COUNT(*) AS c FROM mstr WHERE city = 'sfo'",
}
CITIES = ["nyc", "sfo", "chi", "bos", "lax", "sea"]
TZ = [-5, -8, -6, -5, -8, -8]


def ref_shape_queries() -> list:
    """``QUERIES`` of tests/test_ref_shapes.py, evaluated from its
    source."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_ref_shapes.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets]
                == ["QUERIES"]):
            return ast.literal_eval(node.value)
    raise LookupError("no QUERIES in test_ref_shapes.py")


QUERIES = ref_shape_queries()


# -- data, made from seeds on every process ---------------------------------

def e2e_data():
    """The reference worker's tables: 1000 rows split 400/600."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 7, N_E2E)
    v = rng.integers(-50, 50, N_E2E)
    city = np.asarray(CITIES)[rng.integers(0, 6, N_E2E)]
    amt = rng.integers(1, 100, N_E2E)
    return {"mt": {"k": k, "v": v}, "mstr": {"city": city, "amt": amt}}


def e2e_slice(rank: int) -> slice:
    return slice(0, 400) if rank == 0 else slice(400, N_E2E)


def parity_data():
    rng = np.random.default_rng(17)
    n = PARITY_ROWS
    hot = rng.random(n) < 0.6
    pt = {"k": rng.integers(0, 1 << 40, n), "p": rng.integers(0, 64, n),
          "v": rng.integers(-500, 500, n), "f": rng.normal(size=n),
          "h": np.where(hot, 0, rng.integers(1, 1000, n)),
          "j": rng.integers(0, 20_000, n),
          "s": np.asarray(["alpha", "beta", "gamma", "delta", "eps"])[
              rng.integers(0, 5, n)]}
    pdim = {"j": np.arange(20_000), "w": rng.integers(0, 100, 20_000)}
    psmall = {"p": np.arange(64), "w": rng.integers(0, 20, 64)}
    return pt, pdim, psmall


def shapes_data():
    """``rt`` / ``rt_inner`` of tests/test_ref_shapes.py, from a seed of
    their own (that suite's data depends on the order its tests run)."""
    rng = np.random.default_rng(23)
    n = SHAPES_ROWS
    fn = np.round(rng.normal(-0.5, 1.0, n), 6)
    rt = {
        "x": rng.integers(5, 10, n), "y": rng.integers(40, 45, n),
        "z": rng.integers(100, 105, n), "t": rng.integers(1000, 1010, n),
        "f": np.round(rng.normal(1.2, 0.4, n), 6),
        "d": np.round(rng.normal(2.5, 1.0, n), 6),
        "fn": np.ma.MaskedArray(fn, rng.random(n) < 0.2),
        "w": rng.integers(-50, 50, n),
        "s": np.asarray(["foo", "bar", "baz", "quux"])[
            rng.integers(0, 4, n)],
        "b": rng.integers(0, 2, n),
    }
    inner = {"x": rng.integers(5, 10, 40),
             "s": np.asarray(["foo", "bar", "hidden"])[
                 rng.integers(0, 3, 40)],
             "v": rng.integers(0, 100, 40)}
    return rt, inner


def take(data: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in data.items()}


def collective_data():
    """Per dtype, the 4 shards' operands of each collective."""
    rng = np.random.default_rng(29)
    out = {}
    for name in ("int64", "float64", "float32", "bool"):
        def draw(shape):
            if name == "bool":
                return rng.random(shape) < 0.5
            if name == "int64":
                return rng.integers(-1 << 40, 1 << 40, shape)
            return rng.normal(size=shape).astype(name)
        out[name] = {
            "reduce": [draw((5, 3)) for _ in range(SHARDS)],
            "a2a": [draw((SHARDS, 3, 2)) for _ in range(SHARDS)],
            # shard i holds i + 1 rows: the gather's counts differ
            "gather": [draw((i + 1, 2)) for i in range(SHARDS)],
        }
    return out


# -- results as JSON ------------------------------------------------------------

def payload(res) -> dict:
    """A result (either package) as {column: [values, nulls]}: numbers
    as numbers, NULLs as flags (values 0), anything else as its text."""
    import pyarrow as pa

    table = res.to_arrow()
    out = {}
    for name, col in zip(table.column_names, table.columns):
        nulls = col.is_null().to_numpy(zero_copy_only=False).tolist()
        if pa.types.is_integer(col.type) or pa.types.is_boolean(col.type):
            vals = [int(x) for x in col.fill_null(0).to_pylist()]
        elif pa.types.is_floating(col.type):
            vals = [float(x) for x in col.fill_null(0).to_pylist()]
        else:
            vals = ["" if x is None else str(x) for x in col.to_pylist()]
        out[name] = [vals, nulls]
    return out


def rows_of(p: dict, ordered: bool):
    cols = list(p.values())
    rows = [tuple((None if n else v) for v, n in
                  ((c[0][i], c[1][i]) for c in cols))
            for i in range(len(cols[0][0]) if cols else 0)]
    if ordered:
        return rows
    return sorted(rows, key=lambda r: tuple(
        (0,) if x is None else (1, str(type(x)), x) for x in r))


def same(a: dict, b: dict, what: str, ordered: bool = False,
         rtol: float = 1e-9) -> None:
    """Equal results: the same columns, NULLs and integers exactly,
    floats to ``rtol``."""
    assert list(a) == list(b), (what, list(a), list(b))
    ra, rb = rows_of(a, ordered), rows_of(b, ordered)
    assert len(ra) == len(rb), (what, len(ra), len(rb))
    for x, y in zip(ra, rb):
        for u, v in zip(x, y):
            if isinstance(u, float) or isinstance(v, float):
                assert u is not None and v is not None, (what, x, y)
                assert np.isclose(u, v, rtol=rtol, atol=0.0,
                                  equal_nan=True), (what, x, y)
            else:
                assert u == v, (what, x, y)


def records(rec) -> list:
    return [[r["op"], r["bytes_per_device"], r["shards"],
             bool(r.get("gather"))] for r in rec]


def run_collectives(locals_, first: int):
    """Each collective over this process's shards of every dtype: the
    results of its local shards (global shard ``first + i``) and the
    records."""
    import torch

    from hdk_tpu_torch.utils import commlog

    out = {}
    with commlog.capture() as rec:
        for name, parts in locals_.items():
            red = [torch.from_numpy(np.ascontiguousarray(x))
                   for x in parts["reduce"]]
            got = {}
            if name != "bool":
                for op in ("psum", "pmin", "pmax"):
                    got[op] = [r.tolist() for r in getattr(commlog, op)(red)]
            got["all_gather"] = [r.tolist()
                                 for r in commlog.all_gather(red)]
            got["all_gather_tiled"] = [
                r.tolist() for r in commlog.all_gather(red, axis=1,
                                                       tiled=True)]
            got["all_to_all"] = [r.tolist() for r in commlog.all_to_all(
                [torch.from_numpy(np.ascontiguousarray(x))
                 for x in parts["a2a"]])]
            got["gather"] = commlog.gather(
                [torch.from_numpy(np.ascontiguousarray(x))
                 for x in parts["gather"]], torch.device("cpu")).tolist()
            out[name] = got
    return {"results": out, "records": records(rec), "first": first}


def local_collective_data(first: int, n: int):
    return {name: {k: v[first:first + n] for k, v in parts.items()}
            for name, parts in collective_data().items()}


# -- the worker ----------------------------------------------------------------

def worker(rank: int, address: str, device: str = "cpu") -> dict:
    import torch

    import hdk_tpu_torch
    from hdk_tpu_torch.exec import groupby as gb
    from hdk_tpu_torch.kernels import hist
    from hdk_tpu_torch.exec.masked import MaskedCol
    from hdk_tpu_torch.ir.expr import AggKind
    from hdk_tpu_torch.parallel import mesh as pmesh
    from hdk_tpu_torch.parallel.dist_groupby import dist_groupby_perfect
    from hdk_tpu_torch.utils import commlog

    if device.startswith("cuda"):
        torch.cuda.set_device(0)
    hdk = hdk_tpu_torch.HDK(device=device, **{
        **CONFIG, "dist.multi_host": True,
        "dist.coordinator_address": address,
        "dist.num_processes": WORLD, "dist.process_id": rank,
        "dist.timeout_s": 120})
    ex = hdk._executor
    mesh = ex._mesh
    out = {"rank": rank, "process_count": pmesh.process_count(),
           "process_index": mesh.rank,
           "mesh": [mesh.size, mesh.local_size, mesh.first, mesh.world],
           "devices": [str(d) for d in mesh.devices],
           "transport": commlog.transport().backend}

    # the reference worker's first check: rows 0..15, key = row % 4
    t = hdk_tpu_torch.types
    local = torch.arange(8, dtype=torch.int64, device=hdk.device) + rank * 8
    rows = pmesh.global_from_process_local(mesh, local, 8)
    keys = [[MaskedCol(r % 4) for r in rows]]
    vals = [MaskedCol(r) for r in rows]
    layout = gb.PerfectHashLayout([0], [4])
    specs = [gb.AggSpec(AggKind.COUNT, None, t.int64(False)),
             gb.AggSpec(AggKind.SUM, vals, t.int64())]
    _k, aggs, _e = dist_groupby_perfect(mesh, keys, layout, specs)
    out["perfect"] = [aggs[0].data.tolist(), aggs[1].data.tolist()]

    # the ingest helpers
    n_local = 400 if rank == 0 else 600
    out["quota"] = list(pmesh.process_row_quota(n_local, mesh))
    out["strings"] = pmesh.allgather_host_strings(
        ["shared", f"only{rank}", "é" * (rank + 1)])

    out["collectives"] = run_collectives(
        local_collective_data(mesh.first, mesh.local_size), mesh.first)

    # the reference worker's end-to-end checks: process-local 400/600
    # ingest, SQL GROUP BY and a join with a replicated dim; then the
    # string dictionary unified across the processes
    e2e = e2e_data()
    sl = e2e_slice(rank)
    hdk.import_pydict(take(e2e["mt"], sl), name="mt", process_local=True)
    hdk.import_pydict({"k": list(range(7)),
                       "w": [i * 10 for i in range(7)]}, name="mdim")
    hdk.import_pydict(take(e2e["mstr"], sl), name="mstr",
                      process_local=True)
    hdk.import_pydict({"city": CITIES, "tz": TZ}, name="mcity")
    out["e2e"] = {label: payload(hdk.sql(q)) for label, q in E2E.items()}
    out["mt_rows"] = [hdk._schema.get("mt").nrows,
                      hdk._schema.get("mt").global_nrows]

    # an error raised on every rank before any collective leaves the
    # sessions usable
    try:
        hdk.sql("SELECT no_such_column FROM mt")
        out["binder_error"] = None
    except Exception as e:  # noqa: BLE001 - reported, then checked
        out["binder_error"] = type(e).__name__
    out["after_error"] = payload(hdk.sql("SELECT COUNT(*) AS c FROM mt"))

    # an even split: routes, retries and records of each query
    pt, pdim, psmall = parity_data()
    half = PARITY_ROWS // WORLD
    hdk.import_pydict(take(pt, slice(rank * half, (rank + 1) * half)),
                      name="pt", process_local=True)
    hdk.import_pydict(pdim, name="pdim")
    hdk.import_pydict(psmall, name="psmall")
    parity = {}
    for label, q, _attr, _route in PARITY:
        with commlog.capture() as rec:
            res = payload(hdk.sql(q))
        parity[label] = {"routes": {a: getattr(ex, a) for a in ROUTES},
                         "records": records(rec), "result": res}
    out["parity"] = parity

    # the reference shapes over a process-local ``rt``
    rt, inner = shapes_data()
    sl = (slice(0, SHAPES_SPLIT) if rank == 0
          else slice(SHAPES_SPLIT, SHAPES_ROWS))
    hdk.import_pydict(take(rt, sl), name="rt", process_local=True)
    hdk.import_pydict(inner, name="rt_inner")
    out["shapes"] = [payload(hdk.sql(q)) for q in QUERIES]
    out["launches"] = hist.launches()
    out["transport_stats"] = commlog.transport().stats()
    if device.startswith("cuda"):
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    import torch.distributed as dist

    dist.destroy_process_group()
    return out


# -- the parent: start the ranks ------------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(device: str = "cpu", timeout: float = 300.0) -> list:
    """Both ranks as fresh interpreters; their JSON results in rank
    order.  A rank that fails or outlives ``timeout`` fails the call,
    and every child is killed on the way out."""
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), address, device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{se[-4000:]}"
        line = [ln for ln in so.splitlines() if ln.startswith('{"rank"')]
        assert line, f"rank {r} printed no result:\n{so[-2000:]}"
        results.append(json.loads(line[-1]))
    return results


if __name__ == "__main__":
    print(json.dumps(worker(int(sys.argv[1]), sys.argv[2],
                            sys.argv[3] if len(sys.argv) > 3 else "cpu")),
          flush=True)
    sys.exit(0)


# -- the tests -----------------------------------------------------------------

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def ranks():
    return run_ranks()


@pytest.fixture(scope="module")
def one_process():
    """The one-process 4-shard port session over the same rows."""
    import hdk_tpu_torch

    hdk = hdk_tpu_torch.HDK(device="cpu", **CONFIG)
    load_global(hdk)
    return hdk


@pytest.fixture(scope="module")
def jax_session():
    import hdk_tpu

    hdk = hdk_tpu.HDK(**{"dist.enable": True})
    load_global(hdk)
    return hdk


def load_global(hdk) -> None:
    """Every table whole, as one process holds it."""
    e2e = e2e_data()
    hdk.import_pydict(e2e["mt"], name="mt")
    hdk.import_pydict({"k": list(range(7)),
                       "w": [i * 10 for i in range(7)]}, name="mdim")
    hdk.import_pydict(e2e["mstr"], name="mstr")
    hdk.import_pydict({"city": CITIES, "tz": TZ}, name="mcity")
    pt, pdim, psmall = parity_data()
    hdk.import_pydict(pt, name="pt")
    hdk.import_pydict(pdim, name="pdim")
    hdk.import_pydict(psmall, name="psmall")


def test_ranks_form_one_mesh(ranks):
    for r, got in enumerate(ranks):
        assert got["process_count"] == WORLD and got["process_index"] == r
        assert got["mesh"] == [SHARDS, SHARDS // WORLD, r * 2, WORLD]
        assert got["devices"] == ["cpu", "cpu"]
        assert got["transport"] == "gloo"


def test_dist_groupby_perfect_across_processes(ranks):
    """rows 0..15 over 2 x 2 shards, key = row % 4."""
    for got in ranks:
        assert got["perfect"] == [[4, 4, 4, 4], [24, 28, 32, 36]]


def test_ingest_helpers(ranks):
    for got in ranks:
        assert got["quota"] == [600, 1200]
        assert got["strings"] == [["shared", "only0", "é"],
                                  ["shared", "only1", "éé"]]
        assert got["mt_rows"][1] == N_E2E
    assert [g["mt_rows"][0] for g in ranks] == [400, 600]


def _pandas_e2e():
    import pandas as pd

    e2e = e2e_data()
    df = pd.DataFrame(e2e["mt"])
    df3 = pd.DataFrame(e2e["mstr"])
    g = df.groupby("k").agg(c=("k", "size"), s=("v", "sum")).reset_index()
    j = (df.assign(w=df["k"] * 10).groupby("w").agg(c=("w", "size"))
         .reset_index())
    dg = (df3.groupby("city").agg(c=("city", "size"), s=("amt", "sum"))
          .reset_index().sort_values("city"))
    tz = dict(zip(CITIES, TZ))
    dj = (df3.assign(tz=df3["city"].map(tz)).groupby("tz")
          .agg(c=("tz", "size")).reset_index())
    return {"groupby": g, "join": j, "dict_groupby": dg, "dict_join": dj,
            "dict_filter": int((df3.city == "sfo").sum())}


def test_process_local_ingest_matches_pandas(ranks):
    """The reference worker's 400/600 split: the GROUP BY and the join
    with a replicated dim, on every rank."""
    want = _pandas_e2e()
    for got in ranks:
        e = got["e2e"]
        for label in ("groupby", "join"):
            frame = want[label]
            for col in frame.columns:
                assert e[label][col][0] == frame[col].tolist(), (label, col)


def test_dictionary_unification(ranks):
    """String GROUP BY, a join on the string key and ``city = 'sfo'``
    over process-local string columns."""
    want = _pandas_e2e()
    for got in ranks:
        e = got["e2e"]
        for label in ("dict_groupby", "dict_join"):
            frame = want[label]
            for col in frame.columns:
                assert e[label][col][0] == frame[col].tolist(), (label, col)
        assert e["dict_filter"]["c"][0] == [want["dict_filter"]]


def test_error_on_every_rank_leaves_sessions_usable(ranks):
    for got in ranks:
        assert got["binder_error"] is not None
        assert got["after_error"]["c"][0] == [N_E2E]


@pytest.mark.parametrize("dtype", ["int64", "float64", "float32", "bool"])
def test_collectives_bit_equal_one_process(ranks, dtype):
    """Each collective over 2 x 2 shards gives every local shard what
    the one-process 4-shard call gives that global shard, bit for bit,
    and records the same ops, bytes and shard count."""
    one = run_collectives(collective_data(), 0)
    for got in ranks:
        mine, first = got["collectives"]["results"][dtype], \
            got["collectives"]["first"]
        ref = one["results"][dtype]
        for op, vals in mine.items():
            if op == "gather":
                assert vals == ref[op], op
            else:
                assert vals == ref[op][first:first + len(vals)], op
    for got in ranks:
        assert got["collectives"]["records"] == one["records"]


@pytest.mark.parametrize("label", [p[0] for p in PARITY])
def test_even_split_matches_one_process_session(ranks, one_process,
                                                label):
    """At a 50/50 split every query takes the route, the retries and the
    collectives (op, bytes a shard, shards, gathers) of a one-process
    4-shard session, and returns its result."""
    from hdk_tpu_torch.utils import commlog

    _l, q, attr, route = next(p for p in PARITY if p[0] == label)
    ex = one_process._executor
    with commlog.capture() as rec:
        want = payload(one_process.sql(q))
    routes = {a: getattr(ex, a) for a in ROUTES}
    assert routes[attr] == route
    ordered = "ORDER BY" in q
    for got in ranks:
        g = got["parity"][label]
        assert g["routes"][attr] == route
        assert g["routes"]["_dist_retries"] == routes["_dist_retries"]
        assert g["records"] == records(rec)
        same(g["result"], want, label, ordered=ordered)


@pytest.mark.parametrize("label", [p[0] for p in PARITY]
                         + list(E2E))
def test_same_results_as_jax_dist_session(ranks, jax_session, label):
    q = dict((p[0], p[1]) for p in PARITY).get(label) or E2E[label]
    want = payload(jax_session.sql(q))
    ordered = "ORDER BY" in q
    for got in ranks:
        g = (got["parity"][label]["result"] if label in got["parity"]
             else got["e2e"][label])
        same(g, want, label, ordered=ordered)


def test_ref_shape_queries_are_the_suites():
    from test_ref_shapes import QUERIES as suite

    assert QUERIES == suite and len(QUERIES) == 45


@pytest.fixture(scope="module")
def shapes_single():
    import hdk_tpu_torch

    hdk = hdk_tpu_torch.HDK(device="cpu")
    rt, inner = shapes_data()
    hdk.import_pydict(rt, name="rt")
    hdk.import_pydict(inner, name="rt_inner")
    return hdk


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[q[:48] for q in QUERIES])
def test_ref_shapes_over_process_local_table(ranks, shapes_single, i):
    """tests/test_ref_shapes.py's queries over ``rt`` split 1300/1700
    across the processes equal the single-device port."""
    want = payload(shapes_single.sql(QUERIES[i]))
    for got in ranks:
        same(got["shapes"][i], want, QUERIES[i])
