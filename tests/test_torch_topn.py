"""The streaming top-n of the port (the twin of tests/test_lex_topn.py):
``hdk_tpu_torch.exec.sort.lex_topn`` (K+2 ``torch.topk`` candidate passes
and one small sort) against the port's full lexsort (``full_topn``), a
numpy stable lexsort and ``hdk_tpu.exec.sort.lex_topn`` on the same numpy
keys; then ORDER BY ... LIMIT through ``hdk_tpu.HDK()`` and
``hdk_tpu_torch.HDK(device="cpu")`` on the same data, and the gate
``0 < offset+limit <= exec.streaming_topn_max`` and ``offset+limit <
rows`` that sends a sort down the streaming route.

Row order is exact everywhere: keys, row ids and counts compare equal,
float sums to rtol 1e-9 (``torch_twin.assert_same``).  The JAX package
pins a NULL to an int64 extreme (ROADMAP C.5), so keys holding those
extremes meet it only where no column is nullable.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hdk_tpu.exec import sort as jsrt
from hdk_tpu.exec.masked import MaskedCol as JCol

import hdk_tpu_torch
from hdk_tpu_torch.exec import sort as tsrt
from hdk_tpu_torch.exec.masked import MaskedCol as TCol

from torch_twin import assert_same, twin_sessions

I64 = np.iinfo(np.int64)
EXTREMES = np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max])

# the JAX package's lex_topn, one compile per key count and LIMIT
jax_lex_topn = jax.jit(jsrt.lex_topn, static_argnums=1)


def _oracle(keys, rm, n):
    """Row order of a numpy stable lexsort: live rows first, then the
    keys, then the row id."""
    dead = np.zeros(n, bool) if rm is None else ~rm
    return np.lexsort(tuple([np.arange(n)] + [k.numpy() for k in
                                              reversed(keys)] + [dead]))


def _fuzz_case(rng, n, K, trial, extremes):
    """K columns of heavy ties (or int64 extremes), nullable on odd
    trials, with random directions and NULL placements; a row mask on
    every third trial, sparse on every sixth (fewer live rows than the
    LIMIT)."""
    vals, masks = [], []
    for _ in range(K):
        vals.append(rng.choice(EXTREMES, n) if extremes
                    else rng.integers(0, 4, n).astype(np.int64))
        masks.append((rng.random(n) > 0.2) if trial % 2 else None)
    descs = [bool(rng.random() < 0.5) for _ in range(K)]
    nfs = [bool(rng.random() < 0.5) for _ in range(K)]
    rm = None
    if trial % 3 == 0:
        rm = rng.random(n) > (0.95 if trial % 6 == 0 else 0.3)
    return vals, masks, descs, nfs, rm


@pytest.mark.parametrize("extremes", [False, True],
                         ids=["ties", "int64_extremes"])
def test_lex_topn_matches_full_sort_fuzz(extremes):
    """The streaming top-n equals the full lexsort and the numpy oracle
    over tied, NULL, masked and dead rows, for a LIMIT below and above
    the live rows, and equals the JAX package's ``lex_topn`` (where it
    has no NULL sentinel collision)."""
    rng = np.random.default_rng(3 + extremes)
    n = 257
    for K in (1, 2, 3):
        for trial in range(8):
            vals, masks, descs, nfs, rm = _fuzz_case(rng, n, K, trial,
                                                     extremes)
            trm = None if rm is None else torch.from_numpy(rm)
            keys = tsrt.sort_keys_int64(
                [TCol(torch.from_numpy(v),
                      None if m is None else torch.from_numpy(m))
                 for v, m in zip(vals, masks)], descs, nfs)
            order = _oracle(keys, rm, n)
            live = n if rm is None else int(rm.sum())
            for topn in (13, 100):
                got = tsrt.lex_topn(keys, topn, trm).numpy()
                full = tsrt.full_topn(keys, topn, trm).numpy()
                assert got.shape == (topn,)
                m = min(topn, live)  # beyond the live rows, the window masks
                assert (got[:m] == order[:m]).all(), (K, trial, topn)
                assert (full[:m] == order[:m]).all(), (K, trial, topn)
                if extremes and masks[0] is not None:
                    continue
                jkeys = jsrt.sort_keys_int64(
                    [JCol(jnp.asarray(v),
                          None if mk is None else jnp.asarray(mk))
                     for v, mk in zip(vals, masks)], descs, nfs)
                want = np.asarray(jax_lex_topn(
                    jkeys, topn, None if rm is None else jnp.asarray(rm)))
                assert (got[:m] == want[:m]).all(), (K, trial, topn)


def test_lex_topn_raw_int64_keys_against_jax():
    """Raw int64 keys holding both extremes, no NULLs: the two packages'
    ``lex_topn`` and the port's full lexsort agree row for row."""
    rng = np.random.default_rng(9)
    n = 257
    for trial in range(4):
        raw = [rng.choice(EXTREMES, n) for _ in range(2)]
        rm = (rng.random(n) > 0.4) if trial % 2 else None
        tk = [torch.from_numpy(k) for k in raw]
        trm = None if rm is None else torch.from_numpy(rm)
        got = tsrt.lex_topn(tk, 13, trm).numpy()
        assert (got == tsrt.full_topn(tk, 13, trm).numpy()).all()
        want = np.asarray(jax_lex_topn(
            [jnp.asarray(k) for k in raw], 13,
            None if rm is None else jnp.asarray(rm)))
        assert (got == want).all(), trial


def _nullable(rng, values, share):
    keep = rng.random(len(values)) >= share
    return [v if k else None for v, k in zip(values.tolist(), keep)]


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(21)
    n = 5000
    lt = {"a": rng.integers(0, 20, n), "b": rng.integers(0, 30, n),
          "v": rng.normal(size=n)}
    m = 3000
    nulls = {"a": rng.integers(0, 8, m),
             "b": _nullable(rng, rng.normal(size=m), 0.1)}
    k = 4000
    filt = {"a": rng.integers(0, 6, k), "b": rng.integers(0, 5, k),
            "f": rng.integers(0, 2, k)}
    g = 20000
    gb = {"k": rng.integers(0, 500, g), "d": rng.integers(0, 4, g),
          "v": rng.integers(0, 100, g)}
    small = {"a": [3, 1, 2], "b": [9, 9, 1], "f": [1, 1, 0]}
    return twin_sessions({"lt_t": lt, "lt_null_t": nulls, "lt_filt_t": filt,
                          "lt_gb_t": gb, "lt_small_t": small})


def _both(twins, sql, route="streaming"):
    jx, pt = twins
    assert_same(jx.sql(sql), pt.sql(sql), ordered=True)
    assert pt._executor._topn_route == route


def test_sql_multikey_limit(twins):
    _both(twins, "SELECT a, b, v FROM lt_t ORDER BY a DESC, b, v LIMIT 25")


def test_sql_multikey_limit_offset_nulls(twins):
    _both(twins, "SELECT a, b FROM lt_null_t ORDER BY a, b DESC "
                 "LIMIT 40 OFFSET 7")


def test_sql_multikey_limit_filtered(twins):
    """Filtered rows never displace live rows inside the LIMIT window."""
    _both(twins, "SELECT a, b FROM lt_filt_t WHERE f = 1 "
                 "ORDER BY b DESC, a LIMIT 15")


def test_groupby_multikey_limit(twins):
    """The fused aggregate sort (the TPC-H Q3 tail's shape), its group
    buffer through the streaming route."""
    _both(twins, "SELECT k, d, SUM(v) AS s FROM lt_gb_t GROUP BY k, d "
                 "ORDER BY s DESC, k, d LIMIT 12")


def test_fused_identity_tail_warm_repeat():
    """TPC-H Q3's warm shape: the eager-aggregation rewrite, the
    partials join, then the identity pass and the top-n, run twice (the
    second run reads the recycled join tables)."""
    rng = np.random.default_rng(23)
    n_ord, n_li = 9000, 60000
    orders = {"o_orderkey": np.arange(n_ord, dtype=np.int64),
              "o_flag": rng.integers(0, 3, n_ord).astype(np.int8),
              "o_keep": rng.integers(0, 2, n_ord).astype(np.int8)}
    li = {"l_orderkey": rng.integers(0, n_ord, n_li),
          "l_price": (np.round(rng.gamma(3.0, 100.0, n_li) * 8) / 8
                      ).astype(np.float32)}
    jx, pt = twin_sessions({"ft_orders": orders, "ft_li": li},
                           **{"exec.eager_agg_min_rows": 1000,
                              "exec.eager_agg_min_ratio": 0.1,
                              "exec.enable_route_feedback": False})
    sql = ("SELECT l_orderkey, o_flag, SUM(l_price) AS rev "
           "FROM ft_li, ft_orders WHERE l_orderkey = o_orderkey "
           "AND o_keep = 1 GROUP BY l_orderkey, o_flag "
           "ORDER BY rev DESC, l_orderkey LIMIT 20")
    for _ in range(2):
        assert_same(jx.sql(sql), pt.sql(sql), ordered=True)
        assert pt._executor._topn_route == "streaming"


def test_limit_larger_than_live(twins):
    """LIMIT 10 of 3 rows takes the full sort; the filter leaves 2."""
    _both(twins, "SELECT a, b FROM lt_small_t WHERE f = 1 "
                 "ORDER BY b, a DESC LIMIT 10", route="full")


@pytest.mark.parametrize("shape", ["row_sort", "group_sort"])
def test_route_gate(monkeypatch, shape):
    """The streaming route runs iff 0 < offset+limit <=
    streaming_topn_max and offset+limit < rows, and gives the full
    sort's rows: knob 0 and topn-1 sort fully, knob topn streams, and a
    LIMIT covering every row sorts fully at any knob."""
    rng = np.random.default_rng(31)
    n = 3000
    data = {"g": rng.integers(0, 40, n),
            "x": _nullable(rng, rng.integers(0, 50, n), 0.1),
            "y": rng.integers(0, 7, n)}
    calls = []

    def spy(keys, topn, rm=None, _real=tsrt.lex_topn):
        calls.append(topn)
        return _real(keys, topn, rm)

    monkeypatch.setattr(tsrt, "lex_topn", spy)
    if shape == "row_sort":
        sql = "SELECT g, x, y FROM t ORDER BY y DESC, x LIMIT {} OFFSET 5"
    else:  # a group buffer of 40 dense entries
        sql = ("SELECT g, COUNT(*) AS c, SUM(x) AS s FROM t GROUP BY g "
               "ORDER BY c DESC, g LIMIT {} OFFSET 5")
    limit = 20
    topn = limit + 5
    results = {}
    for knob in (0, topn - 1, topn, 100000):
        pt = hdk_tpu_torch.HDK(device="cpu",
                               **{"exec.streaming_topn_max": knob})
        pt.import_pydict(data, name="t")
        # LIMIT n + OFFSET 5 covers every row and every group
        for lim in (limit, n):
            del calls[:]
            res = pt.sql(sql.format(lim))
            want = lim == limit and 0 < topn <= knob
            assert calls == ([topn] if want else []), (knob, lim)
            assert pt._executor._topn_route == (
                "streaming" if want else "full")
            results.setdefault(lim, []).append(res)
    jx, _ = twin_sessions({"t": data})
    for lim, got in results.items():
        want = jx.sql(sql.format(lim))
        for res in got:
            assert_same(want, res, ordered=True)
