"""The reference's infrastructure tests (``tests/test_infra.py``: EXPLAIN,
the watchdog, the config tree, code-cache hits, the debug timer's tree,
device-cache eviction, EXPLAIN ANALYZE) over hdk_tpu_torch: every test of
that file runs unchanged, on its data and against its expected values,
with the port's session in the place of ``hdk_tpu.HDK`` and the port's
modules in the place of the reference's, on the CPU and on a card.  The
one exception is ``test_code_cache_hits``: the JAX package counts hits
of its jit cache there, and the port, which runs eagerly and caches no
step, checks in its place what that cache's key guarded.

The debug timer's tree, after a builder query and after a SQL query, is
also the last step's span with its ``ms``, and on the CPU the port opens
``hdk_tpu``'s step spans: the same kinds in the same order.
"""

import pytest

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_infra as ref
from test_infra import *  # noqa: F401,F403
from torch_reftwin import rng  # noqa: F401

device = twin.twin_module(ref)
hdk = twin.per_device(ref.hdk)

_TABLES = {"infra_t": {"k": [1, 2, 1, 3], "v": [1., 2., 3., 4.]}}

# the reference's timer query first
_TIMED = {
    "builder": lambda s: s.scan("infra_t").agg("k", "count").run(),
    "sql": lambda s: s.sql("SELECT k, COUNT(*) AS c FROM infra_t "
                           "WHERE v > 1 GROUP BY k"),
}


def test_every_reference_infra_test_is_run():
    """Every test of tests/test_infra.py is collected here."""
    twin.assert_every_test_twinned(ref, globals(), changed={
        "test_code_cache_hits":
            "the JAX package's jit cache; the port runs eagerly"})


def test_code_cache_hits(hdk, ht, device):
    """The same plan run twice gives the same answer, and a GROUP BY over
    a dictionary string column, run again after rows with a new string
    are imported into the same dictionary, reads the new codes."""
    runs = [ht.agg("k", "count").run().to_numpy() for _ in range(2)]
    assert [{c: v.tolist() for c, v in r.items()} for r in runs] == \
        [{"k": [1, 2, 3], "count": [2, 1, 1]}] * 2
    hdk.import_pydict({"s": ["b", "a", "b"], "v": [1, 2, 3]},
                      name="infra_dict_t")
    sql = ("SELECT s, COUNT(*) AS c, SUM(v) AS t FROM infra_dict_t "
           "GROUP BY s ORDER BY s")

    def rows():
        out = hdk.sql(sql).to_numpy()
        return list(zip(*(out[c].tolist() for c in ("s", "c", "t"))))

    assert rows() == [("a", 1, 2), ("b", 2, 4)]
    hdk.append_pydict("infra_dict_t", {"s": ["c", "a", "c"],
                                       "v": [10, 20, 30]})
    assert rows() == [("a", 2, 22), ("b", 2, 4), ("c", 2, 40)]


@pytest.mark.parametrize("query", list(_TIMED))
def test_timer_tree_has_the_reference_steps(query, device):
    twin.assert_timer_steps_match(_TABLES, _TIMED[query], device)
