"""ORDER BY / LIMIT of the port against the JAX package (the twin of
tests/test_sort.py): the same numpy data through ``hdk_tpu.HDK()`` and
``hdk_tpu_torch.HDK(device="cpu")``, the builder's ``sort``/``limit``
over ascending, descending, multi-key, NULL-placement, string and array
columns; a sort without a small LIMIT takes the full sort
(``_topn_route`` "full"), one with a LIMIT the streaming top-n.

Row order is exact: keys and integers equal, floats to rtol 1e-9
(``torch_twin.assert_same``)."""

import numpy as np
import pytest

from torch_twin import assert_same, twin_sessions


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(17)
    n = 2000
    b = rng.normal(size=n)
    bn = [None if nul else float(v)
          for v, nul in zip(b, rng.random(n) < 0.05)]
    k = 500
    arr = {"k": rng.integers(0, 100, k),
           "a": [[int(x) for x in row] for row in rng.integers(0, 9, (k, 3))]}
    return twin_sessions({
        "sort_t": {"a": rng.integers(0, 50, n), "b": b,
                   "s": rng.choice(["x", "y", "z"], n), "bn": bn},
        "sortarr_t": arr})


def _both(twins, make, route):
    jx, pt = twins
    got = make(pt.scan("sort_t")).run()
    assert_same(make(jx.scan("sort_t")).run(), got, ordered=True)
    assert pt._executor._topn_route == route
    return got


def test_single_key_asc(twins):
    _both(twins, lambda t: t.sort("a"), "full")


def test_single_key_desc(twins):
    _both(twins, lambda t: t.sort(("b", "desc")), "full")


def test_multi_key(twins):
    _both(twins, lambda t: t.sort("a", ("b", "desc")), "full")


def test_nulls_last_default_asc(twins):
    got = _both(twins, lambda t: t.sort("bn"), "full").to_arrow()
    nulls = got.column("bn").is_null().to_numpy()
    assert nulls.any() and nulls[-nulls.sum():].all()


def test_nulls_first_default_desc(twins):
    got = _both(twins, lambda t: t.sort(("bn", "desc")), "full").to_arrow()
    nulls = got.column("bn").is_null().to_numpy()
    assert nulls[:nulls.sum()].all()


def test_explicit_null_placement(twins):
    got = _both(twins, lambda t: t.sort(("bn", "asc", "nulls_first")),
                "full").to_arrow()
    nulls = got.column("bn").is_null().to_numpy()
    assert nulls[:nulls.sum()].all()


def test_limit_offset(twins):
    got = _both(twins, lambda t: t.sort("a", limit=10, offset=5),
                "streaming")
    assert got.row_count == 10


def test_limit_without_sort(twins):
    jx, pt = twins
    got = pt.scan("sort_t").limit(7).run()
    assert got.row_count == 7
    assert_same(jx.scan("sort_t").limit(7).run(), got, ordered=True)


def test_sort_string_column(twins):
    _both(twins, lambda t: t.sort("s", "a"), "full")


def test_topk_pattern(twins):
    """ORDER BY count DESC LIMIT k over a GROUP BY (taxi Q4's shape): the
    group buffer through the streaming top-n."""
    _both(twins, lambda t: t.agg("a", "count").sort(("count", "desc"), "a",
                                                    limit=5), "streaming")


def test_sort_with_array_column_payload(twins):
    """A fixed-width array column rides the sort as a payload."""
    jx, pt = twins
    got = pt.scan("sortarr_t").sort(("k", "desc")).run()
    assert_same(jx.scan("sortarr_t").sort(("k", "desc")).run(), got,
                ordered=True)
