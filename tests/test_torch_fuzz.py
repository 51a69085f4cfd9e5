"""The reference's seeded fuzzers over hdk_tpu_torch.

``tests/test_fuzz_differential.py`` and ``tests/test_fuzz_wide.py`` build
random builder queries from fixed seeds (filters, group keys and
aggregate mixes; joins with the spread route admitted, outer joins,
windows, datetime, strings, masked unions, 4-shard sessions and the
eager-aggregation rewrite) and hold each result to pandas.  Here each of
their fixtures and tests runs unchanged, with the port's CPU session in
the place of ``hdk_tpu.HDK`` (and the port's types in the wide fuzzer's
schema): the same data, the same queries at the same seeds and the same
pandas oracle as the reference's own run of those files.
"""

import functools

import pytest

import hdk_tpu
import hdk_tpu_torch
import test_fuzz_differential as fd
import test_fuzz_wide as fw


def _port_fixture(fixture):
    """The reference fixture's body, building its sessions with the
    port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hdk_tpu, "HDK",
                   functools.partial(hdk_tpu_torch.HDK, device="cpu"))
        mp.setattr(fw, "t", hdk_tpu_torch.types)
        return fixture.__wrapped__()


@pytest.fixture(scope="module")
def env():
    return _port_fixture(fd.env)


@pytest.fixture(scope="module")
def jenv():
    return _port_fixture(fw.jenv)


@pytest.fixture(scope="module")
def wenv():
    return _port_fixture(fw.wenv)


@pytest.fixture(scope="module")
def denv():
    return _port_fixture(fw.denv)


@pytest.fixture(scope="module")
def senv():
    return _port_fixture(fw.senv)


@pytest.fixture(scope="module")
def distenv():
    return _port_fixture(fw.distenv)


@pytest.fixture(scope="module")
def eenv():
    return _port_fixture(fw.eenv)


def test_sessions_are_the_ports(env, jenv, distenv):
    assert isinstance(env[0], hdk_tpu_torch.HDK)
    assert isinstance(jenv[0], hdk_tpu_torch.HDK)
    assert jenv[0].config.exec.join.spread_join_min_rows == 50
    assert distenv[0]._executor._mesh.size == 4


# (reference test, its fixture, its seeds): every test of both files
_CASES = [
    (fd.test_fuzz_grouped_query, "env", 30),
    (fd.test_fuzz_filter_project_sort, "env", 10),
    (fw.test_fuzz_fk_join_agg, "jenv", 15),
    (fw.test_fuzz_dup_key_join, "jenv", 10),
    (fw.test_fuzz_left_join, "jenv", 8),
    (fw.test_fuzz_right_full_join, "jenv", 8),
    (fw.test_fuzz_window_rank_rowno, "wenv", 12),
    (fw.test_fuzz_window_agg_shift, "wenv", 12),
    (fw.test_fuzz_datetime_extract_group, "denv", 14),
    (fw.test_fuzz_datetime_trunc_count, "denv", 6),
    (fw.test_fuzz_string_filter_group, "senv", 12),
    (fw.test_fuzz_string_distinct, "senv", 6),
    (fw.test_fuzz_masked_union, "jenv", 8),
    (fw.test_fuzz_dist_groupby, "distenv", 6),
    (fw.test_fuzz_dist_join, "distenv", 4),
    (fw.test_fuzz_dist_distinct, "distenv", 4),
    (fw.test_fuzz_eager_agg, "eenv", 20),
]


@pytest.mark.parametrize(
    "test,fixture,seed",
    [pytest.param(t, f, s, id=f"{t.__name__}[{s}]")
     for t, f, n in _CASES for s in range(n)])
def test_reference_fuzzer_on_the_port(test, fixture, seed, request):
    test(request.getfixturevalue(fixture), seed)


def test_every_reference_fuzz_test_is_run():
    """A fuzz test added to the reference's files must be added here."""
    names = {n for m in (fd, fw) for n in dir(m) if n.startswith("test_")}
    assert names == {t.__name__ for t, _, _ in _CASES}
    for t, _, n in _CASES:
        (mark,) = [m for m in t.pytestmark if m.name == "parametrize"]
        assert list(mark.args[1]) == list(range(n)), t.__name__
