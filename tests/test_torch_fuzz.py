"""The reference's seeded fuzzers over hdk_tpu_torch.

``tests/test_fuzz_differential.py`` and ``tests/test_fuzz_wide.py`` build
random builder queries from fixed seeds (filters, group keys and
aggregate mixes; joins with the spread route admitted, outer joins,
windows, datetime, strings, masked unions, 4-shard sessions and the
eager-aggregation rewrite) and hold each result to pandas.  Here each of
their fixtures and tests runs unchanged, with the port's CPU session in
the place of ``hdk_tpu.HDK`` (and the port's types in the wide fuzzer's
schema): the same data, the same queries at the same seeds and the same
pandas oracle as the reference's own run of those files.  On a card,
``test_reference_fuzzer_on_the_card`` runs every case again with the
port's sessions on CUDA (the 4-shard sessions as four shards of the one
card), held to the same oracle, and no kernel's plain version runs
while a session on the card executes.
"""

import sys
import types

import pytest
import torch

import torch_reftwin as twin  # first: may name the port hdk_tpu
import hdk_tpu_torch
import test_fuzz_differential as fd
import test_fuzz_wide as fw


def _port_fixture(fixture, device="cpu"):
    """The reference fixture's body, building its sessions with the
    port on ``device``."""
    module = sys.modules[fixture.__module__]
    with twin.port_context(module, device):
        if twin.REFERENCE is not None:
            return fixture.__wrapped__()
        # the 4-shard fixture asks jax for four devices; where hdk_tpu
        # may not run, the port's mesh puts four shards on one device
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "jax",
                       types.SimpleNamespace(devices=lambda: [device] * 4))
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


@pytest.fixture(scope="module")
def card_envs():
    """A fixture's name to its value built with the port's sessions on the
    card, each built once, while no kernel's plain version may run in a
    session on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        twin.guard_plain_versions(mp)

        def get(name):
            if name not in built:
                module = fd if name == "env" else fw
                built[name] = _port_fixture(getattr(module, name), "cuda")
            return built[name]

        yield get


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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "test,fixture,seed",
    [pytest.param(t, f, s, id=f"{t.__name__}[{s}]")
     for t, f, n in _CASES for s in range(n)])
def test_reference_fuzzer_on_the_card(test, fixture, seed, card_envs):
    value = card_envs(fixture)
    if fixture == "distenv":
        assert value[0]._executor._mesh.size == 4
    assert value[0].device.type == "cuda"
    with twin.port_context(sys.modules[test.__module__], "cuda"):
        test(value, seed)


def test_guard_refuses_plain_versions_in_a_card_session():
    """The guard of the card's cases refuses a plain version that a
    session on a CUDA device runs on a host copy of its gids, and lets a
    CPU session's run."""
    from hdk_tpu_torch.exec.executor import Executor
    from hdk_tpu_torch.kernels import hist

    gid = torch.tensor([0, 1, 1], dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Executor, "execute",
                   lambda self, dag: hist.count_hist(gid, 2))
        twin.guard_plain_versions(mp)
        on = {d: types.SimpleNamespace(device=torch.device(d))
              for d in ("cpu", "cuda")}
        assert Executor.execute(on["cpu"], None).tolist() == [1, 2]
        with pytest.raises(AssertionError, match="CUDA session"):
            Executor.execute(on["cuda"], None)
        assert hist.count_hist(gid, 2).tolist() == [1, 2]


def test_every_reference_fuzz_test_is_run():
    """A fuzz test added to the reference's files must be added here."""
    names = {n for m in (fd, fw) for n in dir(m) if n.startswith("test_")}
    assert names == {t.__name__ for t, _, _ in _CASES}
    for t, _, n in _CASES:
        (mark,) = [m for m in t.pytestmark if m.name == "parametrize"]
        assert list(mark.args[1]) == list(range(n)), t.__name__
