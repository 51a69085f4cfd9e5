"""The reference's uniqueness-certificate tests
(``tests/test_unique_identity.py``: the group-by identity pass over
certified-unique keys, and masked perfect-join outputs) over
hdk_tpu_torch, with the port's session in the place of ``hdk_tpu.HDK``,
on the CPU and on a card.

Four of them spy, through the file's ``_track_identity``, on two
identity entry points, ``AggExecMixin._agg_identity_table`` and
``_exec_fused_identity_sort``; the port has only the first (the fused
identity + sort was removed: in eager torch it duplicated the identity
pass followed by the Sort step).  Each of the four runs here with its
query and its pandas oracle unchanged, and the spy on the port's
identity pass in the place of ``_track_identity``.
"""

import functools

import pytest

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_unique_identity as ref
from test_unique_identity import *  # noqa: F401,F403
from hdk_tpu_torch.exec.agg_exec import AggExecMixin  # not the reference's

device = twin.twin_module(ref)

_NOT_TWINNED = {
    name: "spies on AggExecMixin._exec_fused_identity_sort, which the "
          "port does not have: run with the spy on the port's identity "
          "pass"
    for name in ("test_eager_regroup_identity_fires_and_matches",
                 "test_identity_agg_kinds_match_oracle",
                 "test_identity_respects_null_aggregates",
                 "test_no_identity_without_certificate")}


def _track_port_identity(monkeypatch):
    """The reference's ``_track_identity`` on the port's one identity
    pass: a flag for each call, whether it fired."""
    fired = []
    orig = AggExecMixin._agg_identity_table

    def patched(self, node, source, chain, src_node):
        r = orig(self, node, source, chain, src_node)
        fired.append(r is not None)
        return r

    monkeypatch.setattr(AggExecMixin, "_agg_identity_table", patched)
    return fired


def _with_port_spy(test):
    @functools.wraps(test)
    def spied(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref, "_track_identity", _track_port_identity)
            return test(*args, **kwargs)
    return spied


for _name in _NOT_TWINNED:
    globals()[_name] = _with_port_spy(getattr(ref, _name))


def test_every_reference_unique_identity_test_is_twinned():
    """Every test of tests/test_unique_identity.py is collected here,
    the four spies with the port's spy."""
    twin.assert_every_test_twinned(ref, globals(), _NOT_TWINNED)
