"""The reference's SQL frontend tests (``tests/test_sql.py``) over
hdk_tpu_torch: every test of that file runs unchanged, on its data and
against its sqlite3 and pandas oracles, with the port's session in the
place of ``hdk_tpu.HDK``, on the CPU and on a card.

``test_date_functions`` creates the table that ``test_timestamp_literal``
reads; both run in this module, in the file's order, on each device.
"""

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_sql as ref
from test_sql import *  # noqa: F401,F403
from torch_reftwin import rng  # noqa: F401

device = twin.twin_module(ref)
hdk = twin.per_device(ref.hdk)


def test_every_reference_sql_test_is_run():
    """Every test of tests/test_sql.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())


def test_sessions_are_the_ports(hdk, env, device):
    assert isinstance(hdk, twin.hdk_tpu_torch.HDK)
    assert hdk.device.type == device and env[0] is hdk
    assert "t" in hdk.table_names() and "dim" in hdk.table_names()
