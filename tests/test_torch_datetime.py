"""The reference's datetime tests (``tests/test_datetime.py``: EXTRACT,
DATE_TRUNC, interval arithmetic, the stats-bounded YEAR) over
hdk_tpu_torch: every test of that file runs unchanged, on its data and
against its pandas oracle, with the port's session in the place of
``hdk_tpu.HDK`` and the port's ``types`` in the place of
``hdk_tpu.types``, on the CPU and on a card.
"""

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_datetime as ref
from test_datetime import *  # noqa: F401,F403
from torch_reftwin import rng  # noqa: F401

device = twin.twin_module(ref)
hdk = twin.per_device(ref.hdk)


def test_every_reference_datetime_test_is_run():
    """Every test of tests/test_datetime.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())
