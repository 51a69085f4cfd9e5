"""The reference's scalar expression, projection and filter tests
(``tests/test_project_filter.py``) over hdk_tpu_torch: every test of that
file runs unchanged, on its data and against its expected values, with
the port's session in the place of ``hdk_tpu.HDK`` and the port's
``types`` in the place of ``hdk_tpu.types``, on the CPU and on a card.
"""

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_project_filter as ref
from test_project_filter import *  # noqa: F401,F403

device = twin.twin_module(ref)
hdk = twin.per_device(ref.hdk)


def test_every_reference_project_filter_test_is_run():
    """Every test of tests/test_project_filter.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())
