"""The reference's severity-logger tests (``tests/test_logger.py``) over
hdk_tpu_torch: every test of that file runs unchanged, with the port's
session in the place of ``hdk_tpu.HDK``, the port's ``utils.logger`` in
the place of the reference's, and the reference's logger name
``hdk_tpu`` read as the port's, ``hdk_tpu_torch``, on the CPU and on a
card.
"""

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_logger as ref
from test_logger import *  # noqa: F401,F403

device = twin.twin_module(ref)


def test_every_reference_logger_test_is_run():
    """Every test of tests/test_logger.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())
