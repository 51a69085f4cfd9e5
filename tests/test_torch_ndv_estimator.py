"""The reference's NDV estimator tests (``tests/test_ndv_estimator.py``)
over hdk_tpu_torch: every test of that file runs unchanged, on its data
and against its own checks, with the port's session in the place of
``hdk_tpu.HDK``, on the CPU and on a card.

On the CPU, a test that samples through the ``hdk`` fixture also runs on
``hdk_tpu`` over the same data, drawn from a fresh generator of the same
seed, and the port's estimate and group-by attempts must equal the
reference's.
"""

import inspect

import numpy as np
import pytest

import torch_reftwin as twin  # first: may name the port hdk_tpu
import test_ndv_estimator as ref
from test_ndv_estimator import *  # noqa: F401,F403

device = twin.twin_module(ref)


@pytest.fixture
def rng():
    """A fresh generator for each test: the reference's run of the same
    test draws the same data."""
    return np.random.default_rng(42)


def test_every_reference_ndv_estimator_test_is_run():
    """Every test of tests/test_ndv_estimator.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())


@pytest.mark.parametrize(
    "name", sorted(n for n in twin.reference_test_names("test_ndv_estimator")
                   if "hdk" in inspect.signature(getattr(ref, n)).parameters))
def test_estimates_match_the_reference(name, device):
    twin.on_reference_only(device)
    func = getattr(ref, name)
    mine = twin.run_on_port(
        func, {}, rng=np.random.default_rng(42))["hdk"]._executor
    theirs = twin.run_on_reference(
        func, {}, rng=np.random.default_rng(42))["hdk"]._executor
    assert mine._ndv_estimate is not None
    assert (mine._ndv_estimate, mine._groupby_attempts) == \
        (theirs._ndv_estimate, theirs._groupby_attempts)
