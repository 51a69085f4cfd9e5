"""The reference's order-preserving int64 key tests
(``tests/test_orderable.py``) over hdk_tpu_torch's
``exec/groupby.py::_orderable_int64``.

Three of the reference's four tests check the TPU's f64 path: the
arithmetic IEEE-bit reconstruction (``_f64_ieee_bits``), its agreement
with the bitcast path behind ``_F64_BITCAST_OK``, and the native f32
bitcast.  The port has one path, a bitcast, on every device, so those
three have no twin.  The fourth, ``test_orderable_monotone``, is
rewritten below for the port: over the reference's ``doubles`` fixture
(built from that file's text, which imports jax), NaN, +/-0.0 and
+/-inf included, on the CPU and on a card, and held equal, value for
value, to the reference's ``_orderable_int64``.
"""

import numpy as np
import pytest
import torch

import torch_reftwin as twin
from hdk_tpu_torch.exec.groupby import _orderable_int64
from torch_reftwin import rng  # noqa: F401

device = twin.twin_module()

_TPU_PATH = ("checks the TPU's f64 path, which the port does not have: "
             "the port maps floats by one bitcast on every device")
_NOT_TWINNED = {
    "test_f64_ieee_bits_exact": _TPU_PATH + " (_f64_ieee_bits)",
    "test_arith_and_bitcast_paths_agree": _TPU_PATH + " (_F64_BITCAST_OK)",
    "test_f32_path_native_bitcast": _TPU_PATH + " (the f32 bitcast)",
}
_REWRITTEN = {"test_orderable_monotone": "the reference's runs its jitted "
                                         "TPU-path function"}


@pytest.fixture(scope="module")
def doubles(rng):
    return twin.reference_function("test_orderable", "doubles")(rng)


def _port_keys(x: np.ndarray, device: str) -> np.ndarray:
    return _orderable_int64(torch.from_numpy(x).to(device)).cpu().numpy()


def test_orderable_monotone(doubles, device):
    """The reference's checks, NaN included: monotone over the stable
    order of the values, strictly increasing between distinct values
    except -0.0 and 0.0, which map alike; NaN above +inf, -inf lowest."""
    x = doubles
    o = _port_keys(x, device)
    nan = np.isnan(x)
    idx = np.argsort(x, kind="stable")  # NaN last
    assert (np.diff(o[idx]) >= 0).all()
    xs = x[idx]
    distinct = (xs[1:] != xs[:-1]) & ~nan[idx][1:]
    assert (np.diff(o[idx])[distinct] > 0).all()
    assert o[x == 0].min() == o[x == 0].max() == 0
    assert (o[nan] > o[x == np.inf]).all()
    assert o[x == -np.inf].min() == o[~nan].min()


def test_orderable_matches_the_reference(doubles, device):
    """The port's keys are the reference's, value for value."""
    twin.on_reference_only(device)
    import jax.numpy as jnp

    from hdk_tpu.exec import groupby as gb

    want = np.asarray(gb._orderable_int64(jnp.asarray(doubles, jnp.float64)))
    np.testing.assert_array_equal(_port_keys(doubles, "cpu"), want)


def test_every_reference_orderable_test_is_twinned():
    """A test added to tests/test_orderable.py is twinned here."""
    assert set(_NOT_TWINNED) | set(_REWRITTEN) == \
        twin.reference_test_names("test_orderable")
    assert not set(_NOT_TWINNED) & set(_REWRITTEN)
