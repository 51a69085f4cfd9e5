"""The reference's type-system tests (``tests/test_types.py``) over
hdk_tpu_torch's own ``types`` module: every test of that file runs
unchanged with the port's ``types`` in the place of ``hdk_tpu.types``.
The module is host code and makes no session, so its tests run once,
on the CPU.

The port's type objects are also held to the reference's: each type the
reference's tests build or parse, its physical dtype and null sentinel,
and the common type of each pair of them (or the error both raise).
"""

import itertools

import numpy as np
import pytest

import torch_reftwin as twin  # first: may name the port hdk_tpu
import hdk_tpu_torch
import test_types as ref
from test_types import *  # noqa: F401,F403

device = twin.twin_module(ref, devices=["cpu"])

# every type the reference's tests build, as (constructor, arguments)
_BUILT = [
    ("int8", ()), ("int32", ()), ("int64", ()), ("int32", (False,)),
    ("fp32", ()), ("fp64", ()), ("boolean", ()), ("text", ()),
    ("date32", ()), ("timestamp", ()), ("dict_text", (1,)),
    ("dict_text", (3,)), ("decimal64", (10, 2)),
]
_PARSED = ["int64", "int", "bigint", "fp32", "double", "bool", "text",
           "int32 not null", "dec(10,2)", "decimal(5)", "timestamp[ms]",
           "time[us]"]
_BAD = ["wat", "int32[ms]"]


def test_every_reference_types_test_is_run():
    """Every test of tests/test_types.py is collected here."""
    twin.assert_every_test_twinned(ref, globals())


def _types(tm):
    """The reference's tests' types, built with the types module ``tm``."""
    out = [getattr(tm, name)(*args) for name, args in _BUILT]
    return out + [tm.parse_type(s) for s in _PARSED]


def _describe(ty):
    try:
        sentinel = ty.null_sentinel()
    except ValueError:  # a type with no numeric sentinel
        sentinel = None
    if isinstance(sentinel, (float, np.floating)) and np.isnan(sentinel):
        sentinel = "nan"
    return (str(ty), repr(ty), ty.nullable, np.dtype(ty.physical_dtype()),
            sentinel)


def _common(tm, a, b):
    try:
        return _describe(tm.common_type(a, b))
    except TypeError as e:
        return ("TypeError", str(e))


def test_types_match_the_reference(device):
    """Each type's text, repr, nullability, physical dtype and null
    sentinel, the port's against the reference's."""
    twin.on_reference_only(device)
    ref_types = twin.REFERENCE.types
    mine, theirs = _types(hdk_tpu_torch.types), _types(ref_types)
    assert [_describe(t) for t in mine] == [_describe(t) for t in theirs]
    for s in _BAD:
        with pytest.raises(ValueError) as a:
            hdk_tpu_torch.types.parse_type(s)
        with pytest.raises(ValueError) as b:
            ref_types.parse_type(s)
        assert str(a.value) == str(b.value)


def test_promotions_match_the_reference(device):
    """The common type of every ordered pair of those types, or the
    TypeError both raise."""
    twin.on_reference_only(device)
    ref_types = twin.REFERENCE.types
    mine, theirs = _types(hdk_tpu_torch.types), _types(ref_types)
    pm = hdk_tpu_torch.types
    for (a, b), (c, d) in zip(itertools.product(mine, mine),
                              itertools.product(theirs, theirs)):
        assert _common(pm, a, b) == _common(ref_types, c, d), (a, b)
