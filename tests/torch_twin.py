"""Twin sessions: the same numpy data in hdk_tpu and hdk_tpu_torch.

For a database the ingested tables and their string dictionaries play the
part of a model's weights: both packages ingest one numpy dict through
``import_pydict``, and ``twin_sessions`` asserts that they hold the same
columns, dictionary codes and fragment stats before any query runs.
Results come back as pandas frames and compare with ``assert_same``.
"""

from __future__ import annotations

from dataclasses import astuple
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import pandas as pd

import hdk_tpu
import hdk_tpu_torch

from harness import canon

# relative tolerance of float aggregates: the engine's own (harness.py);
# AVG over float32 inputs: the JAX package adds float32 within 8192-row
# blocks (ops/onehot.py), the port adds in float64
F64_RTOL = 1e-9
F32_AVG_RTOL = 1e-6


def twin_sessions(tables: Dict[str, dict],
                  schema: Optional[Callable] = None, **config):
    """(hdk_tpu session, hdk_tpu_torch CPU session) holding ``tables``.
    ``schema(types_module)`` gives a table's declared types, built from
    each package's own types module."""
    jx = hdk_tpu.HDK(**config)
    pt = hdk_tpu_torch.HDK(device="cpu", **config)
    for name, data in tables.items():
        jx.import_pydict(data, name=name,
                         schema=schema(hdk_tpu.types) if schema else None)
        pt.import_pydict(data, name=name,
                         schema=schema(hdk_tpu_torch.types) if schema
                         else None)
    assert_same_storage(jx, pt)
    return jx, pt


def assert_same_storage(jx, pt) -> None:
    """Same columns, types, dictionary codes and fragment stats."""
    assert sorted(jx.table_names()) == sorted(pt.table_names())
    for name in jx.table_names():
        a = jx._schema.get(name)
        b = pt._schema.get(name)
        assert a.nrows == b.nrows and a.fragments == b.fragments
        assert a.column_names() == b.column_names()
        for ca, cb in zip(a.columns, b.columns):
            assert str(ca.type) == str(cb.type), (ca.info.name, ca.type)
            assert ca.data.dtype == cb.data.dtype
            assert np.array_equal(ca.data, cb.data,
                                  equal_nan=ca.data.dtype.kind == "f"), \
                ca.info.name
            assert ((ca.validity is None and cb.validity is None)
                    or np.array_equal(ca.validity, cb.validity))
            if ca.type.is_dict_encoded_string():
                assert (jx._dicts.get(ca.type.dict_id).all_strings()
                        == pt._dicts.get(cb.type.dict_id).all_strings())
            for frag in a.fragments:
                assert (astuple(a.stats(ca.info.name, frag))
                        == astuple(b.stats(cb.info.name, frag))), ca.info.name


def assert_same(res_jax, res_torch, ordered: bool = True,
                f32_avg: Sequence[str] = ()) -> None:
    """Equal results: keys and counts exactly, float columns to
    ``F64_RTOL`` (``F32_AVG_RTOL`` for the columns named in
    ``f32_avg``)."""
    a = res_jax.to_pandas()
    b = res_torch.to_pandas()
    assert list(a.columns) == list(b.columns)
    if not ordered:
        a, b = canon(a), canon(b)
    assert len(a) == len(b), (a, b)
    for c in a.columns:
        x, y = a[c], b[c]
        xn, yn = pd.isna(x).to_numpy(), pd.isna(y).to_numpy()
        assert (xn == yn).all(), f"NULLs differ in {c}"
        xv, yv = x[~xn].to_numpy(), y[~yn].to_numpy()
        if xv.dtype.kind == "f" or yv.dtype.kind == "f":
            rtol = F32_AVG_RTOL if c in f32_avg else F64_RTOL
            np.testing.assert_allclose(yv.astype(np.float64),
                                       xv.astype(np.float64), rtol=rtol,
                                       atol=0, err_msg=c)
        else:
            assert x.dtype == y.dtype, (c, x.dtype, y.dtype)
            assert (xv == yv).all(), f"values differ in {c}:\n{a}\n--\n{b}"
