"""Twin sessions: the same numpy data in hdk_tpu and hdk_tpu_torch.

For a database the ingested tables and their string dictionaries play the
part of a model's weights: both packages ingest one numpy dict through
``import_pydict``, and ``twin_sessions`` asserts that they hold the same
columns, dictionary codes and fragment stats before any query runs.
Results compare with ``assert_same``, which reads NULLs from the Arrow
validity bitmaps: in a pandas frame a NULL float and a NaN look alike.
"""

from __future__ import annotations

from dataclasses import astuple
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import pandas as pd
import pyarrow as pa

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
                assert _same_stats(astuple(a.stats(ca.info.name, frag)),
                                   astuple(b.stats(cb.info.name, frag))), \
                    ca.info.name


def _same_stats(a: tuple, b: tuple) -> bool:
    """Equal fragment stats, a NaN min or max (a column holding NaN)
    equal to a NaN."""
    return len(a) == len(b) and all(
        x == y or (isinstance(x, float) and isinstance(y, float)
                   and np.isnan(x) and np.isnan(y)) for x, y in zip(a, b))


def _list_rows(col) -> np.ndarray:
    """A list column as an object array of numpy arrays, one per row (the
    row's elements; a NULL row holds none)."""
    arr = col.combine_chunks()
    flat = arr.flatten().to_numpy(zero_copy_only=False)
    offsets = arr.offsets.to_numpy()
    rows = np.empty(len(arr), dtype=object)
    for i in range(len(arr)):
        rows[i] = flat[offsets[i]:offsets[i + 1]]
    return rows


def _columns(res) -> Dict[str, tuple]:
    """Per column of a result: (values, NULL flags, pandas dtype).  The
    flags are the Arrow validity bitmap's; numbers keep their Arrow type
    (NULLs filled with 0), so integers compare exactly; a list column
    gives each row's elements (dtype "list"); strings and timestamps come
    as pandas reads them.  Row order: the result's."""
    table = res.to_arrow()
    frame = table.to_pandas()
    out = {}
    for name, col in zip(table.column_names, table.columns):
        nulls = col.is_null().to_numpy()
        if pa.types.is_list(col.type):
            out[name] = (_list_rows(col), nulls, "list")
            continue
        if (pa.types.is_integer(col.type) or pa.types.is_floating(col.type)
                or pa.types.is_boolean(col.type)):
            fill = False if pa.types.is_boolean(col.type) else 0
            values = col.fill_null(fill).to_numpy()
        else:
            values = frame[name].to_numpy()
        out[name] = (values, nulls, frame[name].dtype)
    return out


def _canonical_order(cols: Dict[str, tuple]) -> np.ndarray:
    """Row order of ``canon`` over the values and the NULL flags."""
    frame = pd.DataFrame({**{f"v{i}": (v if d != "list" else
                                       [repr(r.tolist()) for r in v])
                             for i, (v, _, d) in enumerate(cols.values())},
                          **{f"n{i}": n for i, (_, n, _) in
                             enumerate(cols.values())}})
    frame["row"] = np.arange(len(frame))
    return canon(frame)["row"].to_numpy()


def assert_same(res_jax, res_torch, ordered: bool = True,
                f32_avg: Sequence[str] = ()) -> None:
    """Equal results, column by column: the NULL positions (Arrow
    validity), then among the valid float values the NaN positions, then
    the values: keys, counts and integers exactly, floats to ``F64_RTOL``
    (``F32_AVG_RTOL`` for the columns named in ``f32_avg``).  A list
    column compares each row's element count (which elements are valid:
    NULL elements are left out of a list) before its elements, as
    above."""
    a = _columns(res_jax)
    b = _columns(res_torch)
    assert list(a) == list(b)
    rows_a = len(next(iter(a.values()))[0]) if a else 0
    rows_b = len(next(iter(b.values()))[0]) if b else 0
    assert rows_a == rows_b, (rows_a, rows_b)
    if not ordered:
        pa_, pb = _canonical_order(a), _canonical_order(b)
        a = {c: (v[pa_], n[pa_], d) for c, (v, n, d) in a.items()}
        b = {c: (v[pb], n[pb], d) for c, (v, n, d) in b.items()}
    for c in a:
        (x, xn, xd), (y, yn, yd) = a[c], b[c]
        assert (xn == yn).all(), f"NULLs differ in {c}: {xn} vs {yn}"
        xv, yv = x[~xn], y[~yn]
        if xd == "list" or yd == "list":
            assert xd == yd, (c, xd, yd)
            xl = np.asarray([len(r) for r in xv], dtype=np.int64)
            yl = np.asarray([len(r) for r in yv], dtype=np.int64)
            assert (xl == yl).all(), \
                f"element validity differs in {c}: {xl} vs {yl}"
            if not xl.sum():
                continue
            xv, yv = np.concatenate(list(xv)), np.concatenate(list(yv))
            xd, yd = xv.dtype, yv.dtype
        if xv.dtype.kind == "f" or yv.dtype.kind == "f":
            xv, yv = xv.astype(np.float64), yv.astype(np.float64)
            xnan, ynan = np.isnan(xv), np.isnan(yv)
            assert (xnan == ynan).all(), \
                f"NaNs differ in {c}: {xv} vs {yv}"
            rtol = F32_AVG_RTOL if c in f32_avg else F64_RTOL
            np.testing.assert_allclose(yv[~ynan], xv[~xnan], rtol=rtol,
                                       atol=0, err_msg=c)
        else:
            assert xd == yd, (c, xd, yd)
            assert (xv == yv).all(), f"values differ in {c}:\n{xv}\n--\n{yv}"
