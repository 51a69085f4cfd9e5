"""Result materialization: ExecTable -> Arrow / pandas / numpy / storage
Table (counterpart of hdk_tpu/exec/materialize.py).

Step results are columnar device tensors, so conversion is a copy to the
host plus logical-type reconstruction.  Arrow and pandas are optional:
``to_numpy`` needs neither.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import types as t
from ..storage.dictionary import NULL_CODE, DictionaryRegistry
from ..storage.table import Column, ColumnInfo, Table
from .common import ExecTable
from .masked import MaskedCol

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - optional outside the tests
    pa = None


def _host(col: MaskedCol):
    data = col.data.cpu().numpy()
    mask = col.mask.cpu().numpy() if col.mask is not None else None
    return data, mask


def _arrow_array(typ: t.Type, data: np.ndarray, mask: Optional[np.ndarray],
                 dicts: DictionaryRegistry):
    arrow_mask = None if mask is None else ~mask  # arrow wants null flags
    if typ.is_dict_encoded_string():
        d = dicts.get(typ.dict_id)  # type: ignore[attr-defined]
        safe = (np.where(data == NULL_CODE, 0, data) if mask is None
                else np.where(mask, data, 0))
        dictionary = pa.array(d.all_strings() or [""], type=pa.string())
        null_mask = (data == NULL_CODE) if mask is None else ~mask
        indices = pa.array(
            np.clip(safe, 0, max(len(d) - 1, 0)).astype(np.int32),
            mask=null_mask)
        return pa.DictionaryArray.from_arrays(indices, dictionary)
    if typ.is_decimal():
        from decimal import Decimal

        scale = typ.scale  # type: ignore[attr-defined]
        scaled = [None if (mask is not None and not mask[i])
                  else Decimal(int(v)).scaleb(-scale)
                  for i, v in enumerate(data)]
        return pa.array(scaled, type=pa.decimal128(typ.precision, scale))  # type: ignore[attr-defined]
    if typ.is_date():
        if typ.unit == t.TimeUnit.DAY:  # type: ignore[attr-defined]
            return pa.array(data.astype(np.int32), type=pa.date32(),
                            mask=arrow_mask)
        return pa.array(data.astype(np.int64) * 1000, type=pa.date64(),
                        mask=arrow_mask)
    if typ.is_timestamp():
        return pa.array(data.astype(np.int64),
                        type=pa.timestamp(typ.unit.value), mask=arrow_mask)  # type: ignore[attr-defined]
    if typ.is_time():
        unit = typ.unit  # type: ignore[attr-defined]
        if unit in (t.TimeUnit.SECOND, t.TimeUnit.MILLI):
            scale = 1000 if unit == t.TimeUnit.SECOND else 1
            return pa.array((data.astype(np.int64) * scale).astype(np.int32),
                            type=pa.time32("ms"), mask=arrow_mask)
        return pa.array(data.astype(np.int64), type=pa.time64(unit.value),
                        mask=arrow_mask)
    if typ.is_interval():
        return pa.array(data.astype(np.int64), type=pa.int64(),
                        mask=arrow_mask)
    return pa.array(data, mask=arrow_mask)


def to_arrow(table: ExecTable, dicts: DictionaryRegistry) -> "pa.Table":
    if pa is None:
        raise RuntimeError("to_arrow needs pyarrow; to_numpy does not")
    arrays = []
    for typ, col in zip(table.types, table.columns):
        data, mask = _host(col)
        arrays.append(_arrow_array(typ, data, mask, dicts))
    return pa.table(arrays, names=table.fields)


def to_pandas(table: ExecTable, dicts: DictionaryRegistry):
    return to_arrow(table, dicts).to_pandas()


def to_numpy(table: ExecTable, dicts: DictionaryRegistry
             ) -> Dict[str, np.ndarray]:
    """Column name -> host array in the column's physical dtype, or a
    ``numpy.ma.MaskedArray`` where the column has NULLs; dictionary
    strings decode to object arrays of str."""
    out = {}
    for name, typ, col in zip(table.fields, table.types, table.columns):
        data, mask = _host(col)
        if typ.is_dict_encoded_string():
            strings = np.asarray(
                dicts.get(typ.dict_id).all_strings() or [""], dtype=object)  # type: ignore[attr-defined]
            if mask is None:
                mask = data != NULL_CODE
            data = strings[np.clip(data, 0, len(strings) - 1)]
        out[name] = data if mask is None else np.ma.MaskedArray(data, ~mask)
    return out


def to_storage_table(table: ExecTable, table_id: int, name: str,
                     fragment_size: int) -> Table:
    """A result as a queryable host table (``res.scan`` chaining)."""
    cols = []
    for i, (fname, typ, col) in enumerate(
            zip(table.fields, table.types, table.columns)):
        data, mask = _host(col)
        cols.append(Column(ColumnInfo(table_id, i, fname, typ), data, mask))
    if not cols:
        cols = [Column(ColumnInfo(table_id, 0, "dummy", t.int64(False)),
                       np.zeros(table.nrows, np.int64))]
    return Table(table_id, name, cols, fragment_size)
