"""Executor data structures and small helpers (counterpart of
hdk_tpu/exec/common.py: ExecTable, the lazy scan columns, broadcasting and
the schema signature of compiled-step keys)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from .. import types as t
from ..ir import node as nd
from .masked import MaskedCol, nonzero_indices, torch_dtype


@dataclass
class ExecTable:
    """Device-side step result.

    ``nrows`` is the buffer capacity; ``row_mask`` (optional) marks live
    rows, so filters and dense group buffers need no compaction until a
    consumer wants dense rows.  ``_live`` caches the host-synced live
    count.  ``unique_sets``: uniqueness certificates, each a frozenset of
    column indices whose value tuple (NULL compared as a value) is
    distinct across live rows; a group-by output certifies its keys.
    """

    fields: List[str]
    types: List[t.Type]
    columns: List[MaskedCol]
    nrows: int
    row_mask: Optional[torch.Tensor] = None
    _live: Optional[int] = None
    unique_sets: tuple = ()

    def live_count(self) -> int:
        if self.row_mask is None:
            return self.nrows
        if self._live is None:
            self._live = int(self.row_mask.sum())  # host sync
        return self._live

    def compact(self) -> "ExecTable":
        """Dense copy with dead rows removed (one sync + gather)."""
        if self.row_mask is None:
            return self
        out = self.gather(nonzero_indices(self.row_mask, self.live_count()))
        out.unique_sets = self.unique_sets  # a row subset stays distinct
        return out

    def gather(self, idx: torch.Tensor) -> "ExecTable":
        cols = [MaskedCol(c.data[idx],
                          c.mask[idx] if c.mask is not None else None)
                for c in self.columns]
        return ExecTable(self.fields, self.types, cols, int(idx.shape[0]))

    @staticmethod
    def empty(fields: List[str], types: List[t.Type],
              device: torch.device) -> "ExecTable":
        cols = [
            MaskedCol(torch.zeros((0,), dtype=torch_dtype(ty.physical_dtype()),
                                  device=device),
                      torch.zeros((0,), dtype=torch.bool, device=device)
                      if ty.nullable else None)
            for ty in types
        ]
        return ExecTable(list(fields), list(types), cols, 0)


class _LazyScanColumns(list):
    """Scan columns moved to the device on first access: unused columns
    never transfer."""

    def __init__(self, table, fields, device: torch.device):
        super().__init__([None] * len(fields))
        self._table = table
        self._fields = fields
        self._device = device

    def __getitem__(self, i):
        got = super().__getitem__(i)
        if got is None and isinstance(i, int):
            data, mask = self._table.column(self._fields[i]).device_arrays(
                self._device)
            got = MaskedCol(data, mask)
            self[i] = got
        return got

    def __iter__(self):
        return (self[i] for i in range(len(self)))


# nodes that fuse into their consumer's step rather than execute alone
_CHAIN_NODES = (nd.Project, nd.Filter)


def _broadcast(col: MaskedCol, nrows: int) -> MaskedCol:
    if col.data.dim() == 0:
        return MaskedCol(col.data.expand(nrows),
                         col.mask.expand(nrows) if col.mask is not None
                         else None)
    return col


def _schema_sig(table: ExecTable) -> str:
    return ",".join(f"{ty}" for ty in table.types) + (
        "|masked" if table.row_mask is not None else "")
