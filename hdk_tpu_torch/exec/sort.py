"""ORDER BY / LIMIT (counterpart of hdk_tpu/exec/sort.py).

Every ordering is a stable lexicographic sort: repeated stable
``torch.sort`` from the last key to the first, so ties keep row order.
That also makes top-n exact and row-for-row equal to the JAX package,
whose ``lax.top_k`` puts the lower index first on ties (``torch.topk``
promises no tie order on the card).  Keys are int64 views of the values
(``sort_keys_int64``): DESC flips the bits; a nullable column adds a
null-flag key in front of its values, so NULLs never collide with extreme
values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .groupby import _orderable_int64
from .masked import MaskedCol


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``keys[0]``, then ``keys[1]``,
    ..., then row id."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(list(keys)):
        _, order = torch.sort(k[perm], stable=True)
        perm = perm[order]
    return perm


def sort_keys_int64(cols: Sequence[MaskedCol], descs: Sequence[bool],
                    nulls_first: Sequence[bool]) -> List[torch.Tensor]:
    """Ascending int64 keys for a lexicographic sort: per column an
    optional null flag (0 sorts first) and the orderable value."""
    keys = []
    for col, desc, nf in zip(cols, descs, nulls_first):
        key = _orderable_int64(col.data)
        if desc:
            key = ~key
        if col.mask is not None:
            keys.append((col.mask if nf else ~col.mask).to(torch.int8))
        keys.append(key)
    return keys


def lex_topn(keys64: Sequence[torch.Tensor], topn: int,
             rm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first ``topn`` live rows in ascending key order, ties by row
    id; dead rows, if fewer than ``topn`` are live, fill the tail (the
    caller masks them with its validity window)."""
    keys = list(keys64) if rm is None else [(~rm).to(torch.int8), *keys64]
    return lexsort(keys)[:topn]


def apply_limit(perm: torch.Tensor, limit: Optional[int],
                offset: int) -> torch.Tensor:
    """Slice a permutation by LIMIT/OFFSET."""
    n = perm.shape[0]
    start = min(offset, n)
    end = n if limit is None else min(start + limit, n)
    return perm[start:end]
