"""Sort and span primitives of the sort-based group-by (counterpart of
hdk_tpu/ops/sortops.py).

The TPU package moved payload columns inside one variadic ``lax.sort``
because a random gather through HBM cost it more than the sort.  On
Hopper a gather is cheap, so ``sort_with_payload`` is a stable
lexicographic sort of the keys (``lexsort``: repeated stable
``torch.sort``, last key first) followed by one ``payload[perm]`` gather
per distinct payload tensor.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``keys[0]``, then ``keys[1]``,
    ..., then row id."""
    n = keys[0].shape[0]
    if len(keys) == 1:
        return torch.sort(keys[0], stable=True).indices
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(list(keys)):
        _, order = torch.sort(k[perm], stable=True)
        perm = perm[order]
    return perm


def sort_with_payload(key_arrays: Sequence[torch.Tensor],
                      payloads: Sequence[torch.Tensor]
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 torch.Tensor]:
    """Lexicographic stable sort by ``key_arrays`` (first is major).
    Returns (sorted keys, sorted payloads, the permutation)."""
    if len(key_arrays) == 1:
        sorted0, perm = torch.sort(key_arrays[0], stable=True)
        sorted_keys = [sorted0]
    else:
        perm = lexsort(key_arrays)
        sorted_keys = [k[perm] for k in key_arrays]
    return sorted_keys, [p[perm] for p in payloads], perm


def changed(sorted_arr: torch.Tensor) -> torch.Tensor:
    """Boundary bitmap of a sorted array: True where a new run starts."""
    out = torch.ones(sorted_arr.shape, dtype=torch.bool,
                     device=sorted_arr.device)
    out[1:] = sorted_arr[1:] != sorted_arr[:-1]
    return out


def span_bounds(boundary: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the first and the last position (both inclusive, int64)
    of the run it lies in, from the run-start bitmap of sorted rows
    (counterpart of hdk_tpu's ``boundary_spans``, which compacts the
    run starts with a bool sort).  ``runs`` counts the run starts up to
    each row, so it is non-decreasing and a run's rows share its value:
    the run's first row is the first position holding that value and its
    last row the last one, two binary searches per row (sorted queries,
    so neighbouring searches share their path).  No sort, no host sync.
    (``torch.cummax`` over the starts' positions gives the first row too,
    but on a CUDA tensor of one dimension it scans in one block: 290 ms
    a call at 100M rows on an H100, PERF.md §6.)"""
    runs = torch.cumsum(boundary, 0)
    return (torch.searchsorted(runs, runs),
            torch.searchsorted(runs, runs, right=True) - 1)


class PayloadSet:
    """Deduplicating payload registry for ``sort_with_payload``: the same
    tensor registered twice is gathered once."""

    def __init__(self) -> None:
        self.arrays: List[torch.Tensor] = []
        self._pos = {}

    def add(self, arr: Optional[torch.Tensor]) -> Optional[int]:
        if arr is None:
            return None
        got = self._pos.get(id(arr))
        if got is None:
            got = len(self.arrays)
            self._pos[id(arr)] = got
            self.arrays.append(arr)
        return got
