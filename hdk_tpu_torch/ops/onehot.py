"""Segment reductions of the dense group-by (counterpart of
hdk_tpu/ops/onehot.py).

On the TPU these were factored one-hot contractions on the MXU, with 8-bit
limbs and row chunking to stay exact.  On Hopper a segment sum is a
histogram: ``seg_sums`` hands each column to the hand-written kernel for
its kind of slot (``kernels/hist.py``), which sums in int64 or float64 at
any row count and any segment count:

  =================  ================================
  slot               kernel
  =================  ================================
  ``ones_ids``       ``count_hist`` (reads gid alone)
  bool               ``groupby_sums2``
  other integer      ``seg_sums_exact``
  floating           ``groupby_sums``
  =================  ================================

Rows with ``gid`` outside [0, n) drop out of sums; MIN/MAX (``seg_min``,
``seg_max``) stay ``scatter_reduce_``, which the JAX package also computes
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import hist


def _group(columns: Sequence[torch.Tensor], skip) -> Dict[Tuple[str, torch.dtype], List[int]]:
    """Column indices by (kernel, dtype): one launch per group."""
    groups: Dict[Tuple[str, torch.dtype], List[int]] = {}
    for i, c in enumerate(columns):
        if i in skip:
            continue
        if c.dtype == torch.bool:
            kind = "bool"
        elif c.is_floating_point():
            kind = "float"
        else:
            kind = "int"
        groups.setdefault((kind, c.dtype), []).append(i)
    return groups


def seg_sums(columns: Sequence[torch.Tensor], gid: torch.Tensor, n: int,
             ones_ids: Sequence[int] = ()) -> List[torch.Tensor]:
    """Per-segment sums of several 1-D columns over int32 ``gid``.

    Returns one (n,) tensor per column: int64 for integer and bool
    inputs, float64 for floating ones.  ``ones_ids``: indices of columns
    the caller asserts are all ones (COUNT slots); their sums are the
    counts of gid and the column itself is never read."""
    gid = gid.contiguous()
    out: List[Optional[torch.Tensor]] = [None] * len(columns)
    if ones_ids:
        counts = hist.count_hist(gid, n)
        for i in ones_ids:
            out[i] = counts
    for (kind, _dtype), idx in _group(columns, set(ones_ids)).items():
        if kind == "float":  # K1 reads the columns where they lie
            sums = hist.groupby_sums(gid, [columns[i] for i in idx], n).t()
        else:
            # one column is a view, several are stacked (N, S) in one copy
            slots = (columns[idx[0]].reshape(-1, 1) if len(idx) == 1
                     else torch.stack([columns[i] for i in idx], dim=1))
            if kind == "bool":
                sums = hist.groupby_sums2(gid, slots, n).t()
            else:
                sums = hist.seg_sums_exact(gid, slots, n)
        for j, i in enumerate(idx):
            out[i] = sums[j]
    return out  # type: ignore[return-value]


def _seg_extreme(vals: torch.Tensor, gid: torch.Tensor, n: int,
                 ident: torch.Tensor, reduce: str) -> torch.Tensor:
    live = (gid >= 0) & (gid < n)
    idx = torch.where(live, gid, 0).to(torch.int64)
    src = torch.where(live, vals, ident)
    out = ident.expand(n).clone()
    return out.scatter_reduce_(0, idx, src, reduce, include_self=True)


def seg_min(vals: torch.Tensor, gid: torch.Tensor, n: int,
            ident: torch.Tensor) -> torch.Tensor:
    return _seg_extreme(vals, gid, n, ident, "amin")


def seg_max(vals: torch.Tensor, gid: torch.Tensor, n: int,
            ident: torch.Tensor) -> torch.Tensor:
    return _seg_extreme(vals, gid, n, ident, "amax")
