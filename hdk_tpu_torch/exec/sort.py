"""ORDER BY / LIMIT (counterpart of hdk_tpu/exec/sort.py).

Keys are int64 views of the values (``sort_keys_int64``): DESC flips the
bits; a nullable column adds a null-flag key in front of its values, so
NULLs never collide with extreme values.  Two routes give the same rows:

* ``full_topn``: a stable lexicographic sort of every row
  (``ops/sortops.lexsort``: repeated stable ``torch.sort`` from the last
  key to the first), so ties keep row order;
* ``lex_topn``: the streaming top-n for ``ORDER BY ... LIMIT n`` with a
  small n (``exec.streaming_topn_max``): K+2 linear candidate passes
  (liveness, each key by ``torch.topk``, the row id) collect at most
  (K+2)·n rows, and only those are sorted.

``streaming_topn`` is the gate between them, the JAX package's
(hdk_tpu/exec/executor.py:651-670).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.sortops import lexsort
from .groupby import _orderable_int64
from .masked import MaskedCol


def sort_keys_int64(cols: Sequence[MaskedCol], descs: Sequence[bool],
                    nulls_first: Sequence[bool]) -> List[torch.Tensor]:
    """Ascending int64 keys for a lexicographic sort: per column an
    optional null flag (0 sorts first) and the orderable value, 0 under a
    NULL, so NULLs tie and the later keys order them (the JAX package
    pins them to one sentinel)."""
    keys = []
    for col, desc, nf in zip(cols, descs, nulls_first):
        key = _orderable_int64(col.data)
        if desc:
            key = ~key
        if col.mask is not None:
            keys.append((col.mask if nf else ~col.mask).to(torch.int8))
            key = torch.where(col.mask, key, 0)
        keys.append(key)
    return keys


def streaming_topn(topn: int, rows: int, knob: int) -> bool:
    """Whether the first ``topn`` of ``rows`` rows take the streaming
    top-n (``lex_topn``) rather than the full sort: a LIMIT window of
    ``0 < topn <= knob`` (``exec.streaming_topn_max``) rows short of the
    whole input."""
    return 0 < topn <= knob and topn < rows


def full_topn(keys64: Sequence[torch.Tensor], topn: int,
              rm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first ``topn`` rows of a full stable lexsort: live rows in
    ascending key order, ties by row id; dead rows, if fewer than
    ``topn`` are live, fill the tail (the caller masks them with its
    validity window)."""
    keys = list(keys64) if rm is None else [(~rm).to(torch.int8), *keys64]
    return lexsort(keys)[:topn]


def lex_topn(keys64: Sequence[torch.Tensor], topn: int,
             rm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming top-n: the rows of ``full_topn`` for ``0 < topn <=
    rows``, without sorting every row.

    One candidate pass per level: liveness (when ``rm`` is given), each
    key, then the row id.  Pass j looks only at the rows tied with the
    running boundary on every earlier level (the others take the level's
    largest value, a sentinel) and takes the ``topn`` smallest values by
    ``torch.topk``; the boundary is the largest value it took, and the
    rows whose (unmasked) value equals it stay tied for the next level.
    Every row of the answer is a candidate: at its first level where it
    is strictly below the boundary it is among that pass's ``topn``
    smallest, whichever of its equals ``torch.topk`` picks (it promises
    no order among ties on the card, and none is needed); a row tied
    with the boundary goes on to the next level; and a row strictly
    above a boundary has ``topn`` rows ahead of it.  Row ids are
    distinct, so the last pass settles the rows tied on every key,
    smallest id first, as the stable sort does (``torch.nonzero`` lists
    the tied rows in row order: its first ``topn`` are that level's
    top-k).  A sentinel equal to a real value changes nothing: such a
    real row stays tied and goes on.  The candidates (at most (K+2)·topn rows, ``torch.unique`` sorts them
    by row id) then take one stable lexsort, dead rows last."""
    cand = []
    tie = rm
    if rm is not None:
        # liveness: when fewer than topn rows live, this takes them all
        cand.append(torch.topk(rm.to(torch.int8), topn, sorted=False)
                    .indices)
    for k in keys64:
        kj = k if tie is None else torch.where(
            tie, k, torch.iinfo(k.dtype).max)
        vals, idx = torch.topk(kj, topn, largest=False, sorted=False)
        cand.append(idx)
        tied = k == vals.max()
        tie = tied if tie is None else tie & tied
    # the row-id level: the first topn tied rows in row order, the top-k
    # of the row id without the radix passes over every row
    cand.append(torch.nonzero(tie).flatten()[:topn])
    ids = torch.unique(torch.cat(cand))
    keys = [k[ids] for k in keys64]
    if rm is not None:
        keys = [(~rm[ids]).to(torch.int8), *keys]
    return ids[lexsort(keys)[:topn]]


def apply_limit(perm: torch.Tensor, limit: Optional[int],
                offset: int) -> torch.Tensor:
    """Slice a permutation by LIMIT/OFFSET."""
    n = perm.shape[0]
    start = min(offset, n)
    end = n if limit is None else min(start + limit, n)
    return perm[start:end]
