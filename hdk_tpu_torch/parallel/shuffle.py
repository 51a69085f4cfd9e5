"""Hash-partition shuffle: rows exchanged by key between shards
(counterpart of hdk_tpu/parallel/shuffle.py).

Per shard, each row's destination comes from a 64-bit key hash; rows are
bucketed by destination into a fixed-capacity (P, cap) send buffer (a
stable sort by destination makes each destination's rows a run); one
``commlog.all_to_all`` per dtype exchanges the buffers, and the receiver
reads P * cap rows with a validity mask.  Rows past ``cap`` for one
destination are dropped and counted: the caller widens and retries, as
the JAX package's shard bodies do, so a shard body never needs a host
sync.  The hash is the JAX package's bit for bit: int64 two's
complement, with a logical shift right made from ``>>`` and a mask
(``>>`` is arithmetic in torch, and a sign-filled shift would send rows
to shards that do not exist).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..exec.groupby import _orderable_int64
from ..exec.join import _i64, _lsr, _mix64
from ..exec.masked import MaskedCol
from ..utils import commlog

# rows whose key is NULL hash to a fixed bucket (they still form a group)
_NULL_HASH = _i64(0x9E3779B97F4A7C15)


def key_hash(cols: Sequence[MaskedCol]) -> torch.Tensor:
    """One shard's combined 64-bit key hash (int64); NULL keys take a
    fixed hash, so all-NULL rows land on one shard and group there."""
    h = torch.full(cols[0].data.shape, 0x243F6A8885A308D3,
                   dtype=torch.int64, device=cols[0].data.device)
    for c in cols:
        k = _orderable_int64(c.data)
        if c.mask is not None:
            k = torch.where(c.mask, k, _NULL_HASH)
        h = _mix64(h ^ _mix64(k))
    return h


def bucket_for_shards(h: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Destination shard per row, from the high bits of the hash."""
    return (_lsr(h, 33) % num_shards).to(torch.int32)


def build_send_buffers(dest: torch.Tensor, payload: Sequence[torch.Tensor],
                       valid: torch.Tensor, num_shards: int, cap: int
                       ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                  torch.Tensor]:
    """One shard's rows bucketed into (num_shards, cap) send buffers.

    Returns (buffers, buffer validity, overflow count): rows past ``cap``
    for a destination are dropped and counted.  Trailing dimensions of a
    payload (sketch slots, (rows, C)) ride along.  A stable sort by
    destination puts each destination's rows in a run; slot (d, r) reads
    the run's r-th row, a gather (the JAX package scatters the rows into
    the slots, and every invalid row into one discard slot, which on the
    card serializes their stores)."""
    n = dest.shape[0]
    dev = dest.device
    if n == 0:
        return ([torch.zeros((num_shards, cap) + tuple(c.shape[1:]),
                             dtype=c.dtype, device=dev) for c in payload],
                torch.zeros((num_shards, cap), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    dest = torch.where(valid, dest.to(torch.int64), num_shards)
    sorted_dest, order = torch.sort(dest, stable=True)
    bounds = torch.searchsorted(sorted_dest, torch.arange(
        num_shards + 1, dtype=torch.int64, device=dev))
    counts = bounds[1:] - bounds[:-1]
    r = torch.arange(cap, dtype=torch.int64, device=dev)
    keep = r[None, :] < counts[:, None]
    src = order[torch.clamp(bounds[:-1, None] + r[None, :], max=n - 1)]
    bufs = []
    for col in payload:
        got = col[src]
        live = keep.reshape(keep.shape + (1,) * (got.dim() - 2))
        bufs.append(torch.where(live, got, torch.zeros((), dtype=col.dtype,
                                                       device=dev)))
    overflow = torch.clamp(counts - cap, min=0).sum()
    return bufs, keep, overflow


def exchange(bufs: Sequence[Sequence[torch.Tensor]],
             buf_valid: Sequence[torch.Tensor]
             ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
    """Exchange every shard's (P, cap, ...) buffers and flatten them to
    (P * cap, ...) received rows with their validity.  ``bufs[s]`` is
    shard s's list of buffers.  Buffers of one dtype go in one
    ``all_to_all`` (packed along a trailing axis), as in the JAX
    package.  The send buffers are released as they are packed: the
    caller's lists are emptied."""
    p = len(buf_valid)
    allb = [list(b) + [v] for b, v in zip(bufs, buf_valid)]
    for b in bufs:
        b.clear()
    shapes = [(b.dtype, tuple(b.shape)) for b in allb[0]]
    by_dtype: dict = {}
    for i, (dt, _shape) in enumerate(shapes):
        by_dtype.setdefault(dt, []).append(i)
    results: List[List[Optional[torch.Tensor]]] = [[None] * len(shapes)
                                                   for _ in range(p)]
    for idx in by_dtype.values():
        packed = []
        for s in range(p):
            cs = [allb[s][i].reshape(shapes[i][1][0], shapes[i][1][1], -1)
                  for i in idx]
            packed.append(torch.cat(cs, dim=2) if len(cs) > 1 else cs[0])
            for i in idx:
                allb[s][i] = None
            del cs
        recv = commlog.all_to_all(packed)
        del packed
        for s in range(p):
            off = 0
            for i in idx:
                shape = shapes[i][1]
                w = int(math.prod(shape[2:]))
                r = recv[s][:, :, off:off + w]
                off += w
                results[s][i] = r.reshape((-1,) + shape[2:])
        del recv
    out = [[r for r in res[:-1]] for res in results]
    return out, [res[-1] for res in results]


def shuffle_rows(key_cols: Sequence[Sequence[MaskedCol]],
                 payload_cols: Sequence[Sequence[MaskedCol]],
                 num_shards: int, cap: int,
                 row_valid: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> Tuple[List[List[MaskedCol]], List[torch.Tensor],
                            List[torch.Tensor]]:
    """Rows of (keys ++ payload) to their key-owner shards.

    ``key_cols[s]`` and ``payload_cols[s]`` are shard s's columns; rows
    whose ``row_valid`` is False stay home.  Returns, per shard, the
    received columns (keys ++ payload, P * cap rows), their validity and
    the shard's overflow count."""
    sends, valids, overflows, positions = [], [], [], None
    for s in range(num_shards):
        cols = list(key_cols[s]) + list(payload_cols[s])
        dest = bucket_for_shards(key_hash(key_cols[s]), num_shards)
        rv = row_valid[s] if row_valid is not None else None
        valid = (torch.ones(dest.shape, dtype=torch.bool, device=dest.device)
                 if rv is None else rv)
        payload: List[torch.Tensor] = []
        pos = []
        for c in cols:
            di = len(payload)
            payload.append(c.data)
            mi = None
            if c.mask is not None:
                mi = len(payload)
                payload.append(c.mask)
            pos.append((di, mi))
        positions = pos
        bufs, bvalid, ovf = build_send_buffers(dest, payload, valid,
                                               num_shards, cap)
        sends.append(bufs)
        valids.append(bvalid)
        overflows.append(ovf)
    recv, recv_valid = exchange(sends, valids)
    out = [[MaskedCol(r[di], r[mi] if mi is not None else None)
            for di, mi in positions] for r in recv]
    return out, recv_valid, overflows
