"""Distributed sort: sampled range partitioning, one exchange, a local
sort per shard (counterpart of hdk_tpu/parallel/dist_sort.py).

  1. each shard takes a regular sample of its leading sort key; an
     ``all_gather`` makes the global sample visible to every shard;
  2. its quantiles are the splitters (data-adaptive ranges, which absorb
     value skew);
  3. each row goes to the shard owning its range (equal leading keys
     share a destination, so later keys order within one shard), with
     the sort keys riding along, through the fixed-capacity send buffers
     and exchange of ``shuffle.py``;
  4. each shard sorts what it received by the full key list, dead rows
     last; the shards' live rows in shard order are the global ORDER BY
     order (ties keep their global row order: the exchange and the sort
     are stable).

Dead rows (filtered out, or shard padding) stay home.  A destination
that receives more rows than its slots counts an overflow: the caller
widens the slack and retries, and never returns a short result.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..exec.groupby import _orderable_int64
from ..exec.masked import MaskedCol
from ..ops import sortops as so
from ..utils import commlog
from . import shuffle as shf

_I64 = torch.iinfo(torch.int64)


def _sort_key(col: MaskedCol, desc: bool, nulls_first: bool) -> torch.Tensor:
    """Ascending int64 key: DESC flips the bits, a NULL takes the least
    or the greatest int64 by its NULLS FIRST / LAST placement."""
    kv = _orderable_int64(col.data)
    if desc:
        kv = ~kv
    if col.mask is not None:
        kv = torch.where(col.mask, kv, _I64.min if nulls_first else _I64.max)
    return kv


def _flatten(cols: Sequence[MaskedCol]
             ) -> Tuple[List[torch.Tensor], List[Tuple[int, Optional[int]]]]:
    flat: List[torch.Tensor] = []
    pos = []
    for c in cols:
        di = len(flat)
        flat.append(c.data)
        mi = None
        if c.mask is not None:
            mi = len(flat)
            flat.append(c.mask)
        pos.append((di, mi))
    return flat, pos


def dist_sort(mesh, sort_cols, descs: Sequence[bool],
              nulls_firsts: Sequence[bool], payload_cols,
              rows_per_shard: int, row_valid=None,
              sample_per_shard: int = 256, slack: float = 2.0):
    """Sharded input (lists of per-shard MaskedCols) -> range-partitioned,
    locally sorted shards gathered on the mesh's first device.  Returns
    (sorted payload columns, row validity, overflow): the valid rows in
    buffer order are the global order; ``num_shards * cap`` rows per
    column, cap = rows_per_shard * slack."""
    p = mesh.size
    cap = max(1, int(math.ceil(rows_per_shard * slack)))
    keys, valids, samples = [], [], []
    for s in range(p):
        ks = [_sort_key(c[s], d, nf)
              for c, d, nf in zip(sort_cols, descs, nulls_firsts)]
        lead = ks[0]
        n_loc = lead.shape[0]
        valid = (torch.ones((n_loc,), dtype=torch.bool, device=lead.device)
                 if row_valid is None else row_valid[s])
        local_sorted = torch.sort(torch.where(valid, lead, _I64.max)).values
        idx = torch.linspace(0, n_loc - 1, sample_per_shard,
                             dtype=torch.float64).to(torch.int64)
        samples.append(local_sorted[idx.to(lead.device)])
        keys.append(ks)
        valids.append(valid)
    all_samples = commlog.all_gather(samples)
    sends, bvalids, overflows, positions = [], [], [], None
    for s in range(p):
        everything = torch.sort(all_samples[s].reshape(-1)).values
        total = everything.shape[0]
        spl = everything[torch.arange(1, p, device=everything.device)
                         * total // p]
        dest = torch.searchsorted(spl, keys[s][0], right=True)
        flat, positions = _flatten([MaskedCol(k) for k in keys[s]]
                                   + [c[s] for c in payload_cols])
        bufs, bvalid, ovf = shf.build_send_buffers(dest, flat, valids[s],
                                                   p, cap)
        sends.append(bufs)
        bvalids.append(bvalid)
        overflows.append(ovf)
    recv, recv_valid = shf.exchange(sends, bvalids)
    nk = len(sort_cols)
    out_cols, out_valid = [], []
    for s in range(p):
        cols = [MaskedCol(recv[s][di], recv[s][mi] if mi is not None
                          else None) for di, mi in positions]
        rv = recv_valid[s]
        perm = so.lexsort([(~rv).to(torch.int8)]
                          + [c.data for c in cols[:nk]])
        out_cols.append([MaskedCol(c.data[perm], c.mask[perm]
                                   if c.mask is not None else None)
                         for c in cols[nk:]])
        out_valid.append(rv[perm])
    gathered = [mesh.gather_col([oc[j] for oc in out_cols])
                for j in range(len(payload_cols))]
    return (gathered, mesh.gather(out_valid),
            commlog.psum([o.to(torch.int64) for o in overflows])[0])
