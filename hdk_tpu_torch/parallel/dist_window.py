"""Distributed window functions: rows shuffle to the owner of their
partition key, the local window engine runs there, and the results go
back to the rows' home positions (counterpart of
hdk_tpu/parallel/dist_window.py).

  1. every row is tagged with its global position
     (global shard * rows_per_shard + local index);
  2. one hash shuffle by the PARTITION BY keys sends each partition
     whole to one shard (cap = rows_per_shard * slack; an overflow is
     reported and the caller widens and retries);
  3. the owner runs ``exec/window.compute_window`` over what it received
     (padding and filter-dead rows ride the row mask);
  4. the values go back by global position (cap = rows_per_shard is
     exact: no sender holds more of one shard's rows than it has) and
     land at their local offsets.

A window without PARTITION BY would put every row on one shard: the
caller keeps it on the gathered (single-device) route.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..exec.masked import MaskedCol
from ..exec.window import compute_window
from ..utils import commlog
from . import shuffle as shf


def dist_window(mesh, kind, args, part_cols, order_cols,
                order_desc: Sequence[bool], arg1, rows_per_shard: int,
                row_mask, out_dtype: torch.dtype, frame=None,
                slack: float = 2.0):
    """Sharded inputs (lists of per-shard MaskedCols; ``row_mask`` a list
    of tensors or None) -> (the window's values in the original row
    order, gathered on the mesh's first device; overflow).  A nonzero
    overflow means the values are not valid."""
    if not part_cols:
        raise ValueError("dist_window needs partition keys")
    p = mesh.size
    cap = max(1, int(math.ceil(rows_per_shard * slack)))
    nargs, nparts = len(args), len(part_cols)
    keys, payload = [], []
    for s in range(mesh.local_size):
        pp = [c[s] for c in part_cols]
        dev = pp[0].data.device
        gpos = ((mesh.first + s) * rows_per_shard
                + torch.arange(rows_per_shard, dtype=torch.int64, device=dev))
        # dead rows still need their slot back: every row ships, its row
        # mask riding along
        rm = (torch.ones((rows_per_shard,), dtype=torch.bool, device=dev)
              if row_mask is None else row_mask[s])
        keys.append(pp)
        payload.append([c[s] for c in args] + [c[s] for c in order_cols]
                       + [MaskedCol(rm), MaskedCol(gpos)])
    cols, recv_valid, overflow = shf.shuffle_rows(keys, payload, p, cap)
    sends, bvalids = [], []
    has_mask = None
    for s in range(mesh.local_size):
        c = cols[s]
        rpp = c[:nparts]
        raa = c[nparts:nparts + nargs]
        roo = c[nparts + nargs:-2]
        r_rm, r_pos = c[-2].data, c[-1].data
        val = compute_window(kind, raa, rpp, roo, order_desc, arg1,
                             r_pos.shape[0], recv_valid[s] & r_rm,
                             out_dtype, frame=frame)
        has_mask = val.mask is not None
        back = [val.data, r_pos] + ([val.mask] if has_mask else [])
        dest = torch.div(r_pos, rows_per_shard, rounding_mode="floor")
        bufs, bvalid, _ovf = shf.build_send_buffers(
            dest, back, recv_valid[s], p, rows_per_shard)
        sends.append(bufs)
        bvalids.append(bvalid)
    recv2, recv2_valid = shf.exchange(sends, bvalids)
    datas, masks = [], []
    for s in range(mesh.local_size):
        vdata, vpos = recv2[s][0], recv2[s][1]
        # invalid slots land past the end, each on a slot of its own (one
        # shared discard slot would serialize their stores on the card)
        nslots = vpos.shape[0]
        off = torch.where(recv2_valid[s], vpos % rows_per_shard,
                          rows_per_shard + torch.arange(
                              nslots, device=vpos.device))
        out = torch.zeros((rows_per_shard + nslots,)
                          + tuple(vdata.shape[1:]), dtype=vdata.dtype,
                          device=vdata.device)
        out[off] = vdata
        datas.append(out[:rows_per_shard])
        if has_mask:
            m = torch.zeros((rows_per_shard + nslots,), dtype=torch.bool,
                            device=vdata.device)
            m[off] = recv2[s][2]
            masks.append(m[:rows_per_shard])
    col = MaskedCol(mesh.gather(datas),
                    mesh.gather(masks) if has_mask else None)
    return col, commlog.psum([o.to(torch.int64) for o in overflow])[0]
