"""Distributed equi-joins over a mesh (counterpart of
hdk_tpu/parallel/dist_join.py).  Two strategies, chosen by the build
side's size (``exec/cost.dist_join_strategy``):

  * **broadcast**: the build side is replicated; each shard probes its
    own probe rows against the sorted-hash table (one table per device:
    shards that share a card share it).  Probe rows never move.
  * **partitioned**: both sides shuffle by key hash so matching keys
    meet on one shard, which joins its partition locally.

A shard's join is sync-free: sorted-hash build, binary-search probe and
the capped pair expansion (``exec/join.expand_pairs_capped``, A2d).  The
caller sizes the capacities exactly from counting passes first (the
count-then-fill shape); any overflow is reported, never a short result.
Sharded inputs are lists of per-shard MaskedCols, as in
``dist_groupby``; outputs are gathered on the mesh's first device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..exec import join as jn
from ..exec.masked import MaskedCol, combine_masks
from ..ir.node import JoinType
from ..utils import commlog
from . import shuffle as shf


def _mask_first(keys: Sequence[MaskedCol], valid) -> List[MaskedCol]:
    """Row validity folded into the first key's mask: dead rows hash and
    verify as NULL keys, which never match."""
    if valid is None:
        return list(keys)
    out = list(keys)
    out[0] = MaskedCol(out[0].data, combine_masks(out[0].mask, valid))
    return out


def _take(c: MaskedCol, idx: torch.Tensor) -> MaskedCol:
    return MaskedCol(c.data[idx], c.mask[idx] if c.mask is not None
                     else None)


def _local_join(build_cols, build_keys, build_valid, probe_cols, probe_keys,
                probe_valid, join_type: JoinType, pair_cap: int,
                table: Optional[jn.BuildTable] = None):
    """One shard's join.  Returns (out_cols, out_mask, overflow):
    INNER/LEFT give lhs ++ rhs columns, SEMI/ANTI None (the caller keeps
    the probe columns under ``out_mask``)."""
    bk = _mask_first(build_keys, build_valid)
    pk = _mask_first(probe_keys, probe_valid)
    if table is None:
        table = jn.build(bk)
    lo, hi = jn.probe_ranges(table, pk)
    l_idx, r_idx, live, total = jn.expand_pairs_capped(table, lo, hi,
                                                       pair_cap)
    ok = live & jn.verify_pairs(bk, pk, l_idx, r_idx)
    overflow = torch.clamp(total - pair_cap, min=0)
    if join_type == JoinType.INNER:
        out = ([_take(c, l_idx) for c in probe_cols]
               + [_take(c, r_idx) for c in build_cols])
        return out, ok, overflow
    n_probe = pk[0].data.shape[0]
    dev = ok.device
    # every verified pair sets its probe row (a store of one value: no
    # atomics), the others a discard slot each (stores to one shared slot
    # would serialize on the card)
    matched = torch.zeros((n_probe + pair_cap,), dtype=torch.bool,
                          device=dev)
    matched[torch.where(ok, l_idx, n_probe + torch.arange(
        pair_cap, device=dev))] = True
    matched = matched[:n_probe]
    probe_live = (torch.ones((n_probe,), dtype=torch.bool, device=dev)
                  if probe_valid is None else probe_valid)
    if join_type == JoinType.SEMI:
        return None, matched & probe_live, overflow
    if join_type == JoinType.ANTI:
        return None, ~matched & probe_live, overflow
    # LEFT: verified pairs ++ the unmatched live probe rows, rhs NULL
    lcols = [MaskedCol(torch.cat([c.data[l_idx], c.data]),
                       torch.cat([c.mask[l_idx], c.mask])
                       if c.mask is not None else None)
             for c in probe_cols]
    rcols = []
    for c in build_cols:
        data = torch.cat([c.data[r_idx],
                          torch.zeros((n_probe,) + tuple(c.data.shape[1:]),
                                      dtype=c.data.dtype, device=dev)])
        mm = ok if c.mask is None else (ok & c.mask[r_idx])
        rcols.append(MaskedCol(data, torch.cat([
            mm, torch.zeros((n_probe,), dtype=torch.bool, device=dev)])))
    out_mask = torch.cat([ok, probe_live & ~matched])
    return lcols + rcols, out_mask, overflow


def _replicas(mesh, cols: Sequence[MaskedCol]) -> List[List[MaskedCol]]:
    """A replicated side: its columns on every shard's device."""
    def on(c, d):
        if c is None or c.data.device == d:
            return c
        return MaskedCol(c.data.to(d), None if c.mask is None
                         else c.mask.to(d))

    return [[on(c, d) for c in cols] for d in mesh.devices]


def _tables_by_device(mesh, build_keys) -> List[jn.BuildTable]:
    """One sorted-hash table per distinct device, shared by its shards."""
    per_dev = {}
    out = []
    for d, bk in zip(mesh.devices, _replicas(mesh, build_keys)):
        if d not in per_dev:
            per_dev[d] = jn.build(bk)
        out.append(per_dev[d])
    return out


def _gather_out(mesh, outs, masks, ovs):
    ov = commlog.psum(ovs)[0]
    mask = mesh.gather(masks)
    if outs[0] is None:
        return None, mask, ov
    cols = [mesh.gather_col([o[j] for o in outs])
            for j in range(len(outs[0]))]
    return cols, mask, ov


# -- broadcast -------------------------------------------------------------

def count_candidates_broadcast(mesh, probe_keys, probe_valid, build_keys
                               ) -> torch.Tensor:
    """Per-shard candidate totals, (shards,): the count pass that sizes
    the join's pair capacity exactly."""
    tables = _tables_by_device(mesh, build_keys)
    totals = []
    for s in range(mesh.size):
        lo, hi = jn.probe_ranges(tables[s], _mask_first(
            [k[s] for k in probe_keys],
            None if probe_valid is None else probe_valid[s]))
        totals.append((hi - lo).sum().to(mesh.device))
    return torch.stack(totals)


def dist_join_broadcast(mesh, probe_cols, probe_keys, probe_valid,
                        build_cols, build_keys, join_type: JoinType,
                        pair_cap: int):
    """Probe side sharded, build side replicated.  Returns (out_cols,
    out_mask, overflow); SEMI/ANTI give out_cols None and the keep mask
    over the probe rows."""
    tables = _tables_by_device(mesh, build_keys)
    bcols = _replicas(mesh, build_cols)
    bkeys = _replicas(mesh, build_keys)
    outs, masks, ovs = [], [], []
    for s in range(mesh.size):
        out, mask, ov = _local_join(
            bcols[s], bkeys[s], None, [c[s] for c in probe_cols],
            [k[s] for k in probe_keys],
            None if probe_valid is None else probe_valid[s], join_type,
            pair_cap, table=tables[s])
        outs.append(out)
        masks.append(mask)
        ovs.append(ov)
    return _gather_out(mesh, outs, masks, ovs)


# -- partitioned -----------------------------------------------------------

def partition_histograms(mesh, probe_keys, probe_valid, build_keys,
                         build_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows bound for each shard, (shards,) per side, summed over the
    sources: sizes the shuffle buffers so they cannot overflow."""
    p = mesh.size

    def hist(keys, valid):
        per = []
        for s in range(p):
            dest = shf.bucket_for_shards(
                shf.key_hash([k[s] for k in keys]), p).to(torch.int64)
            if valid is not None:
                dest = torch.where(valid[s], dest, p)
            # one reduction per shard (a histogram of a few bins
            # serializes its atomics on the card)
            per.append(torch.stack([(dest == d).sum() for d in range(p)]))
        return commlog.psum(per)[0]

    return hist(probe_keys, probe_valid), hist(build_keys, build_valid)


def _shuffle_side(mesh, keys, cols, valid, cap):
    p = mesh.size
    return shf.shuffle_rows([[k[s] for k in keys] for s in range(p)],
                            [[c[s] for c in cols] for s in range(p)],
                            p, cap, row_valid=valid)


def count_candidates_partitioned(mesh, probe_keys, probe_valid, build_keys,
                                 build_valid, probe_cap: int,
                                 build_cap: int) -> torch.Tensor:
    """Per-shard candidate totals after the key shuffle (keys only)."""
    pk2, pv2, _ = _shuffle_side(mesh, probe_keys, [], probe_valid,
                                probe_cap)
    bk2, bv2, _ = _shuffle_side(mesh, build_keys, [], build_valid,
                                build_cap)
    totals = []
    for s in range(mesh.size):
        table = jn.build(_mask_first(bk2[s], bv2[s]))
        lo, hi = jn.probe_ranges(table, _mask_first(pk2[s], pv2[s]))
        totals.append((hi - lo).sum().to(mesh.device))
    return torch.stack(totals)


def dist_join_partitioned(mesh, probe_cols, probe_keys, probe_valid,
                          build_cols, build_keys, build_valid,
                          join_type: JoinType, probe_cap: int,
                          build_cap: int, pair_cap: int):
    """Both sides shuffled by key, a local join per shard.  SEMI/ANTI
    masks keep the shuffled probe rows, which ``out_cols`` then holds.
    Returns (out_cols, out_mask, overflow)."""
    nk = len(probe_keys)
    pshuf, pv2, ov1 = _shuffle_side(mesh, probe_keys, probe_cols,
                                    probe_valid, probe_cap)
    bshuf, bv2, ov2 = _shuffle_side(mesh, build_keys, build_cols,
                                    build_valid, build_cap)
    outs, masks, ovs = [], [], []
    for s in range(mesh.size):
        pc2 = pshuf[s][nk:]
        out, mask, ov3 = _local_join(bshuf[s][nk:], bshuf[s][:nk], bv2[s],
                                     pc2, pshuf[s][:nk], pv2[s], join_type,
                                     pair_cap)
        outs.append(pc2 if out is None else out)
        masks.append(mask)
        ovs.append(ov1[s].to(torch.int64) + ov2[s].to(torch.int64) + ov3)
    return _gather_out(mesh, outs, masks, ovs)
