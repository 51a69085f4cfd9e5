"""Distributed group-by over a mesh (counterpart of
hdk_tpu/parallel/dist_groupby.py).

Inputs are sharded: a key or operand is a list of one MaskedCol per
local shard, a row mask a list of tensors (``Mesh.split_col`` makes them
from one column); in a multi-host session each process passes its own
shards and the collectives cross the processes.  Each shard's body runs the port's group-by slot code
(``exec/groupby.reduce_slots``, ``groupby_sort``), so the histogram
kernels K1-K4 launch once per shard; between the bodies the shards meet
in ``utils/commlog`` collectives.  Four routes, as in the JAX package:

  * ``dist_groupby_perfect``: each shard's dense positional partial
    slots, combined by ``psum`` / ``pmin`` / ``pmax`` (t-digests by
    ``all_gather`` and a re-cluster); the result is replicated.
  * ``dist_groupby_two_phase``: algebraic aggregates pre-aggregate per
    shard (a hot key becomes one partial row a shard), the partial rows
    shuffle by key and merge by the ``_COMBINE`` rules.
  * ``dist_groupby_shuffled``: raw rows shuffle by key so every group
    lies whole on one shard (holistic aggregates), then a local
    sort-based group-by.
  * ``dist_groupby_distinct_split``: DISTINCT-class aggregates under
    skew: pre-aggregation at (keys, value) grain, a shuffle by that pair,
    per-key partials, a shuffle by key, a merge.

The shuffling routes return ``num_shards * group_cap`` rows gathered on
the mesh's first device with a validity mask, and an overflow count (a
shuffle slot, a receiver group cap or a local cap exceeded) that the
caller turns into a widen-and-retry; the shard bodies never sync.
"""

from __future__ import annotations

import dataclasses as _dc
import math
from typing import List, Optional, Sequence

import torch

from ..exec import groupby as gb
from ..exec.masked import MaskedCol
from ..ir.expr import AggKind
from ..ops import sketches as sk
from ..ops import sortops as so
from ..utils import commlog
from . import shuffle as shf

# slot-combine rule per aggregate kind (how per-shard raw slots merge);
# HLL registers merge by elementwise max, t-digest centroids by
# concatenation and re-clustering ("tdigest" takes both slots together)
_COMBINE = {
    AggKind.COUNT: ("sum",),
    AggKind.SUM: ("sum", "sum"),
    AggKind.AVG: ("sum", "sum"),
    AggKind.STDDEV_SAMP: ("sum", "sum", "sum"),
    AggKind.VAR_SAMP: ("sum", "sum", "sum"),
    AggKind.MIN: ("min", "sum"),
    AggKind.MAX: ("max", "sum"),
    AggKind.SAMPLE: ("min", "sum"),
    AggKind.SINGLE_VALUE: ("min", "sum"),
    AggKind.APPROX_COUNT_DISTINCT: ("max",),
    AggKind.APPROX_QUANTILE: ("tdigest", "tdigest"),
}
_REDUCE = {"sum": commlog.psum, "min": commlog.pmin, "max": commlog.pmax}


def perfect_combinable(specs: Sequence[gb.AggSpec]) -> bool:
    return all(s.kind in _COMBINE for s in specs)


def _pin_sketch_sizing(specs, cap_hint: int):
    """Freeze the sketch widths of a distributed run (budgets unlimited
    afterwards), so partials built at one group count and merged at
    another agree on register and centroid counts."""
    out = []
    for s in specs:
        if s.kind == AggKind.APPROX_COUNT_DISTINCT:
            s = _dc.replace(s, hll_p=sk.effective_hll_p(
                s.hll_p, cap_hint, s.hll_budget), hll_budget=1 << 62)
        elif s.kind == AggKind.APPROX_QUANTILE:
            s = _dc.replace(s, td_c=sk.effective_td_c(
                s.td_c, cap_hint, s.td_budget), td_budget=1 << 62)
        out.append(s)
    return out


def _shard_specs(specs, s: int):
    """Shard s's AggSpecs: operands picked from their shard lists."""
    return [_dc.replace(spec,
                        operand=None if spec.operand is None
                        else spec.operand[s],
                        operand2=None if spec.operand2 is None
                        else spec.operand2[s])
            for spec in specs]


def _permute(c: Optional[MaskedCol], perm) -> Optional[MaskedCol]:
    if c is None:
        return None
    return MaskedCol(c.data[perm], c.mask[perm] if c.mask is not None
                     else None)


def _take(cols, idx) -> List[MaskedCol]:
    return [_permute(c, idx) for c in cols]


def _gather_cols(mesh, per_shard: List[List[MaskedCol]]) -> List[MaskedCol]:
    """Per-shard column lists -> one list of gathered columns."""
    return [mesh.gather_col([cols[j] for cols in per_shard])
            for j in range(len(per_shard[0]))]


def dist_groupby_perfect(mesh, keys, layout: gb.PerfectHashLayout, specs,
                         row_valid=None):
    """Sharded keys and operands -> replicated dense buffers (key_cols,
    agg_cols, exists) of ``layout.entry_count`` entries on the mesh's
    first device."""
    n = layout.entry_count
    results, exists_l = [], []
    for s in range(mesh.local_size):
        gid, _ = gb.perfect_gid([k[s] for k in keys], layout,
                                None if row_valid is None else row_valid[s])
        res, counts = gb.reduce_slots(_shard_specs(specs, s), gid, n)
        results.append(res)
        exists_l.append((counts > 0).to(torch.int32))
    exists = commlog.psum(exists_l)[0] > 0
    agg_cols = []
    for i, spec in enumerate(specs):
        slots = [r[i].slots for r in results]
        if spec.kind == AggKind.APPROX_QUANTILE:
            c = slots[0][0].shape[1]
            gm = commlog.all_gather([sl[0] for sl in slots], axis=1,
                                    tiled=True)[0]
            gw = commlog.all_gather([sl[1] for sl in slots], axis=1,
                                    tiled=True)[0]
            combined = list(sk.tdigest_merge_gathered(gm, gw, c))
        else:
            combined = [_REDUCE[rule]([sl[j] for sl in slots])[0]
                        for j, rule in enumerate(_COMBINE[spec.kind])]
        agg_cols.append(gb.AggResult(combined).finalize(
            _dc.replace(spec, operand=None, operand2=None)))
    # shard 0 lies on the mesh's first device, where the result goes
    return (gb._perfect_key_columns([k[0] for k in keys], layout),
            agg_cols, exists)


def _sorted_key_spans(key_cols, row_valid, cap: int, minor_cols=()):
    """Rows sorted stably by ``key_cols`` then ``minor_cols``, dead rows
    last, and the key groups' spans.

    Returns (perm, rv_sorted, full_boundary, gid, starts, ends,
    n_groups): ``gid`` is the key group id (int32) clamped to ``cap - 1``
    with dead rows in a discard group ``cap``; ``full_boundary`` also
    marks minor-column changes (the distinct-run starts)."""
    nrows = key_cols[0].data.shape[0]
    dev = key_cols[0].data.device
    key_sort, minor_sort = [], []
    big = torch.iinfo(torch.int64).max
    for cols, out in ((key_cols, key_sort), (minor_cols, minor_sort)):
        for key in cols:
            kv = gb._orderable_int64(key.data)
            if key.mask is not None:
                kv = torch.where(key.mask, kv, big)
            out.append(kv)
    lead = [] if row_valid is None else [(~row_valid).to(torch.int8)]
    perm = so.lexsort(lead + key_sort + minor_sort)
    rv = None if row_valid is None else row_valid[perm]
    boundary = torch.zeros((nrows,), dtype=torch.bool, device=dev)
    if nrows:
        boundary[0] = True
    for kv in key_sort:
        boundary = boundary | so.changed(kv[perm])
    if rv is not None:
        boundary = boundary | so.changed(rv)
    full = boundary
    for kv in minor_sort:
        full = full | so.changed(kv[perm])
    gid = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    if nrows == 0:
        n_groups = torch.zeros((), dtype=torch.int64, device=dev)
    elif rv is None:
        n_groups = (gid[-1] + 1).to(torch.int64)
    else:
        n_groups = torch.where(rv, gid + 1, 0).max().to(torch.int64)
    gid = torch.clamp(gid, max=cap - 1)
    if rv is not None:
        gid = torch.where(rv, gid, cap)
    bounds = torch.searchsorted(gid, torch.arange(
        cap + 1, dtype=torch.int32, device=dev))
    return perm, rv, full, gid, bounds[:-1], bounds[1:], n_groups


def _local_partials(key_cols, specs, row_valid, cap: int, minor=()):
    """One shard's pre-aggregation: (partial keys, each spec's raw slots,
    partial-row validity, group count) at the grain of ``key_cols``."""
    nrows = key_cols[0].data.shape[0]
    perm, _rv, _full, gid, starts, _ends, n_groups = _sorted_key_spans(
        key_cols, row_valid, cap, minor)
    sspecs = [_dc.replace(sp, operand=_permute(sp.operand, perm),
                          operand2=_permute(sp.operand2, perm))
              for sp in specs]
    res, _counts = gb.reduce_slots(sspecs, gid, cap)
    rep = perm[torch.clamp(starts, 0, max(nrows - 1, 0))]
    pkeys = _take(key_cols, rep)
    valid = torch.arange(cap, device=gid.device) < n_groups
    return pkeys, [r.slots for r in res], valid, n_groups


def dist_groupby_two_phase(mesh, keys, specs, rows_per_shard: int,
                           group_cap_per_shard: int, slack: float = 2.0,
                           row_valid=None):
    """Skew-proof distributed group-by of algebraic aggregates: local
    partial aggregation, a shuffle of the partial rows by key, a merge by
    the ``_COMBINE`` rules.  Returns (key_cols, agg_cols, group_valid,
    overflow), ``num_shards * group_cap_per_shard`` rows gathered."""
    if not perfect_combinable(specs):
        raise ValueError("two-phase aggregation requires algebraic "
                         "aggregates; use dist_groupby_shuffled")
    p = mesh.size
    local_cap = min(rows_per_shard, group_cap_per_shard * p)
    cap = max(1, int(math.ceil(local_cap / p * slack)))
    specs = _pin_sketch_sizing(specs, max(local_cap, group_cap_per_shard))
    pkeys, pslots, pvalid, n_local = [], [], [], []
    for s in range(mesh.local_size):
        k, sl, v, nl = _local_partials(
            [key[s] for key in keys], _shard_specs(specs, s),
            None if row_valid is None else row_valid[s], local_cap)
        pkeys.append(k)
        pslots.append([MaskedCol(x) for slots in sl for x in slots])
        pvalid.append(v)
        n_local.append(nl)
    cols, rvalid, overflow = shf.shuffle_rows(pkeys, pslots, p, cap,
                                              row_valid=pvalid)
    nk = len(keys)
    out_keys, out_aggs, out_exists, ovf = [], [], [], []
    for s in range(mesh.local_size):
        mkeys, mslots, exists, n_merged = _merge_partials(
            cols[s][:nk], cols[s][nk:], specs, rvalid[s],
            group_cap_per_shard)
        out_keys.append(mkeys)
        out_aggs.append([gb.AggResult(sl).finalize(sp)
                         for sl, sp in zip(mslots, specs)])
        out_exists.append(exists)
        ovf.append(overflow[s].to(torch.int64)
                   + torch.clamp(n_merged - group_cap_per_shard, min=0)
                   + torch.clamp(n_local[s] - local_cap, min=0))
    return (_gather_cols(mesh, out_keys), _gather_cols(mesh, out_aggs),
            mesh.gather(out_exists), commlog.psum(ovf)[0])


def _merge_partials(key_cols, slot_cols, specs, row_valid, cap: int):
    """One shard's shuffled partial rows grouped by key, each spec's
    slots combined by its rules; (keys, slots, exists, group count)."""
    nrows = key_cols[0].data.shape[0]
    perm, rv, _full, gid, starts, ends, n_groups = _sorted_key_spans(
        key_cols, row_valid, cap)
    merged = []
    i = 0
    for spec in specs:
        c = _partial_slot_count(spec)
        merged.append(_rule_merge(spec, slot_cols[i:i + c], perm, rv, gid,
                                  starts, ends, cap))
        i += c
    rep = perm[torch.clamp(starts, 0, max(nrows - 1, 0))]
    exists = torch.arange(cap, device=gid.device) < n_groups
    return _take(key_cols, rep), merged, exists, n_groups


def _partial_slot_count(spec: gb.AggSpec) -> int:
    """Partial-slot columns a spec contributes to a merge."""
    if spec.kind == AggKind.COUNT_DISTINCT:
        return 1  # per-shard distinct counts of disjoint value sets: sum
    return len(_COMBINE[spec.kind])


def _identity(rule: str, dtype: torch.dtype, device) -> torch.Tensor:
    if rule == "sum":
        return torch.zeros((), dtype=dtype, device=device)
    return gb._minmax_identity(dtype, rule == "min", device)


def _seg_reduce(rule: str, vals: torch.Tensor, gid: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Per-group sum, min or max of the rows' values over ``gid`` in
    [0, cap]; group ``cap`` is discarded.  1-D sums go through the
    histogram kernels; 2-D values (sketch registers) reduce row-wise."""
    if vals.dim() == 1:
        if rule == "sum":
            return gb._seg_sum(vals, gid, cap + 1)[:cap]
        return gb._seg_extreme(vals, gid, cap + 1, rule == "min")[:cap]
    ident = _identity(rule, vals.dtype, vals.device)
    out = ident.expand((cap + 1,) + tuple(vals.shape[1:])).clone()
    red = {"sum": "sum", "min": "amin", "max": "amax"}[rule]
    idx = gid.to(torch.int64)[:, None].expand(vals.shape)
    return out.scatter_reduce_(0, idx, vals, red, include_self=True)[:cap]


def _rule_merge(spec, cols, perm, rv, gid, starts, ends, cap: int):
    """One spec's shuffled partial-slot columns merged over the key
    groups of a ``_sorted_key_spans`` layout."""
    if spec.kind == AggKind.APPROX_QUANTILE:
        means = cols[0].data[perm]
        weights = torch.where(rv[:, None], cols[1].data[perm], 0.0)
        return list(sk.tdigest_merge_rows(means, weights, gid, starts,
                                          ends, cap))
    rules = (("sum",) * len(cols) if spec.kind == AggKind.COUNT_DISTINCT
             else _COMBINE[spec.kind])
    slots = []
    for rule, col in zip(rules, cols):
        vals = col.data[perm]
        live = rv[:, None] if vals.dim() == 2 else rv
        vals = torch.where(live, vals, _identity(rule, vals.dtype,
                                                 vals.device))
        slots.append(_seg_reduce(rule, vals, gid, cap))
    return slots


def dist_groupby_shuffled(mesh, keys, specs, rows_per_shard: int,
                          group_cap_per_shard: int, slack: float = 2.0,
                          row_valid=None):
    """Raw rows to their key-owner shards, then a sort-based group-by
    there: every group whole on one shard, so holistic aggregates are
    exact.  Same return contract as ``dist_groupby_two_phase``."""
    p = mesh.size
    cap = max(1, int(math.ceil(rows_per_shard / p * slack)))
    nk = len(keys)
    payload = []
    for s in range(mesh.local_size):
        ss = _shard_specs(specs, s)
        payload.append([sp.operand for sp in ss if sp.operand is not None]
                       + [sp.operand2 for sp in ss
                          if sp.operand2 is not None])
    cols, rvalid, overflow = shf.shuffle_rows(
        [[k[s] for k in keys] for s in range(mesh.local_size)], payload, p, cap,
        row_valid=row_valid)
    out_keys, out_aggs, out_exists, ovf = [], [], [], []
    for s in range(mesh.local_size):
        rest = iter(cols[s][nk:])
        ops = [next(rest) if sp.operand is not None else None
               for sp in specs]
        ops2 = [next(rest) if sp.operand2 is not None else None
                for sp in specs]
        specs2 = [_dc.replace(sp, operand=o, operand2=o2)
                  for sp, o, o2 in zip(specs, ops, ops2)]
        kc, ac, exists, n_local = gb.groupby_sort(
            cols[s][:nk], specs2, group_cap_per_shard, row_valid=rvalid[s])
        out_keys.append(kc)
        out_aggs.append(ac)
        out_exists.append(exists)
        ovf.append(overflow[s].to(torch.int64) + torch.clamp(
            n_local.to(torch.int64) - group_cap_per_shard, min=0))
    return (_gather_cols(mesh, out_keys), _gather_cols(mesh, out_aggs),
            mesh.gather(out_exists), commlog.psum(ovf)[0])


def _is_distinct_class(spec: gb.AggSpec) -> bool:
    return (spec.kind == AggKind.COUNT_DISTINCT
            or (spec.distinct and spec.kind in (AggKind.SUM, AggKind.AVG)))


def dist_groupby_distinct_split(mesh, keys, specs, rows_per_shard: int,
                                group_cap_per_shard: int,
                                slack: float = 2.0, row_valid=None):
    """DISTINCT-class aggregates under key skew: rows pre-aggregate at
    the (keys, value) grain and shuffle by that pair, so a hot key's rows
    spread over every shard, each distinct value to one owner; per-key
    partials there (disjoint value sets: counts add), a shuffle by key,
    and a merge.  Every distinct-class spec reads one operand (the salt).
    Same return contract as ``dist_groupby_two_phase``."""
    p = mesh.size
    local_cap = max(1, rows_per_shard)
    cap1 = max(1, int(math.ceil(local_cap / p * slack)))
    cap3 = max(1, int(math.ceil(cap1 * slack)))
    specs = _pin_sketch_sizing(specs, max(local_cap, group_cap_per_shard))
    salt = next(s.operand for s in specs if _is_distinct_class(s))
    nk = len(keys)
    alg = [sp for sp in specs if not _is_distinct_class(sp)]

    # phase 0: local pre-aggregation at the (keys.., salt) pair grain
    pcols, pslots, pvalid = [], [], []
    for s in range(mesh.local_size):
        compound = [k[s] for k in keys] + [salt[s]]
        k, sl, v, _n = _local_partials(
            compound, _shard_specs(alg, s),
            None if row_valid is None else row_valid[s], local_cap)
        pcols.append(k)
        pslots.append([MaskedCol(x) for slots in sl for x in slots])
        pvalid.append(v)

    # phase 1: pair rows to hash(keys.., salt) owners
    cols1, rvalid1, ovf1 = shf.shuffle_rows(pcols, pslots, p, cap1,
                                            row_valid=pvalid)

    # phase 2: per-key partials over the received pair rows
    cap2 = p * cap1  # groups <= rows: this cap cannot overflow
    pkeys2, p2slots, valid2 = [], [], []
    for s in range(mesh.local_size):
        k1, salt1, s1 = cols1[s][:nk], cols1[s][nk], cols1[s][nk + 1:]
        perm2, rv2, full2, kgid, kst, ken, n_keys2 = _sorted_key_spans(
            k1, rvalid1[s], cap2, minor_cols=[salt1])
        salt_valid = (salt1.mask[perm2] if salt1.mask is not None
                      else torch.ones_like(rv2))
        first = full2 & rv2 & salt_valid  # distinct-run starts, non-null
        slots: List[torch.Tensor] = []
        si = 0
        for spec in specs:
            if _is_distinct_class(spec):
                cnt = gb._seg_sum(first.to(torch.int64), kgid,
                                  cap2 + 1)[:cap2]
                if spec.kind == AggKind.COUNT_DISTINCT:
                    slots.append(cnt)
                else:  # SUM/AVG DISTINCT: sum the first-of-run values
                    acc = salt1.fill(0)
                    acc = acc.to(gb._acc_dtype(acc.dtype))[perm2]
                    sm = gb._seg_sum(torch.where(first, acc, 0), kgid,
                                     cap2 + 1)[:cap2]
                    if spec.kind == AggKind.AVG:
                        sm = sm.to(torch.float64)
                    slots.extend([sm, cnt])
            else:
                c = _partial_slot_count(spec)
                slots.extend(_rule_merge(spec, s1[si:si + c], perm2, rv2,
                                         kgid, kst, ken, cap2))
                si += c
        rep2 = perm2[torch.clamp(kst, 0, cap2 - 1)]
        pkeys2.append(_take(k1, rep2))
        p2slots.append([MaskedCol(x) for x in slots])
        valid2.append(torch.arange(cap2, device=kgid.device) < n_keys2)

    # phase 3: per-key partial rows to hash(keys..) owners
    cols3, rvalid3, ovf3 = shf.shuffle_rows(pkeys2, p2slots, p, cap3,
                                            row_valid=valid2)

    # phase 4: merge the per-key partials, finalize
    out_keys, out_aggs, out_exists, ovf = [], [], [], []
    for s in range(mesh.local_size):
        mkeys, mslots, exists, n_merged = _merge_partials(
            cols3[s][:nk], cols3[s][nk:], specs, rvalid3[s],
            group_cap_per_shard)
        out_keys.append(mkeys)
        out_aggs.append([gb.AggResult(sl).finalize(sp)
                         for sl, sp in zip(mslots, specs)])
        out_exists.append(exists)
        ovf.append(ovf1[s].to(torch.int64) + ovf3[s].to(torch.int64)
                   + torch.clamp(n_merged - group_cap_per_shard, min=0))
    return (_gather_cols(mesh, out_keys), _gather_cols(mesh, out_aggs),
            mesh.gather(out_exists), commlog.psum(ovf)[0])
