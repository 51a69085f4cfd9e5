"""Join steps of the Executor (counterpart of the single-device routes of
hdk_tpu/exec/join_exec.py): the loop join, the sorted-hash join, and the
perfect (dense direct-index) family, for INNER, LEFT, SEMI and ANTI joins,
with residual ON conditions.

The perfect family reads value tables: each build column a consumer
pulls is scattered once into key-slot order and read with one
``vt[slot]`` gather, and a complete table (every slot occupied) matches
without a table read.  Its delta-spread variant (``join.spread_inner_fk``)
serves an INNER join whose probe rows all match a complete table when
the consumers read build columns only (``common._column_demand``); its
undemanded columns raise.  Where the probe has at least 2^16 rows, the
first runs of a plan time the ``spread``, ``value`` and ``hash`` routes
(``feedback.py``; an inadmissible one is recorded as +inf) and later runs
take the fastest; otherwise the static order is spread > value > hash.

The inputs stay masked: a filtered side keeps its row mask, and its dead
rows fold into NULL keys, which never match.  Join outputs gather a column
only when a consumer reads it.  Build tables, value tables and the build
side's shape are cached per identity of the build keys' tensors (and the
build side's row mask), and per data-plan signature of the build subtree;
when the latter cover every build column a join's consumers demand, the
executor skips the build subtree (``Executor._plan_recycle_skips``) and
the join runs over a stub of the build side whose data raises.
``_join_route`` keeps the route the last equi-join took (``"perfect"``,
``"spread"``, ``"hash"``, ``"perfect(spread-demoted:f64)"`` or
``"perfect(recycled)"``) and ``_join_builds`` counts the build tables and
value tables made.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from ..utils.logger import get_channel
from . import join as jn
from . import ranges as rg
from .agg_exec import _IDENTITY_KINDS
from .codecache import _h, data_plan_sig, expr_sig
from .common import (ExecTable, _LazyThunkColumns, _broadcast, _raise_ref,
                     _rebind_to_join_output, _schema_sig)
from .feedback import synchronize, timed_wall
from .masked import MaskedCol, combine_masks, torch_dtype
from .scalar import ExecError

_LOG = get_channel("exec")

# the join route A/B's candidates, in the static order of preference
_JOIN_ROUTES = ("spread", "value", "hash")
_TUNE_MIN_ROWS = 1 << 16


def _take(c: MaskedCol, idx: torch.Tensor) -> MaskedCol:
    return MaskedCol(c.data[idx], c.mask[idx] if c.mask is not None else None)


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Indices where ``mask`` is set, in order (a host sync for the
    count)."""
    return torch.nonzero(mask).reshape(-1)


def _null_unmatched(c: MaskedCol, r_valid) -> MaskedCol:
    """A build column of a join output, NULL with zero data on the rows
    whose build side is absent (``r_valid`` False; None: none is)."""
    if r_valid is None:
        return c
    # an array column's rows are 2-D: the row flag spans them
    rv = r_valid if c.data.dim() == 1 else r_valid[:, None]
    zero = torch.zeros((), dtype=c.data.dtype, device=c.data.device)
    return MaskedCol(torch.where(rv, c.data, zero), combine_masks(rv, c.mask))


class _StubArray:
    """Stand-in for a column of a skipped build side: it has the shape and
    dtype that route admission reads, and raises on any other use, since
    every read of the build side goes through the recycled tables."""

    __slots__ = ("shape", "dtype", "__weakref__")

    def __init__(self, shape, dtype: torch.dtype) -> None:
        self.shape = tuple(shape)
        self.dtype = dtype

    def dim(self) -> int:
        return len(self.shape)

    def __getattr__(self, name):
        raise ExecError(f"internal: skipped build-side data touched "
                        f"(attribute {name!r})")

    def __getitem__(self, _idx):
        raise ExecError("internal: skipped build-side data touched "
                        "(indexing)")


class JoinExecMixin:
    # -- build tables: identity cache, then the plan-keyed cache ----------
    def _data_epoch(self) -> str:
        """The session data a data-plan signature leaves out: dictionary
        sizes (code translation and dictionary codes depend on them) and
        the UDF registry's generation (a build subtree may call a UDF)."""
        dsig = ",".join(f"{i}:{len(d)}"
                        for i, d in sorted(self.dicts._dicts.items()))
        u = self.udfs.generation if self.udfs is not None else 0
        return f"{dsig}|u{u}"

    def _join_build_plan_sig(self, node: nd.Join) -> Optional[str]:
        """Key of this join's build artifacts across runs: the data-plan
        signature of the build subtree, both sides' key expressions (the
        probe key types drive promotion and dictionary translation of the
        build keys), the join type and the data epoch."""
        if (not node.key_pairs or self._mesh is not None
                or not self.config.cache.enable_hashtable_cache):
            return None
        sig_ids = {node.inputs[0].id: "L", node.inputs[1].id: "R"}
        pairs = ";".join(f"{expr_sig(l, sig_ids)}={expr_sig(r, sig_ids)}"
                         for l, r in node.key_pairs)
        return _h([data_plan_sig(node.inputs[1]), pairs,
                   node.join_type.value, self._data_epoch()])

    def _ht_get(self, sig: str, objs, bp: Optional[str], tag: str):
        got = self._hashtable_cache.get(sig, objs)
        if got is None and bp is not None:
            got = self._ht_plan_cache.get((bp, tag))
            if got is not None:
                self._hashtable_cache.put(sig, objs, got)
        return got

    def _ht_put(self, sig: str, objs, bp: Optional[str], tag: str,
                value) -> None:
        self._hashtable_cache.put(sig, objs, value)
        if bp is not None:
            self._ht_plan_cache.put((bp, tag), value)

    def _stub_rhs_table(self, meta) -> ExecTable:
        """The build side's shape (fields, types, per-column dtypes, rows)
        from the recycled metadata, without running its subtree; its data
        raises."""
        fields, types_, nrows, colmeta, has_row_mask, unique_sets = meta
        cols = [MaskedCol(_StubArray(shape, dt),
                          _StubArray(shape, torch.bool) if has_mask else None)
                for shape, dt, has_mask in colmeta]
        rm = _StubArray((nrows,), torch.bool) if has_row_mask else None
        return ExecTable(list(fields), list(types_), cols, nrows, rm,
                         unique_sets=unique_sets)

    def _join_plan_ready(self, node: nd.Join, bp: str) -> bool:
        """True when the recycled artifacts cover this join's build side:
        its shape, a perfect table, and a value table for each build
        column its consumers demand (SEMI/ANTI demand none)."""
        if self._ht_plan_cache.get((bp, "meta")) is None:
            return False
        perf = self._ht_plan_cache.get((bp, "perfect"))
        if perf is None or perf[0] is None:
            return False  # the hash route reads the build side's data
        if node.join_type in (nd.JoinType.SEMI, nd.JoinType.ANTI):
            return True
        nl = node.inputs[0].size()
        demand = (self._demand or {}).get(node.id)
        rhs_demand = (sorted(i - nl for i in demand if i >= nl)
                      if demand is not None
                      else range(node.inputs[1].size()))
        return all(self._ht_plan_cache.get((bp, f"vt{ci}")) is not None
                   for ci in rhs_demand)

    # ------------------------------------------------------------------
    def _exec_loop_join(self, node: nd.Join, results) -> ExecTable:
        """Cartesian (loop) join for key-less INNER joins: CROSS JOIN, a
        comma FROM and a non-equi ON, gated by ``enable_loop_join`` and the
        inner table's row cap."""
        jcfg = self.config.exec.join
        if not jcfg.enable_loop_join:
            raise ExecError(
                "cross/loop join disabled (exec.join.enable_loop_join)")
        assert node.join_type == nd.JoinType.INNER
        lhs = self._materialize_input(node.inputs[0], results)
        rhs = self._materialize_input(node.inputs[1], results)
        if lhs.nrows == 0 or rhs.nrows == 0:
            return ExecTable.empty(node.fields, node.output_types,
                                   self.device)
        if rhs.nrows > jcfg.loop_join_inner_table_max_num_rows:
            raise ExecError(
                f"loop-join inner table has {rhs.nrows} rows, above "
                f"join.loop_join_inner_table_max_num_rows="
                f"{jcfg.loop_join_inner_table_max_num_rows}")
        ln, rn = lhs.nrows, rhs.nrows
        wd = self.config.exec.watchdog
        if wd.enable and ln * rn > wd.max_rows_per_step:
            raise ExecError(
                f"watchdog: loop join would produce {ln * rn} rows")
        li = torch.arange(ln, device=self.device).repeat_interleave(rn)
        ri = torch.arange(rn, device=self.device).repeat(ln)
        out = self._pair_table(node, lhs, rhs, li, ri, ln * rn)
        rm = None
        if node.residual is not None:
            rm = self._predicate(_rebind_to_join_output(node.residual, node),
                                 out.columns)
        return ExecTable(out.fields, out.types, out.columns, ln * rn, rm)

    def _exec_join(self, node: nd.Join, results) -> ExecTable:
        if not node.key_pairs:
            return self._exec_loop_join(node, results)
        if self._mesh is not None:
            out = self._exec_join_dist(node, results)
            if out is not None:
                return out
        return self._exec_join_single(node, results)

    def _exec_join_single(self, node: nd.Join, results) -> ExecTable:
        # masked inputs: a filtered side keeps its row mask (no compaction
        # gathers); dead rows become NULL keys below and never match
        lhs = self._input_table_masked(node.inputs[0], results)
        # a build subtree the recycled artifacts cover did not run: its
        # shape comes from their metadata, its data from their tables
        skip_info = (self._join_skip_rhs or {}).get(node.id)
        if skip_info is not None:
            rhs = self._stub_rhs_table(skip_info)
        else:
            rhs = self._input_table_masked(node.inputs[1], results)

        def eval_keys(exprs, table):
            out = [_broadcast(self.scalar.evaluate(
                e, lambda ref: table.columns[ref.index]), table.nrows)
                for e in exprs]
            if table.row_mask is not None:
                out = [MaskedCol(k.data, combine_masks(k.mask,
                                                       table.row_mask))
                       for k in out]
            return out

        lhs_keys = eval_keys([l for l, _ in node.key_pairs], lhs)
        # rewritten build keys no longer take their expression's values:
        # its static range must not bound the perfect table
        keys_rewritten = False
        if skip_info is not None:
            # the recycled table holds the build keys as the cold run
            # promoted them: the probe keys take the same promotion, from
            # the build keys' static types
            rhs_keys = None
            for i, (le, re_) in enumerate(node.key_pairs):
                lt, rt = le.type, re_.type
                if lt.is_dict_encoded_string() or rt.is_dict_encoded_string():
                    continue
                ld = lhs_keys[i].data.dtype
                rd = torch_dtype(rt.physical_dtype())
                if ld != rd and ld != torch.bool and rd != torch.bool:
                    ct = torch.promote_types(ld, rd)
                    if ld != ct:
                        lhs_keys[i] = MaskedCol(lhs_keys[i].data.to(ct),
                                                lhs_keys[i].mask)
        else:
            rhs_keys = eval_keys([r for _, r in node.key_pairs], rhs)
            keys_rewritten = self._unify_key_types(node, lhs_keys, rhs_keys)
        jt = node.join_type

        if lhs.nrows == 0:
            return ExecTable.empty(node.fields, node.output_types,
                                   self.device)
        if rhs.nrows == 0:
            if jt in (nd.JoinType.INNER, nd.JoinType.SEMI):
                return ExecTable.empty(node.fields, node.output_types,
                                       self.device)
            if jt == nd.JoinType.ANTI:
                return self._fields_table(node, lhs)
            empty = torch.zeros((0,), dtype=torch.int64, device=self.device)
            live = (torch.arange(lhs.nrows, device=self.device)
                    if lhs.row_mask is None else _nonzero(lhs.row_mask))
            return self._left_pad(node, lhs, rhs, empty, empty, live)

        sig_ids = {node.inputs[0].id: "L", node.inputs[1].id: "R"}
        plan_sig = _h([
            ";".join(f"{expr_sig(l, sig_ids)}={expr_sig(r, sig_ids)}"
                     for l, r in node.key_pairs),
            jt.value, _schema_sig(lhs), _schema_sig(rhs),
            lhs.nrows, rhs.nrows,
        ])
        rhs_ref_idx = sorted({ref.index for _, r in node.key_pairs
                              for ref in ir.collect_column_refs(r)})
        # the row mask is part of the build's identity: two filters over
        # one table share its column tensors
        ht_objs = [rhs.columns[i].data for i in rhs_ref_idx] + (
            [rhs.row_mask] if rhs.row_mask is not None else [])
        bp = self._join_build_plan_sig(node)
        if (skip_info is None and bp is not None
                and not any(ty.is_array() for ty in rhs.types)):
            # the build side's shape, for a later run that skips its
            # subtree (dtypes from the static types: nothing is pulled)
            colmeta = [((rhs.nrows,), torch_dtype(ty.physical_dtype()),
                        bool(ty.nullable)) for ty in rhs.types]
            self._ht_plan_cache.put((bp, "meta"), (
                list(rhs.fields), list(rhs.types), rhs.nrows, colmeta,
                rhs.row_mask is not None, rhs.unique_sets))

        def attempt(pref):
            """One route: ``None`` takes the static order (spread > value
            > hash); a named route returns None where it is not
            admissible."""
            if pref != "hash":
                self._join_route = "perfect"  # "spread" is set inside
                out_ = self._try_perfect_join(
                    node, lhs, rhs, lhs_keys, rhs_keys, plan_sig, ht_objs,
                    bp, keys_rewritten, route=pref)
                if out_ is not None or pref is not None:
                    return out_
            self._join_route = "hash"
            return self._hash_join(node, lhs, rhs, lhs_keys, rhs_keys,
                                   plan_sig, ht_objs, bp)

        if skip_info is not None:
            # the readiness check found the table and every demanded value
            # table; the route A/B is bypassed: the recycled route is the
            # static order's
            out = self._try_perfect_join(node, lhs, rhs, lhs_keys, None,
                                         plan_sig, ht_objs, bp, False)
            if out is None:
                raise ExecError("internal: recycled perfect-join artifacts "
                                "vanished between the readiness check and "
                                "the join")
            self._join_route = "perfect(recycled)"
            return out

        if (self._feedback.enabled and self._mesh is None
                and lhs.nrows >= _TUNE_MIN_ROWS):
            # the route A/B: each candidate runs twice, the second run
            # timed with its demanded outputs computed and the device
            # synchronized; later runs take the fastest
            tune_sig = plan_sig + "|tunejoin"
            demand = (self._demand or {}).get(node.id)
            while True:
                pref, measure = self._feedback.choose(tune_sig, _JOIN_ROUTES)
                if not measure:
                    out = attempt(pref)
                    if out is not None:
                        return out
                    break  # the winner is not admissible now: static order

                def run():
                    o = attempt(pref)
                    if o is not None:
                        self._force_table_demanded(o, demand)
                    return o

                out, secs = timed_wall(run)
                if out is None:  # never explored again for this plan
                    self._feedback.record(tune_sig, pref, math.inf)
                    continue
                self._feedback.record(tune_sig, pref, secs)
                return out
        return attempt(None)

    def _unify_key_types(self, node: nd.Join, lhs_keys, rhs_keys) -> bool:
        """Cross-dictionary string keys translate the build codes into the
        probe's dictionary (absent strings become NULL keys); mixed numeric
        key types (INT = DOUBLE from an IN subquery) take their common type
        on both sides, since the hash reads each side's bits.  True when a
        build key was rewritten."""
        rewritten = False
        for i, (le, re_) in enumerate(node.key_pairs):
            lt, rt = le.type, re_.type
            if (lt.is_dict_encoded_string() and rt.is_dict_encoded_string()
                    and lt.dict_id != rt.dict_id):  # type: ignore[attr-defined]
                data, mask = self.scalar.translate_dict_codes(
                    rhs_keys[i].data, rhs_keys[i].mask, rt, lt)
                rhs_keys[i] = MaskedCol(data, mask)
                rewritten = True
            elif lhs_keys[i].data.dtype != rhs_keys[i].data.dtype:
                ld, rd = lhs_keys[i].data.dtype, rhs_keys[i].data.dtype
                if ld != torch.bool and rd != torch.bool:
                    ct = torch.promote_types(ld, rd)
                    if ld != ct:
                        lhs_keys[i] = MaskedCol(lhs_keys[i].data.to(ct),
                                                lhs_keys[i].mask)
                    if rd != ct:
                        rhs_keys[i] = MaskedCol(rhs_keys[i].data.to(ct),
                                                rhs_keys[i].mask)
                        rewritten = True
        return rewritten

    def _hash_join(self, node, lhs, rhs, lhs_keys, rhs_keys, plan_sig,
                   ht_objs, bp) -> ExecTable:
        """Sorted-hash route: build once per build identity, probe the
        candidate ranges, expand to exactly the candidate count, verify
        the keys."""
        jt = node.join_type
        table = self._ht_get(plan_sig + "|ht", ht_objs, bp, "ht")
        if table is None:
            table = jn.build(rhs_keys)
            self._join_builds += 1
            self._ht_put(plan_sig + "|ht", ht_objs, bp, "ht", table)
        lo, hi = jn.probe_ranges(table, lhs_keys)
        total = int((hi - lo).sum())  # host sync: candidate count
        if total == 0:
            l_keep = r_keep = torch.zeros((0,), dtype=torch.int64,
                                          device=self.device)
        else:
            l_idx, r_idx = jn.expand_pairs(table, lo, hi, total)
            ok = jn.verify_pairs(rhs_keys, lhs_keys, l_idx, r_idx)
            if node.residual is not None and jt != nd.JoinType.INNER:
                ok = ok & self._residual_on_pairs(node, lhs, rhs, l_idx,
                                                  r_idx)
            keep = _nonzero(ok)  # host sync: verified match count
            l_keep, r_keep = l_idx[keep], r_idx[keep]
        m = int(l_keep.shape[0])

        if jt == nd.JoinType.INNER:
            if m == 0:
                return ExecTable.empty(node.fields, node.output_types,
                                       self.device)
            out = self._pair_table(node, lhs, rhs, l_keep, r_keep, m)
            if node.residual is not None:
                out = self._apply_residual(node, out)
            return out
        matched = torch.zeros((lhs.nrows,), dtype=torch.bool,
                              device=self.device)
        matched[l_keep] = True
        if jt != nd.JoinType.LEFT:
            return self._semi_anti(node, lhs, matched)
        # LEFT: a residual is already in the match set
        return self._left_pad(node, lhs, rhs, l_keep, r_keep,
                              _nonzero(self._unmatched(lhs, matched)))

    def _try_perfect_join(self, node, lhs, rhs, lhs_keys, rhs_keys,
                          plan_sig, ht_objs, bp, keys_rewritten,
                          route=None) -> Optional[ExecTable]:
        """Perfect family: one integer-like key, unique on the build side,
        over a range the static stats or a device min/max admit.
        ``route``: None tries spread, then the value tables; "spread"
        admits only the spread output, "value" skips it.  None where the
        route does not apply (a rejection is cached).  ``rhs_keys`` is
        None when the build subtree was skipped."""
        if len(node.key_pairs) != 1:
            return None
        jt = node.join_type
        if route == "spread" and (jt != nd.JoinType.INNER
                                  or node.residual is not None):
            return None
        kt = node.key_pairs[0][1].type
        if not (kt.is_integer() or kt.is_boolean()
                or kt.is_dict_encoded_string()
                or (kt.is_date() and kt.unit == t.TimeUnit.DAY)):  # type: ignore[attr-defined]
            return None
        if (lhs_keys[0].data.is_floating_point()
                or (rhs_keys is not None
                    and rhs_keys[0].data.is_floating_point())):
            return None  # a float key promoted from an integer one
        sig = plan_sig + "|perfect"
        cached = self._ht_get(sig, ht_objs, bp, "perfect")
        if cached is None:
            if rhs_keys is None:
                raise ExecError("internal: recycled perfect-join table "
                                "missing under a skipped build side")
            cached = self._build_perfect(node, lhs, rhs, rhs_keys[0],
                                         keys_rewritten)
            self._ht_put(sig, ht_objs, bp, "perfect", cached)
        table, range_size, complete, bslots = cached
        if table is None:
            return None
        if node.residual is not None and jt != nd.JoinType.INNER:
            return None  # the hash route folds the residual into matching

        # per probe row its key slot; a complete table matches without
        # being read
        slots, matched = jn.perfect_match(table, lhs_keys[0],
                                          range_size=range_size,
                                          complete=complete)
        if jt in (nd.JoinType.SEMI, nd.JoinType.ANTI):
            return self._semi_anti(node, lhs, matched)

        def out_table(keep, row_mask, r_valid=None):
            return self._pair_table_slots(
                node, lhs, rhs, keep, slots if keep is None else slots[keep],
                r_valid, sig, bslots, range_size, ht_objs, bp, row_mask)

        if jt == nd.JoinType.LEFT:
            return out_table(None, lhs.row_mask, r_valid=matched)
        masked_wins = self._masked_output_wins(node, lhs)
        if masked_wins and lhs.row_mask is not None and route != "spread":
            # a masked probe is never all matched, and its consumers take
            # a mask for free: no match-count sync
            out = out_table(None, matched)
        else:
            m = int(matched.sum())  # host sync: match count
            if m == lhs.nrows and lhs.row_mask is None:
                # every probe row matched (an FK join)
                if (complete and node.residual is None
                        and route in (None, "spread")):
                    out = self._try_spread_join(node, lhs, rhs, slots, sig,
                                                range_size, bslots, ht_objs,
                                                bp)
                    if out is not None:
                        self._join_route = "spread"
                        return out
                if route == "spread":
                    return None
                out = out_table(None, None)
            elif route == "spread":
                return None  # spread needs every unmasked probe row matched
            elif (masked_wins or m >= lhs.nrows
                  * self.config.exec.join.masked_output_min_match_frac):
                out = out_table(None, matched)
            else:
                out = out_table(_nonzero(matched), None)
        if node.residual is not None:
            out = self._apply_residual(node, out)
        return out

    def _build_perfect(self, node, lhs, rhs, bk: MaskedCol,
                       keys_rewritten) -> tuple:
        """(table, range_size, complete, build slots), or (None, None,
        False, None) where the range or the duplicate check refuses the
        perfect route."""
        jcfg = self.config.exec.join
        rejected = (None, None, False, None)

        def admissible(range_size):
            # a dense table costs range_size entries: a small build over a
            # wide range stays on the hash route, but a sparse bounded
            # range (a filtered FK build) still qualifies
            return not (
                range_size <= 0
                or range_size > jcfg.perfect_hash_range_limit
                or range_size > max(rhs.nrows, 1) * 1024
                or range_size > max(rhs.nrows * 8, 1 << 16)
                and lhs.nrows < jcfg.spread_join_min_rows)

        static_r = (None if keys_rewritten
                    else rg.infer_range(node.key_pairs[0][1]))
        if (static_r is not None and static_r[0] is not None
                and static_r[1] is not None
                and admissible(static_r[1] - static_r[0] + 1)):
            lo, hi = int(static_r[0]), int(static_r[1])
        else:
            # no static range, or it fails the guard (base-table stats
            # over a filtered build): a device min/max may admit a compact
            # table.  NULL and dead keys fill with the dtype's extremes.
            data = (bk.data.to(torch.int64) if bk.data.dtype == torch.bool
                    else bk.data)
            if bk.mask is None:
                stats = torch.stack([data.min(), data.max()])
            else:
                top = torch.iinfo(data.dtype).max
                bot = torch.iinfo(data.dtype).min
                stats = torch.stack([
                    torch.where(bk.mask, data, top).min(),
                    torch.where(bk.mask, data, bot).max()])
            lo, hi = (int(x) for x in stats.tolist())  # host sync
        range_size = hi - lo + 1
        if not admissible(range_size):
            return rejected
        # one pass: the table and each build row's slot, which the value
        # tables scatter through
        table, unique, n_set, bslots = jn.build_perfect(
            bk, min_key=lo, range_size=range_size)
        self._join_builds += 1
        unique, n_set = torch.stack([unique.to(torch.int64),
                                     n_set]).tolist()  # host sync
        if not unique:  # duplicate build keys: the hash route
            return rejected
        # every slot occupied: matching needs no table read
        return table, range_size, n_set == range_size, bslots

    # -- value tables and the spread route ----------------------------------
    def _value_table(self, sig, ci, c: MaskedCol, bslots, range_size,
                     ht_objs, bp):
        """Build column ``ci`` in key-slot order, cached per plan and
        identity of its tensor and the build keys' (``ht_objs``: the slot
        layout follows the keys, so a new key tensor under a live column
        tensor must miss), then per data-plan signature."""
        id_objs = [c.data] + list(ht_objs)
        vt_sig = sig + f"|vt{ci}"
        got = self._ht_get(vt_sig, id_objs, bp, f"vt{ci}")
        if got is None:
            got = jn.build_value_table(c, bslots, range_size)
            self._join_builds += 1
            self._ht_put(vt_sig, id_objs, bp, f"vt{ci}", got)
        return got

    def _value_tables_grouped(self, sig, rhs_idx, rhs: ExecTable, bslots,
                              range_size, ht_objs, bp) -> Dict[int, tuple]:
        """The value tables of every demanded build column, made together
        at the first pull of any: a later run then finds all of them,
        which skipping the build subtree needs."""
        return {ci: self._value_table(sig, ci, rhs.columns[ci], bslots,
                                      range_size, ht_objs, bp)
                for ci in rhs_idx}

    @staticmethod
    def _spreadable_dtype(dt: torch.dtype) -> bool:
        """Dtypes the spread route rebuilds exactly from 32-bit words:
        bool, integers (int64 as two words) and float32.  float64 is
        demoted to the value tables as in the JAX package, which has no
        bit view of it on a TPU, so both packages take the same route."""
        return dt in (torch.bool, torch.int8, torch.uint8, torch.int16,
                      torch.int32, torch.int64, torch.float32)

    def _try_spread_join(self, node: nd.Join, lhs: ExecTable,
                         rhs: ExecTable, slots, sig, range_size, bslots,
                         ht_objs, bp) -> Optional[ExecTable]:
        """The delta-spread output (``jn.spread_inner_fk``), where the
        join's consumers demand only build columns, all 1-D: the output
        is in slot order, which they cannot see.  Build rows ride along as
        dead rows under the row mask.  None where it does not apply."""
        if lhs.nrows < self.config.exec.join.spread_join_min_rows:
            return None
        demand = (self._demand or {}).get(node.id)
        if demand is None:  # every column: probe order matters
            return None
        nl = len(lhs.fields)
        if any(i < nl for i in demand):
            return None
        rhs_idx = sorted(i - nl for i in demand)
        if not rhs_idx:
            return None
        rcols = [rhs.columns[i] for i in rhs_idx]
        if any(c.data.dim() != 1 for c in rcols):
            return None  # array columns do not ride the sort
        bad = [rhs.fields[i] for i, c in zip(rhs_idx, rcols)
               if not self._spreadable_dtype(c.data.dtype)]
        if bad:
            _LOG.info("spread join demoted to the value-table route: "
                      "build column(s) %s are float64; cast them to "
                      "float32 or an integer type for the spread route",
                      ", ".join(bad))
            self._join_route = "perfect(spread-demoted:f64)"
            return None
        vts = self._value_tables_grouped(sig, rhs_idx, rhs, bslots,
                                         range_size, ht_objs, bp)
        is_probe, outcols = jn.spread_inner_fk(
            slots, [vts[i] for i in rhs_idx], range_size)

        def undemanded(j):
            def thunk():
                raise ExecError(
                    f"internal: spread-join column {j} pulled outside the "
                    f"demand set {sorted(demand)} (column-demand analysis "
                    f"fault)")
            return thunk

        by_out = {nl + i: MaskedCol(d, m)
                  for i, (d, m) in zip(rhs_idx, outcols)}
        cols = _LazyThunkColumns([
            (lambda v=by_out[j]: v) if j in by_out else undemanded(j)
            for j in range(len(node.fields))])
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         range_size + lhs.nrows, is_probe)

    def _pair_table_slots(self, node: nd.Join, lhs: ExecTable,
                          rhs: ExecTable, l_idx, slots, r_valid, sig,
                          bslots, range_size, ht_objs, bp,
                          row_mask=None) -> ExecTable:
        """Perfect-family output whose columns are made on first read: a
        probe column passes through (``l_idx=None``) or is gathered, a
        build column is one ``vt[slot]`` gather of its value table.
        ``r_valid`` marks the rows whose build side is present (LEFT);
        elsewhere the build columns are NULL with zero data.  Every output
        row is a distinct probe row, so the probe's uniqueness
        certificates hold."""
        demand = (self._demand or {}).get(node.id)
        nl = len(lhs.fields)
        rhs_demand = (sorted(i - nl for i in demand if i >= nl)
                      if demand is not None else [])
        memo: dict = {}

        def vt_for(ci):
            if len(rhs_demand) > 1 and ci in rhs_demand:
                if "vts" not in memo:
                    memo["vts"] = self._value_tables_grouped(
                        sig, rhs_demand, rhs, bslots, range_size, ht_objs,
                        bp)
                return memo["vts"][ci]
            return self._value_table(sig, ci, rhs.columns[ci], bslots,
                                     range_size, ht_objs, bp)

        def lthunk(ci):
            if l_idx is None:
                return lambda: lhs.columns[ci]
            return lambda: _take(lhs.columns[ci], l_idx)

        def rthunk(ci):
            def thunk():
                vtd, vtm = vt_for(ci)
                return _null_unmatched(
                    MaskedCol(vtd[slots], None if vtm is None
                              else vtm[slots]), r_valid)
            return thunk

        cols = _LazyThunkColumns([lthunk(i) for i in range(nl)]
                                 + [rthunk(i)
                                    for i in range(len(rhs.fields))])
        nrows = lhs.nrows if l_idx is None else int(l_idx.shape[0])
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         nrows, row_mask, unique_sets=lhs.unique_sets)

    def _force_table_demanded(self, table: ExecTable, demand) -> None:
        """Compute the lazy columns of a table that its consumers demand
        (all where ``demand`` is None) and wait for the device: a route is
        timed on what its consumers pull, and a spread output's other
        columns raise by design."""
        if isinstance(table.columns, _LazyThunkColumns):
            for i in (range(len(table.columns)) if demand is None
                      else sorted(demand)):
                table.columns[i]  # computes the column
        synchronize(self.device)

    def _masked_output_wins(self, node: nd.Join, lhs: ExecTable) -> bool:
        """True when every consumer of this join takes a masked
        (uncompacted) output at no extra per-row cost, so compaction
        gathers are waste whatever the match fraction: other joins (key
        evaluation folds the mask into NULL keys), and aggregates that
        take the identity pass over keys certified unique."""
        cons = (self._consumers or {}).get(node.id, [])
        if cons and all(c.startswith("join") for c in cons):
            return True
        if (not lhs.unique_sets or node.residual is not None
                or self._mesh is not None):  # the identity pass: one device
            return False
        direct = (self._direct_consumers or {}).get(node.id, [])
        if not direct:
            return False
        for c, pos in direct:
            if not (isinstance(c, nd.Aggregate) and pos == 0 and c.keys):
                return False
            if not all(isinstance(k, ir.ColumnRef) and k.node is node
                       for k in c.keys):
                return False
            key_idx = {k.index for k in c.keys}
            if not any(s <= key_idx for s in lhs.unique_sets):
                return False
            if not all(a.kind in _IDENTITY_KINDS
                       and getattr(a, "operand2", None) is None
                       for a in c.aggs):
                return False
        return True

    # -- outputs ------------------------------------------------------------
    def _predicate(self, cond_expr: ir.Expr, cols) -> torch.Tensor:
        """A boolean expression over ``cols`` as a row mask (NULL is
        false)."""
        cond = self.scalar.evaluate(cond_expr, lambda ref: cols[ref.index])
        m = cond.data.to(torch.bool)
        return m if cond.mask is None else m & cond.mask

    def _residual_on_pairs(self, node: nd.Join, lhs: ExecTable,
                           rhs: ExecTable, l_idx, r_idx) -> torch.Tensor:
        """The residual ON condition on candidate pairs."""
        lhs_node, rhs_node = node.inputs

        def resolve(ref: ir.ColumnRef) -> MaskedCol:
            if ref.node is lhs_node:
                return _take(lhs.columns[ref.index], l_idx)
            if ref.node is rhs_node:
                return _take(rhs.columns[ref.index], r_idx)
            return _raise_ref(ref)

        cond = self.scalar.evaluate(node.residual, resolve)
        m = cond.data.to(torch.bool)
        return m if cond.mask is None else m & cond.mask

    @staticmethod
    def _unmatched(lhs: ExecTable, matched) -> torch.Tensor:
        """The live probe rows without a match."""
        return ~matched if lhs.row_mask is None else ~matched & lhs.row_mask

    def _semi_anti(self, node: nd.Join, lhs: ExecTable,
                   matched) -> ExecTable:
        """SEMI: the probe rows with a match (a dead row never matches);
        ANTI: the live probe rows without one."""
        keep = (matched if node.join_type == nd.JoinType.SEMI
                else self._unmatched(lhs, matched))
        return self._fields_table(node, lhs.gather(_nonzero(keep)))

    def _fields_table(self, node, table: ExecTable) -> ExecTable:
        return ExecTable(list(node.fields), list(node.output_types),
                         table.columns, table.nrows, table.row_mask,
                         unique_sets=table.unique_sets)

    def _pair_table(self, node: nd.Join, lhs: ExecTable, rhs: ExecTable,
                    l_idx, r_idx, nrows: int, r_valid=None) -> ExecTable:
        """Join output of (probe row, build row) pairs whose columns gather
        on first read: a consumer that reads some columns never pays for
        the rest.  ``r_valid`` marks the rows whose build side is present
        (LEFT joins)."""
        cols = _LazyThunkColumns(
            [(lambda ci=ci: _take(lhs.columns[ci], l_idx))
             for ci in range(len(lhs.fields))]
            + [(lambda ci=ci: _null_unmatched(_take(rhs.columns[ci], r_idx),
                                              r_valid))
               for ci in range(len(rhs.fields))])
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         nrows)

    def _left_pad(self, node: nd.Join, lhs: ExecTable, rhs: ExecTable,
                  l_idx, r_idx, un_idx) -> ExecTable:
        """LEFT join output: the matched pairs, then the unmatched probe
        rows with a NULL build side."""
        n_match, n_un = int(l_idx.shape[0]), int(un_idx.shape[0])
        dev = self.device
        r_valid = torch.cat([torch.ones((n_match,), dtype=torch.bool,
                                        device=dev),
                             torch.zeros((n_un,), dtype=torch.bool,
                                         device=dev)])
        if rhs.nrows == 0:  # no build row to read: zeros under NULL
            def rthunk(ci):
                like = rhs.columns[ci].data  # (0,) or (0, width)
                shape = (n_un,) + tuple(like.shape[1:])
                return lambda: MaskedCol(
                    torch.zeros(shape, dtype=like.dtype, device=dev),
                    torch.zeros(shape, dtype=torch.bool, device=dev))

            l_all = un_idx
            cols = _LazyThunkColumns(
                [(lambda ci=ci: _take(lhs.columns[ci], l_all))
                 for ci in range(len(lhs.fields))]
                + [rthunk(ci) for ci in range(len(rhs.fields))])
            return ExecTable(list(node.fields), list(node.output_types),
                             cols, n_un)
        l_all = torch.cat([l_idx, un_idx])
        r_all = torch.cat([r_idx, torch.zeros((n_un,), dtype=torch.int64,
                                              device=dev)])
        return self._pair_table(node, lhs, rhs, l_all, r_all,
                                n_match + n_un, r_valid=r_valid)

    def _apply_residual(self, node: nd.Join, out: ExecTable) -> ExecTable:
        mask = self._predicate(_rebind_to_join_output(node.residual, node),
                               out.columns)
        if out.row_mask is not None:  # a masked output's dead rows stay out
            mask = mask & out.row_mask
        return out.gather(_nonzero(mask))
