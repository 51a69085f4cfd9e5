"""Join steps of the Executor (counterpart of the single-device routes of
hdk_tpu/exec/join_exec.py): the loop join, the sorted-hash join and the
perfect (dense direct-index) join, for INNER, LEFT, SEMI and ANTI joins,
with residual ON conditions.

The inputs stay masked: a filtered side keeps its row mask, and its dead
rows fold into NULL keys, which never match.  Join outputs gather a column
only when a consumer reads it.  A build table is cached per identity of
the build keys' tensors (and the build side's row mask), and per data-plan
signature of the build subtree, so a warm run over the same tables does
not build it again.  ``_join_route`` keeps the route the last equi-join
took (``"perfect"`` or ``"hash"``) and ``_join_builds`` counts the build
tables made.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from . import join as jn
from . import ranges as rg
from .agg_exec import _IDENTITY_KINDS
from .codecache import _h, data_plan_sig, expr_sig
from .common import (ExecTable, _LazyThunkColumns, _broadcast, _raise_ref,
                     _rebind_to_join_output, _schema_sig)
from .masked import MaskedCol, combine_masks
from .scalar import ExecError


def _take(c: MaskedCol, idx: torch.Tensor) -> MaskedCol:
    return MaskedCol(c.data[idx], c.mask[idx] if c.mask is not None else None)


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Indices where ``mask`` is set, in order (a host sync for the
    count)."""
    return torch.nonzero(mask).reshape(-1)


class JoinExecMixin:
    # -- build tables: identity cache, then the plan-keyed cache ----------
    def _join_build_plan_sig(self, node: nd.Join) -> Optional[str]:
        """Key of this join's build tables across runs: the data-plan
        signature of the build subtree, both sides' key expressions (the
        probe key types drive promotion and dictionary translation of the
        build keys), the join type and the dictionary sizes."""
        if not self.config.cache.enable_hashtable_cache:
            return None
        sig_ids = {node.inputs[0].id: "L", node.inputs[1].id: "R"}
        pairs = ";".join(f"{expr_sig(l, sig_ids)}={expr_sig(r, sig_ids)}"
                         for l, r in node.key_pairs)
        dicts = ",".join(f"{i}:{len(d)}"
                         for i, d in sorted(self.dicts._dicts.items()))
        return _h([data_plan_sig(node.inputs[1]), pairs,
                   node.join_type.value, dicts])

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
        return self._exec_join_single(node, results)

    def _exec_join_single(self, node: nd.Join, results) -> ExecTable:
        # masked inputs: a filtered side keeps its row mask (no compaction
        # gathers); dead rows become NULL keys below and never match
        lhs = self._input_table_masked(node.inputs[0], results)
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
        rhs_keys = eval_keys([r for _, r in node.key_pairs], rhs)
        # rewritten build keys no longer take their expression's values:
        # its static range must not bound the perfect table
        keys_rewritten = False
        for i, (le, re_) in enumerate(node.key_pairs):
            lt, rt = le.type, re_.type
            if (lt.is_dict_encoded_string() and rt.is_dict_encoded_string()
                    and lt.dict_id != rt.dict_id):  # type: ignore[attr-defined]
                # cross-dictionary string keys: rhs codes into the lhs
                # dictionary (absent strings become NULL keys)
                data, mask = self.scalar.translate_dict_codes(
                    rhs_keys[i].data, rhs_keys[i].mask, rt, lt)
                rhs_keys[i] = MaskedCol(data, mask)
                keys_rewritten = True
            elif lhs_keys[i].data.dtype != rhs_keys[i].data.dtype:
                # mixed numeric key types (INT = DOUBLE from an IN
                # subquery): the hash reads each side's bits, so both
                # sides take the common type first
                ld, rd = lhs_keys[i].data.dtype, rhs_keys[i].data.dtype
                if ld != torch.bool and rd != torch.bool:
                    ct = torch.promote_types(ld, rd)
                    if ld != ct:
                        lhs_keys[i] = MaskedCol(lhs_keys[i].data.to(ct),
                                                lhs_keys[i].mask)
                    if rd != ct:
                        rhs_keys[i] = MaskedCol(rhs_keys[i].data.to(ct),
                                                rhs_keys[i].mask)
                        keys_rewritten = True
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

        self._join_route = "perfect"
        out = self._try_perfect_join(node, lhs, rhs, lhs_keys, rhs_keys,
                                     plan_sig, ht_objs, bp, keys_rewritten)
        if out is not None:
            return out
        self._join_route = "hash"
        return self._hash_join(node, lhs, rhs, lhs_keys, rhs_keys, plan_sig,
                               ht_objs, bp)

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
                          plan_sig, ht_objs, bp,
                          keys_rewritten) -> Optional[ExecTable]:
        """Perfect route: one integer-like key, unique on the build side,
        over a range the static stats or a device min/max admit.  None
        where the route does not apply (a rejection is cached)."""
        if len(node.key_pairs) != 1:
            return None
        kt = node.key_pairs[0][1].type
        if not (kt.is_integer() or kt.is_boolean()
                or kt.is_dict_encoded_string()
                or (kt.is_date() and kt.unit == t.TimeUnit.DAY)):  # type: ignore[attr-defined]
            return None
        if (lhs_keys[0].data.is_floating_point()
                or rhs_keys[0].data.is_floating_point()):
            return None  # a float key promoted from an integer one
        jt = node.join_type
        sig = plan_sig + "|perfect"
        cached = self._ht_get(sig, ht_objs, bp, "perfect")
        if cached is None:
            cached = self._build_perfect(node, lhs, rhs, rhs_keys[0],
                                         keys_rewritten)
            self._ht_put(sig, ht_objs, bp, "perfect", cached)
        table, range_size, complete = cached
        if table is None:
            return None
        if node.residual is not None and jt != nd.JoinType.INNER:
            return None  # the hash route folds the residual into matching

        if jt in (nd.JoinType.SEMI, nd.JoinType.ANTI):
            # a complete table matches without being read
            _slots, matched = jn.perfect_match(table, lhs_keys[0],
                                               range_size=range_size,
                                               complete=complete)
            return self._semi_anti(node, lhs, matched)

        # INNER and LEFT: one read of the table gives the matches and the
        # build rows
        rows = jn.probe_perfect(table, lhs_keys[0], range_size)
        matched = rows >= 0
        memo = {}

        def build_rows():
            # an unmatched probe row reads build row 0 under a NULL build
            # side or a dead output row
            if "r" not in memo:
                memo["r"] = torch.clamp(rows, min=0)
            return memo["r"]

        def out_table(keep, row_mask, r_valid=None):
            return self._pair_table(
                node, lhs, rhs, keep,
                build_rows if keep is None else build_rows()[keep],
                lhs.nrows if keep is None else int(keep.shape[0]),
                row_mask=row_mask, r_valid=r_valid,
                unique_sets=lhs.unique_sets)

        if jt == nd.JoinType.LEFT:
            return out_table(None, lhs.row_mask, r_valid=matched)
        masked_wins = self._masked_output_wins(node, lhs)
        if masked_wins and lhs.row_mask is not None:
            # a masked probe is never all matched, and its consumers take
            # a mask for free: no match-count sync
            out = out_table(None, matched)
        else:
            m = int(matched.sum())  # host sync: match count
            if m == lhs.nrows and lhs.row_mask is None:
                out = out_table(None, None)  # every probe row matched
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
        """(table, range_size, complete), or (None, None, False) where the
        range or the duplicate check refuses the perfect route."""
        jcfg = self.config.exec.join
        rejected = (None, None, False)

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
        table, unique, n_set = jn.build_perfect(bk, min_key=lo,
                                                range_size=range_size)
        self._join_builds += 1
        unique, n_set = torch.stack([unique.to(torch.int64),
                                     n_set]).tolist()  # host sync
        if not unique:  # duplicate build keys: the hash route
            return rejected
        # every slot occupied: matching needs no table read
        return table, range_size, n_set == range_size

    def _masked_output_wins(self, node: nd.Join, lhs: ExecTable) -> bool:
        """True when every consumer of this join takes a masked
        (uncompacted) output at no extra per-row cost, so compaction
        gathers are waste whatever the match fraction: other joins (key
        evaluation folds the mask into NULL keys), and aggregates that
        take the identity pass over keys certified unique."""
        cons = (self._consumers or {}).get(node.id, [])
        if cons and all(c.startswith("join") for c in cons):
            return True
        if not lhs.unique_sets or node.residual is not None:
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
                    l_idx, r_idx, nrows: int, row_mask=None, r_valid=None,
                    unique_sets=()) -> ExecTable:
        """Join output whose columns gather on first read: a consumer that
        reads some columns never pays for the rest.  ``l_idx=None``: the
        probe columns pass through.  ``r_idx`` may be a thunk that makes
        the build row ids on first use.  ``r_valid`` marks the rows whose
        build side is present (LEFT joins); elsewhere the build columns
        are NULL with zero data."""
        def lthunk(ci):
            if l_idx is None:
                return lambda: lhs.columns[ci]
            return lambda: _take(lhs.columns[ci], l_idx)

        def rthunk(ci):
            def thunk():
                ri = r_idx() if callable(r_idx) else r_idx
                c = _take(rhs.columns[ci], ri)
                if r_valid is None:
                    return c
                # an array column's rows are 2-D: the row flag spans them
                rv = r_valid if c.data.dim() == 1 else r_valid[:, None]
                zero = torch.zeros((), dtype=c.data.dtype,
                                   device=c.data.device)
                return MaskedCol(torch.where(rv, c.data, zero),
                                 combine_masks(rv, c.mask))
            return thunk

        cols = _LazyThunkColumns([lthunk(i) for i in range(len(lhs.fields))]
                                 + [rthunk(i) for i in range(len(rhs.fields))])
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         nrows, row_mask, unique_sets=unique_sets)

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
