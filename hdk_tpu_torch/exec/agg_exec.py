"""Aggregate steps of the Executor (counterpart of the single-device
routes of hdk_tpu/exec/agg_exec.py): GROUP BY on the dense (perfect-hash)
or the sort-based route, the fused aggregate -> ORDER BY/LIMIT step, the
identity pass over keys certified unique, and scalar aggregates.

Route choice, as in the JAX package: a dense layout from static key
ranges, else from a device min/max probe of the keys; without one, the
sort route, whose group buffer has a cap from ``default_max_groups``, the
key-range product and a sampled NDV estimate (Chao84).  A sort-route
group count above the cap widens the buffer and runs again, unless
``exec.allow_retry`` is off.  Between 512 and 4096 dense entries over at
least 2^16 rows either route can win: the first runs of a plan time both
(``feedback.py``), later runs take the faster.

Fragment-streamed aggregation: a scalar aggregate, or a GROUP BY whose
dense layout comes from fragment stats, over a scan whose used columns
exceed the scan budget (``exec.scan_stream_bytes``, else half the device
cache budget), or run under a watchdog time limit, reads the scan chunk
by chunk (runs of whole fragments), each chunk copied to the device
outside the device cache.  Each chunk's partial slots come from the same
histograms as the whole-column route (K1, K3, K4 on the card) and merge
by sum, min or max; the watchdog's deadline is checked between chunks,
after a synchronize."""

from __future__ import annotations

import time as _time
import weakref
from typing import List, Optional

import torch

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from ..parallel.dist_groupby import _COMBINE as _DIST_COMBINE
from . import groupby as gb
from . import ranges as rng
from . import sort as srt
from .codecache import chain_key
from .common import ExecTable, _PrunedScanColumns, _broadcast, _schema_sig
from .explain import _node_line
from .feedback import synchronize, timed_sync
from .masked import MaskedCol, combine_masks, torch_dtype
from .scalar import ExecError

# aggregate kinds with a closed form over a single-row group (the
# identity pass over certified-unique keys)
_IDENTITY_KINDS = frozenset({
    ir.AggKind.COUNT, ir.AggKind.SUM, ir.AggKind.AVG, ir.AggKind.MIN,
    ir.AggKind.MAX, ir.AggKind.SINGLE_VALUE, ir.AggKind.SAMPLE,
})

# how each slot of a mergeable aggregate merges across fragment-stream
# chunks: the distributed merge rules but the t-digest's re-clustering;
# an empty group's MIN/MAX slot holds the identity
_COMBINE = {k: v for k, v in _DIST_COMBINE.items()
            if k != ir.AggKind.APPROX_QUANTILE}
_MERGE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}

# dense entry counts where both group-by routes are timed (the JAX
# package's gate: above 512 entries, up to its one-hot segment limit)
_TUNE_ENTRIES = (512, 4096)
_TUNE_MIN_ROWS = 1 << 16


def _perfect_key_type(typ: t.Type) -> bool:
    return (typ.is_integer() or typ.is_boolean()
            or typ.is_dict_encoded_string()
            or (typ.is_date() and typ.unit == t.TimeUnit.DAY))  # type: ignore[attr-defined]


class AggExecMixin:
    def _exec_aggregate(self, node: nd.Aggregate, results) -> ExecTable:
        source, chain, src_node = self._resolve_chain_windowed(
            node.inputs[0], results)
        if not node.keys:
            return self._agg_nogroup(node, source, chain, src_node)
        if source.nrows == 0:
            return ExecTable.empty(node.fields, node.output_types,
                                   self.device)
        out = self._agg_identity_table(node, source, chain, src_node)
        if out is not None:
            return out
        stream = self._grouped_stream_plan(node, source, chain, src_node)
        if stream is not None:
            return self._exec_aggregate_fragmented(node, source, chain,
                                                   src_node, *stream)
        if self._mesh is not None:
            out = self._exec_aggregate_dist_any(node, source, chain,
                                                src_node)
            if out is not None:
                return out
        cols, exists, n, nbuf = self._group(node, source, chain, src_node,
                                            need_count=True, tune=True)
        # group-by output keys are distinct by construction: a downstream
        # GROUP BY covering them is an identity pass
        uniq = (frozenset(range(len(node.keys))),)
        if n is None:  # dense route: the buffer and its existence mask
            return ExecTable(list(node.fields), list(node.output_types),
                             cols, nbuf, exists, unique_sets=uniq)
        cols = [MaskedCol(c.data[:n], c.mask[:n] if c.mask is not None
                          else None) for c in cols]
        return ExecTable(list(node.fields), list(node.output_types), cols, n,
                         unique_sets=uniq)

    def _group(self, node: nd.Aggregate, source: ExecTable, chain, src_node,
               need_count: bool, tune: bool = False):
        """Group the source on the dense or the sort route: (columns,
        exists, n, entries of the buffer).  On the sort route a group count
        above the buffer cap widens the buffer and groups again.  ``n`` is
        the group count read on the host (a sync): None on the dense route,
        and on the sort route unless ``need_count`` or the buffer can
        overflow (it cannot when it covers every row or the whole
        key-range product).  ``tune``: a dense layout in the tuning window
        takes the route that measured faster (``_tune_route``)."""
        used = self._agg_used(node, chain, src_node)
        layout, key_ranges = self._layout_and_ranges(node, source, chain,
                                                     src_node)
        cap, prod = self._sort_cap(node, source, chain, src_node, layout,
                                   key_ranges)
        tune_sig = None
        if tune and layout is not None:
            tune_sig, route = self._tune_route(node, source, chain, used,
                                               layout)
            if route == "sort":
                cap = min(source.nrows, layout.entry_count)
                layout = None
        can_overflow = (cap < source.nrows and (prod is None or prod > cap))
        read = layout is None and (need_count or can_overflow)
        args = ([source.columns[i] for i in used], source.row_mask)
        self._groupby_attempts = 0
        while True:
            self._groupby_attempts += 1
            fn = self._group_step(node, source, chain, src_node, used,
                                  layout, key_ranges, cap)
            if tune_sig is not None:  # explore: time this route warm
                (key_cols, agg_cols, exists, n_groups), secs = timed_sync(
                    fn, *args, device=self.device)
                self._feedback.record(tune_sig, route, secs)
                tune_sig = None
            else:
                key_cols, agg_cols, exists, n_groups = fn(*args)
            n = int(n_groups) if read else None  # host sync: group count
            if n is None or n <= cap:
                break
            cap = self._widen(n, cap, source.nrows)
        cols = list(key_cols) + list(agg_cols)
        if layout is not None:
            return cols, exists, None, layout.entry_count
        self._groupby_cap = cap
        return cols, exists, n, cap

    def _tune_route(self, node: nd.Aggregate, source: ExecTable, chain,
                    used, layout):
        """(signature to record the time under, or None; route) of a
        GROUP BY with a dense layout: inside the tuning window the first
        runs of a plan explore "perfect", then "sort", each timed;
        later runs take the faster."""
        if (not self._feedback.enabled or self._mesh is not None
                or not _TUNE_ENTRIES[0] < layout.entry_count
                <= _TUNE_ENTRIES[1]
                or source.nrows < _TUNE_MIN_ROWS):
            return None, "perfect"
        sig = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"tunegrp/u{used}/n{source.nrows}")
        route, measure = self._feedback.choose(sig, ["perfect", "sort"])
        return (sig if measure else None), route

    def _widen(self, n: int, cap: int, nrows: int) -> int:
        """The cap of the next attempt after ``n`` groups overflowed
        ``cap``."""
        if not self.config.exec.allow_retry:
            raise ExecError(f"group count {n} exceeds buffer cap {cap} "
                            f"(exec.allow_retry disabled)")
        return min(nrows, n)

    def _group_step(self, node: nd.Aggregate, source: ExecTable, chain,
                    src_node, used, layout, key_ranges, cap: int):
        """The cached step grouping the source: fn(sub_cols, row_mask) ->
        (key_cols, agg_cols, exists, n_groups); n_groups is None on the
        dense route."""
        nrows0 = source.nrows
        size = len(source.fields)
        route = (f"layout={layout.mins}/{layout.sizes}" if layout is not None
                 else f"sortcap={cap}/rng={key_ranges}")
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"{route}u{used}/n{nrows0}")

        def build():
            def fn(sub_cols, row_mask):
                resolve, rm = self._terminal_env(src_node, sub_cols, used,
                                                 size, chain, row_mask,
                                                 nrows0)
                keys = [_broadcast(self.scalar.evaluate(k, resolve), nrows0)
                        for k in node.keys]
                specs = self._build_specs(node, resolve, nrows0)
                if layout is not None:
                    return (*gb.groupby_perfect(keys, layout, specs, rm),
                            None)
                return gb.groupby_sort(keys, specs, cap, row_valid=rm,
                                       key_ranges=key_ranges)

            return fn

        return self.code_cache.get_or_build(key, build)

    def _exec_fused_agg_sort(self, sort_node: nd.Sort, node: nd.Aggregate,
                             results) -> Optional[ExecTable]:
        """Aggregate -> Sort (+LIMIT window) as one step: group into the
        buffer, order its rows with dead groups last (a stable
        lexicographic top-n: ties keep the lower group index first), and
        emit a validity window instead of a compaction."""
        if self._mesh is not None:
            return self._exec_fused_agg_sort_dist(sort_node, node, results)
        source, chain, src_node = self._resolve_chain(node.inputs[0], results)
        if source.nrows == 0:
            return None
        ident = self._agg_identity_table(node, source, chain, src_node)
        if ident is not None:
            # the Sort runs over the (masked) identity table
            results[node.id] = ident
            if self._analyze:
                self._fused_rows[_node_line(node)] = ident.live_count()
            return self._exec_sort(sort_node, results)
        if self._grouped_stream_plan(node, source, chain, src_node):
            return None  # the aggregate streams, then the Sort runs
        cols, exists, _n, nbuf = self._group(node, source, chain, src_node,
                                             need_count=False)
        if self._analyze:  # EXPLAIN ANALYZE: the aggregate's groups
            self._fused_rows[_node_line(node)] = exists.sum()
        return self._sort_group_buffer(sort_node, node, cols, exists, nbuf)

    def _sort_group_buffer(self, sort_node: nd.Sort, node: nd.Aggregate,
                           cols, exists, nbuf: int) -> ExecTable:
        """The Sort's rows of a group buffer of ``nbuf`` entries: live
        groups first in sort order (a stable lexicographic top-n), under a
        LIMIT/OFFSET validity window."""
        out_types = list(node.output_types)
        sf = sort_node.sort_fields
        limit, offset = sort_node.limit, sort_node.offset
        topn = (offset + limit
                if limit is not None and 0 < offset + limit < nbuf else nbuf)
        scols = [self._sortable(cols[f.field_index], out_types[f.field_index])
                 for f in sf]
        perm = srt.lex_topn(srt.sort_keys_int64(
            scols, [f.desc for f in sf], [f.nulls_first for f in sf]),
            topn, exists)
        out = [MaskedCol(c.data[perm],
                         c.mask[perm] if c.mask is not None else None)
               for c in cols]
        return ExecTable(list(sort_node.fields), list(sort_node.output_types),
                         out, topn, _window(exists.sum(), topn, limit, offset))

    # -- the identity pass over certified-unique keys ----------------------
    def _identity_applicable(self, node: nd.Aggregate, source: ExecTable,
                             chain, src_node) -> bool:
        """The keys cover a set of source columns certified unique, and
        every aggregate has a closed single-row form."""
        if (chain or not node.keys or not source.unique_sets
                or self._mesh is not None):
            return False
        if not all(isinstance(k, ir.ColumnRef) and k.node is src_node
                   for k in node.keys):
            return False
        key_idx = {k.index for k in node.keys}
        if not any(s <= key_idx for s in source.unique_sets):
            return False
        return all(a.kind in _IDENTITY_KINDS
                   and getattr(a, "operand2", None) is None
                   for a in node.aggs)

    def _identity_cols(self, node: nd.Aggregate, resolve,
                       nrows0: int) -> List[MaskedCol]:
        """Output columns of the identity pass: keys pass through, each
        aggregate takes its single-row value (COUNT(*) = 1, SUM x = x...)."""
        cols = [_broadcast(self.scalar.evaluate(k, resolve), nrows0)
                for k in node.keys]
        for a, oty in zip(node.aggs, node.output_types[len(node.keys):]):
            od = torch_dtype(oty.physical_dtype())
            v = (None if a.operand is None else
                 _broadcast(self.scalar.evaluate(a.operand, resolve), nrows0))
            if a.kind == ir.AggKind.COUNT:
                data = (torch.ones((nrows0,), dtype=od, device=self.device)
                        if v is None or v.mask is None else v.mask.to(od))
                cols.append(MaskedCol(data))
            else:
                cols.append(MaskedCol(v.data.to(od), v.mask))
        return cols

    def _agg_identity_table(self, node: nd.Aggregate, source: ExecTable,
                            chain, src_node) -> Optional[ExecTable]:
        """GROUP BY over certified-unique keys: every live row is its own
        group, so grouping is an identity pass and the row mask rides
        along uncompacted."""
        if not self._identity_applicable(node, source, chain, src_node):
            return None
        cols = self._identity_cols(node, lambda ref: source.columns[ref.index],
                                   source.nrows)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         source.nrows, source.row_mask,
                         unique_sets=(frozenset(range(len(node.keys))),))

    # ------------------------------------------------------------------
    def _agg_nogroup(self, node: nd.Aggregate, source: ExecTable,
                     chain, src_node) -> ExecTable:
        used = self._agg_used(node, chain, src_node)
        plan = self._fragment_stream_plan(node, source, chain, src_node,
                                          used)
        if plan is not None:
            return self._exec_aggregate_fragmented(
                node, source, chain, src_node, used, None, plan)
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"nogroup/u{used}/n{source.nrows}")
        nrows0 = source.nrows
        size = len(source.fields)

        def build():
            def fn(sub_cols, row_mask):
                resolve, rm = self._terminal_env(src_node, sub_cols, used,
                                                 size, chain, row_mask,
                                                 nrows0)
                specs = self._build_specs(node, resolve, nrows0)
                scalars = gb.nogroup_agg(specs, nrows0, rm, self.device)
                # one row; TOP_K/BOTTOM_K give one array of k elements
                return [MaskedCol(s.data.reshape((1,) + s.data.shape),
                                  s.mask.reshape((1,) + s.mask.shape)
                                  if s.mask is not None else None)
                        for s in scalars]

            return fn

        fn = self.code_cache.get_or_build(key, build)
        cols = fn([source.columns[i] for i in used], source.row_mask)
        return ExecTable(list(node.fields), list(node.output_types), cols, 1)

    # -- fragment-streamed aggregation --------------------------------------
    def _grouped_stream_plan(self, node: nd.Aggregate, source: ExecTable,
                             chain, src_node):
        """(used, layout, plan) when a GROUP BY streams: its dense layout
        comes from fragment stats (a device probe of the keys would move
        the whole columns) and ``_fragment_stream_plan`` takes the scan;
        else None."""
        if not isinstance(src_node, nd.Scan):
            return None
        ranges = self._static_ranges(node)
        if ranges is None:
            return None
        layout = gb.choose_perfect_layout([k.type for k in node.keys],
                                          ranges, self._layout_limit)
        if layout is None:
            return None
        used = self._agg_used(node, chain, src_node)
        plan = self._fragment_stream_plan(node, source, chain, src_node,
                                          used)
        return None if plan is None else (used, layout, plan)

    def _fragment_stream_plan(self, node: nd.Aggregate, source: ExecTable,
                              chain, src_node, used):
        """(table, chunks) when the aggregate streams over its scan: chunks
        are runs of whole fragments, each up to the budget's rows (one
        fragment each under a watchdog time limit), the last one maybe
        shorter; None when the whole columns go to the device."""
        # a dist scan's row mask is its shard padding: chunks re-slice
        # the host table.  A process-local table does not stream: its
        # ranks hold different rows, and would stream different chunks
        if ((source.row_mask is not None and self._mesh is None)
                or isinstance(source.columns, _PrunedScanColumns)
                or not isinstance(src_node, nd.Scan)
                or getattr(src_node.table, "process_local", False)):
            return None
        if not all(a.kind in _COMBINE and not a.distinct
                   for a in node.aggs):
            return None
        # a window function sees all rows: per chunk it would restart
        from .optimizer import _contains_window

        exprs = list(node.keys) + [a.operand for a in node.aggs
                                   if a.operand is not None]
        for n_ in chain:
            exprs += (n_.exprs if isinstance(n_, nd.Project)
                      else [n_.condition])
        if any(_contains_window(e) for e in exprs):
            return None
        table = src_node.table
        frags = table.fragments
        if len(frags) < 2 or table.nrows == 0:
            return None
        bpr = 0  # bytes a row over the used columns
        for i in used:
            col = table.column(source.fields[i])
            bpr += col.data.dtype.itemsize + (col.validity is not None)
        budget = (self.config.exec.scan_stream_bytes
                  or self.config.storage.device_cache_budget_bytes // 2)
        wd = self.config.exec.watchdog
        timed = bool(wd.enable and wd.time_limit_ms)
        if bpr * table.nrows <= budget and not timed:
            return None
        target = max(1, budget // max(bpr, 1))
        if timed:
            target = min(target, self.config.storage.fragment_size)
        chunks = []
        start, rows = None, 0
        for r0, r1 in frags:
            if start is None:
                start, rows = r0, r1 - r0
            elif rows + (r1 - r0) > target:
                chunks.append((start, r0))
                start, rows = r0, r1 - r0
            else:
                rows += r1 - r0
        chunks.append((start, frags[-1][1]))
        return (table, chunks) if len(chunks) >= 2 else None

    def _exec_aggregate_fragmented(self, node: nd.Aggregate,
                                   source: ExecTable, chain, src_node,
                                   used, layout, plan) -> ExecTable:
        """Aggregate over the scan chunk by chunk: each chunk's columns
        are copied to the device (not into the device cache), run
        through the chain, and reduced to partial slots over the dense
        layout (or one group), which merge into the running slots."""
        table, chunks = plan
        self._frag_stream_chunks = len(chunks)
        n = layout.entry_count if layout is not None else 1
        size = len(source.fields)
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"fragstream/{n}/u{used}"
                        + (f"/l{layout.mins}{layout.sizes}" if layout
                           else ""))

        def build():
            def fn(sub_cols, rows, pad_rm=None):
                resolve, rm = self._terminal_env(src_node, sub_cols, used,
                                                 size, chain, pad_rm, rows)
                specs = self._build_specs(node, resolve, rows)
                if layout is not None:
                    keys = [_broadcast(self.scalar.evaluate(k, resolve),
                                       rows) for k in node.keys]
                    gid, _ = gb.perfect_gid(keys, layout, rm)
                elif rm is None:
                    gid = torch.zeros((rows,), dtype=torch.int32,
                                      device=self.device)
                else:
                    gid = torch.where(rm, 0, 1).to(torch.int32)
                return gb.reduce_slots(specs, gid, n)

            return fn

        fn = self.code_cache.get_or_build(key, build)
        acc = counts = None
        fused_rows = {}
        for r0, r1 in chunks:
            sub_cols = [self._chunk_column(table.column(source.fields[i]),
                                           r0, r1) for i in used]
            if self._mesh is None:
                parts, cnt = fn(sub_cols, r1 - r0)
                slots = [r.slots for r in parts]
                del parts
            else:
                slots, cnt = self._chunk_slots_sharded(node, fn, sub_cols,
                                                       r1 - r0)
            if acc is None:
                acc, counts = slots, cnt
            else:
                acc = [[_MERGE[rule](a, b) for rule, a, b
                        in zip(_COMBINE[agg.kind], acc_s, new_s)]
                       for agg, acc_s, new_s in zip(node.aggs, acc, slots)]
                counts = counts + cnt
            for line, rows in self._fused_rows.items():  # EXPLAIN ANALYZE
                fused_rows[line] = fused_rows.get(line, 0) + rows
            del sub_cols  # before the next chunk's copies
            self._check_watchdog_budget()
        self._fused_rows.update(fused_rows)
        agg_cols = [gb.AggResult(list(slots)).finalize(
            gb.AggSpec(a.kind, None, a.type, a.distinct, a.arg1,
                       a.interpolation))
            for a, slots in zip(node.aggs, acc)]
        if layout is None:
            return ExecTable(list(node.fields), list(node.output_types),
                             agg_cols, 1)
        key_cols = gb.perfect_key_columns_from_types(
            [k.type for k in node.keys], layout, self.device)
        return ExecTable(list(node.fields), list(node.output_types),
                         key_cols + agg_cols, n, counts > 0,
                         unique_sets=(frozenset(range(len(node.keys))),))

    def _chunk_slots_sharded(self, node: nd.Aggregate, fn, sub_cols,
                             rows: int):
        """A dist session's stream chunk: split over the shards (padded
        to the mesh), each shard's partial slots, merged by the slots'
        rules through the mesh's collectives."""
        from ..parallel.dist_groupby import _REDUCE
        from ..utils import commlog

        shards, rms, rps = self._split_cols(sub_cols, None, rows)
        per = []
        for s in range(self._mesh.local_size):
            with self._on_shard(s):
                per.append(fn([c[s] for c in shards], rps,
                              None if rms is None else rms[s]))
        slots = [[_REDUCE[rule]([p[0][i].slots[j] for p in per])[0]
                  for j, rule in enumerate(_COMBINE[agg.kind])]
                 for i, agg in enumerate(node.aggs)]
        return slots, commlog.psum([p[1] for p in per])[0]

    def _chunk_column(self, col, r0: int, r1: int) -> MaskedCol:
        """Rows [r0, r1) of a table column, copied to the device."""
        from ..storage.table import to_device

        return MaskedCol(to_device(col.data[r0:r1], self.device),
                         None if col.validity is None
                         else to_device(col.validity[r0:r1], self.device))

    def _check_watchdog_budget(self) -> None:
        """The watchdog's deadline, checked between stream chunks after a
        synchronize, so it measures the device's progress and not the
        host's queueing."""
        if self._deadline is None:
            return
        synchronize(self.device)
        if _time.monotonic() > self._deadline:
            raise ExecError("watchdog: query time budget exceeded")

    # ------------------------------------------------------------------
    def _agg_used(self, node: nd.Aggregate, chain, src_node) -> List[int]:
        terminal = list(node.keys) + [
            a.operand for a in node.aggs if a.operand is not None] + [
            a.operand2 for a in node.aggs
            if getattr(a, "operand2", None) is not None]
        return self._used_columns(src_node, chain, terminal)

    def _terminal_env(self, src_node, sub_cols, used, size, chain, row_mask,
                      nrows):
        """(resolver over the chain's last node, combined row mask)."""
        source_cols = self._expand_cols(sub_cols, used, size)
        env, _final, rm = self._chain_env(src_node, source_cols, chain,
                                          row_mask, nrows=nrows)
        return (lambda ref: env[ref.node.id][ref.index]), rm

    def _build_specs(self, node: nd.Aggregate, resolve,
                     nrows: int) -> List[gb.AggSpec]:
        specs = []
        for agg in node.aggs:
            operand = None
            if agg.operand is not None:
                operand = _broadcast(
                    self.scalar.evaluate(agg.operand, resolve), nrows)
            operand2 = None
            if getattr(agg, "operand2", None) is not None:
                operand2 = _broadcast(
                    self.scalar.evaluate(agg.operand2, resolve), nrows)
            specs.append(self._agg_spec(agg, operand, operand2))
        return specs

    def _agg_spec(self, agg, operand, operand2) -> gb.AggSpec:
        """An aggregate's AggSpec over evaluated operands (a distributed
        route's operands are lists of shard columns), with the session's
        sketch sizes."""
        g = self.config.exec.group_by
        return gb.AggSpec(
            agg.kind, operand, agg.type, agg.distinct, agg.arg1,
            agg.interpolation, operand2, hll_p=g.hll_precision,
            hll_budget=g.hll_register_budget, td_c=g.tdigest_centroids,
            td_budget=g.tdigest_centroid_budget)

    # -- layout, key ranges and the group cap ------------------------------
    def _static_ranges(self, node: nd.Aggregate):
        """The keys' ranges from fragment stats, or None when a key is no
        perfect-hash type or has no static range."""
        if not all(_perfect_key_type(k.type) for k in node.keys):
            return None
        ranges = [rng.infer_range(k) for k in node.keys]
        return ranges if all(r is not None for r in ranges) else None

    def _layout_and_ranges(self, node: nd.Aggregate, source: ExecTable,
                           chain, src_node):
        """(dense layout or None, key ranges or None).  Static ranges come
        back even when the layout is refused for its size, so the sort
        route can pack the keys; keys that stats cannot bound are probed
        on the device."""
        if not all(_perfect_key_type(k.type) for k in node.keys):
            return None, None
        ranges = self._static_ranges(node)
        if ranges is not None:
            layout = gb.choose_perfect_layout([k.type for k in node.keys],
                                              ranges, self._layout_limit)
            if all(lo is not None and hi is not None
                   for lo, hi, _ in ranges):
                return layout, tuple((int(lo), int(hi), bool(nul))
                                     for lo, hi, nul in ranges)
            if layout is not None:
                return layout, None
        return self._probed_layout(node, source, chain, src_node)

    @property
    def _layout_limit(self) -> int:
        return self.config.exec.group_by.perfect_hash_entries_limit

    def _cached(self, key: str, objs, compute):
        """``compute()``, cached under ``key`` while the tensors ``objs``
        (None allowed) are alive."""
        hit = self._probe_cache.get(key)
        if hit is not None and all(
                (r() if r is not None else None) is o
                for r, o in zip(hit[0], objs)):
            return hit[1]
        value = compute()
        self._probe_cache[key] = (
            tuple(None if o is None else weakref.ref(o) for o in objs), value)
        return value

    def _probed_layout(self, node: nd.Aggregate, source: ExecTable, chain,
                       src_node):
        """(layout, key ranges) from one device min/max pass over the keys
        (a host sync); over a process-local scan, each rank's bounds
        combined over every rank."""
        from .dist_exec import _is_local
        from ..utils import commlog

        local = _is_local(source)
        rm0, nrows0 = ((self._local_frame(source)) if local
                       else (source.row_mask, source.nrows))
        used = self._used_columns(src_node, chain, list(node.keys))
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"rangeprobe/n{source.nrows}")

        def probe():
            resolve, rm = self._terminal_env(
                src_node, [source.columns[i] for i in used], used,
                len(source.fields), chain, rm0, nrows0)
            bounds = []
            for kx in node.keys:
                v = _broadcast(self.scalar.evaluate(kx, resolve), nrows0)
                data = v.data.to(torch.int64)
                live = combine_masks(v.mask, rm)
                if live is not None:
                    big = torch.iinfo(torch.int64)
                    lo = torch.where(live, data, big.max).min()
                    hi = torch.where(live, data, big.min).max()
                else:
                    lo, hi = data.min(), data.max()
                bounds.append(torch.stack([lo, hi]))
            bounds = torch.stack(bounds)
            if local:
                every = torch.stack(commlog.all_shards([bounds]))
                bounds = torch.stack([every[:, :, 0].min(0).values,
                                      every[:, :, 1].max(0).values], 1)
            ranges = []
            for (lo_i, hi_i), k in zip(bounds.tolist(), node.keys):
                if lo_i > hi_i:  # no live rows
                    lo_i, hi_i = 0, 0
                ranges.append((int(lo_i), int(hi_i), k.type.nullable))
            layout = gb.choose_perfect_layout([k.type for k in node.keys],
                                              ranges, self._layout_limit)
            return layout, tuple(ranges)

        return self._cached(
            key, [source.columns[i].data for i in used] + [source.row_mask],
            probe)

    def _sort_cap(self, node: nd.Aggregate, source: ExecTable, chain,
                  src_node, layout, key_ranges):
        """(group buffer cap of the sort route, key-range product or
        None): the rows, ``default_max_groups``, the product of the key
        ranges (+1 NULL slot each) and, for loosely bounded keys over
        enough rows, three times the sampled NDV estimate."""
        nrows = source.nrows
        g = self.config.exec.group_by
        cap = min(nrows, g.default_max_groups)
        prod = None
        if key_ranges is not None:
            prod = 1
            for lo, hi, _nul in key_ranges:
                prod *= hi - lo + 2
                if prod > cap:
                    break
            cap = min(cap, max(prod, 1))
        self._ndv_estimate = None
        if (layout is None and cap > max(1 << 20, nrows // 2)
                and nrows >= g.ndv_sample_min_rows):
            est = self._estimate_ndv_sample(node, source, chain, src_node)
            if est is not None:
                self._ndv_estimate = est
                cap = min(cap, max(256, est * 3))
        return cap, prod

    def _estimate_ndv_sample(self, node: nd.Aggregate, source: ExecTable,
                             chain, src_node) -> Optional[int]:
        """Chao84 estimate of the number of distinct key tuples,
        ``u + f1^2 / (2 f2)``, from a strided sample of
        ``ndv_sample_size`` rows: the chain and the key expressions run
        on the sample, and only their tuple counts reach the host.  A
        tuple is the keys' values and null flags; it counts where the row
        mask is set.  Cached while the input tensors are alive; None when
        sampling is off."""
        s_cfg = int(self.config.exec.group_by.ndv_sample_size)
        nrows = source.nrows
        if s_cfg <= 0 or nrows == 0:
            return None
        s = min(s_cfg, nrows)
        stride = max(1, nrows // s)
        used = self._used_columns(src_node, chain, list(node.keys))
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"ndvsample/u{used}/s{s}/st{stride}/n{nrows}")

        def estimate():
            t0 = _time.perf_counter()
            try:
                return sample()
            finally:
                self._ndv_sample_seconds += _time.perf_counter() - t0

        def sample():
            if self._mesh is not None:
                samp, rm0 = self._strided_sample(source, used, stride, s)
            else:
                samp = [MaskedCol(c.data[::stride][:s],
                                  c.mask[::stride][:s] if c.mask is not None
                                  else None)
                        for c in (source.columns[i] for i in used)]
                rm0 = (source.row_mask[::stride][:s]
                       if source.row_mask is not None else None)
            resolve, rmx = self._terminal_env(src_node, samp, used,
                                              len(source.fields), chain,
                                              rm0, s)
            parts = []
            for kx in node.keys:
                c = _broadcast(self.scalar.evaluate(kx, resolve), s)
                parts.append(gb._orderable_int64(c.data))
                if c.mask is not None:
                    parts.append(c.mask.to(torch.int64))
            tuples = torch.stack(parts, dim=1)
            if rmx is not None:
                tuples = tuples[rmx]
            if tuples.shape[0] == 0:
                return None
            _, counts = torch.unique(tuples, dim=0, return_counts=True)
            u = counts.numel()
            f1, f2 = torch.stack([(counts == 1).sum(),
                                  (counts == 2).sum()]).tolist()
            est = u + (f1 * f1) / (2.0 * max(f2, 1))
            return int(min(max(est, u), nrows))

        return self._cached(
            key + "|est",
            [source.columns[i].data for i in used] + [source.row_mask],
            estimate)


def _window(live: torch.Tensor, nbuf: int, limit: Optional[int],
            offset: int) -> torch.Tensor:
    """Validity of output positions [0, nbuf) under LIMIT/OFFSET, where
    the first ``live`` positions hold live rows."""
    pos = torch.arange(nbuf, dtype=torch.int64, device=live.device)
    end = live if limit is None else torch.clamp(live, max=offset + limit)
    return (pos >= offset) & (pos < end)
