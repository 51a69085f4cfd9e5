"""Aggregate steps of the Executor (counterpart of the perfect-layout
routes of hdk_tpu/exec/agg_exec.py): dense GROUP BY, the fused
aggregate -> ORDER BY/LIMIT step, scalar aggregates, and the choice of
the perfect layout from static key ranges or a device min/max probe."""

from __future__ import annotations

import weakref
from typing import List, Optional

import torch

from .. import types as t
from ..ir import expr as ir
from ..ir import node as nd
from . import groupby as gb
from . import ranges as rng
from . import sort as srt
from .codecache import chain_key
from .common import ExecTable, _broadcast, _schema_sig
from .masked import MaskedCol, combine_masks


def _perfect_key_type(typ: t.Type) -> bool:
    return (typ.is_integer() or typ.is_boolean()
            or typ.is_dict_encoded_string()
            or (typ.is_date() and typ.unit == t.TimeUnit.DAY))  # type: ignore[attr-defined]


class AggExecMixin:
    def _exec_aggregate(self, node: nd.Aggregate, results) -> ExecTable:
        source, chain, src_node = self._resolve_chain(node.inputs[0], results)
        if not node.keys:
            return self._agg_nogroup(node, source, chain, src_node)
        if source.nrows == 0:
            return ExecTable.empty(node.fields, node.output_types,
                                   self.device)
        layout = self._perfect_layout(node, source, chain, src_node)
        used = self._agg_used(node, chain, src_node)
        self._refuse_fragment_stream(node, source, chain, src_node, used)
        nrows0 = source.nrows
        size = len(source.fields)
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"layout={layout.mins}/{layout.sizes}u{used}"
                        + f"/n{nrows0}")

        def build():
            def fn(sub_cols, row_mask):
                resolve, rm = self._terminal_env(src_node, sub_cols, used,
                                                 size, chain, row_mask,
                                                 nrows0)
                keys = [_broadcast(self.scalar.evaluate(k, resolve), nrows0)
                        for k in node.keys]
                specs = self._build_specs(node, resolve, nrows0)
                return gb.groupby_perfect(keys, layout, specs, rm)

            return fn

        fn = self.code_cache.get_or_build(key, build)
        key_cols, agg_cols, exists = fn(
            [source.columns[i] for i in used], source.row_mask)
        return ExecTable(list(node.fields), list(node.output_types),
                         list(key_cols) + list(agg_cols),
                         layout.entry_count, exists)

    def _exec_fused_agg_sort(self, sort_node: nd.Sort, node: nd.Aggregate,
                             results) -> Optional[ExecTable]:
        """Aggregate -> Sort (+LIMIT window) as one step: group into the
        dense buffer, order its rows with dead groups last, and emit a
        validity window instead of a compaction."""
        source, chain, src_node = self._resolve_chain(node.inputs[0], results)
        if source.nrows == 0:
            return None
        layout = self._perfect_layout(node, source, chain, src_node)
        used = self._agg_used(node, chain, src_node)
        self._refuse_fragment_stream(node, source, chain, src_node, used)
        nrows0 = source.nrows
        size = len(source.fields)
        out_types = list(node.output_types)
        sf = sort_node.sort_fields
        descs = [f.desc for f in sf]
        nfs = [f.nulls_first for f in sf]
        limit, offset = sort_node.limit, sort_node.offset
        nbuf = layout.entry_count
        topn = (offset + limit
                if limit is not None and 0 < offset + limit < nbuf else nbuf)
        key = chain_key(
            _schema_sig(source), chain, node,
            self._dict_generation_sig(chain, node)
            + f"layout={layout.mins}/{layout.sizes}u{used}|fsort"
            + f"{[(f.field_index, f.desc, f.nulls_first) for f in sf]}"
            + f"/{limit}/{offset}/n{nrows0}")

        def build():
            def fn(sub_cols, row_mask):
                resolve, rm = self._terminal_env(src_node, sub_cols, used,
                                                 size, chain, row_mask,
                                                 nrows0)
                keys = [_broadcast(self.scalar.evaluate(k, resolve), nrows0)
                        for k in node.keys]
                specs = self._build_specs(node, resolve, nrows0)
                kc, ac, exists = gb.groupby_perfect(keys, layout, specs, rm)
                cols = list(kc) + list(ac)
                scols = [self._sortable(cols[f.field_index],
                                        out_types[f.field_index])
                         for f in sf]
                perm = srt.lex_topn(srt.sort_keys_int64(scols, descs, nfs),
                                    topn, exists)
                out = [MaskedCol(c.data[perm],
                                 c.mask[perm] if c.mask is not None else None)
                       for c in cols]
                return out, _window(exists.sum(), topn, limit, offset)

            return fn

        fn = self.code_cache.get_or_build(key, build)
        cols, window = fn([source.columns[i] for i in used], source.row_mask)
        return ExecTable(list(sort_node.fields), list(sort_node.output_types),
                         cols, topn, window)

    def _agg_nogroup(self, node: nd.Aggregate, source: ExecTable,
                     chain, src_node) -> ExecTable:
        used = self._agg_used(node, chain, src_node)
        self._refuse_fragment_stream(node, source, chain, src_node, used)
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
                return [MaskedCol(s.data.reshape(1),
                                  s.mask.reshape(1) if s.mask is not None
                                  else None)
                        for s in scalars]

            return fn

        fn = self.code_cache.get_or_build(key, build)
        cols = fn([source.columns[i] for i in used], source.row_mask)
        return ExecTable(list(node.fields), list(node.output_types), cols, 1)

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
            specs.append(gb.AggSpec(agg.kind, operand, agg.type,
                                    agg.distinct, operand2))
        return specs

    def _refuse_fragment_stream(self, node, source, chain, src_node,
                                used) -> None:
        """The JAX package streams a scan fragment by fragment when its
        used columns exceed the scan budget, or when a watchdog time limit
        is set; that route is not ported."""
        if not isinstance(src_node, nd.Scan) or source.row_mask is not None:
            return
        table = src_node.table
        if len(table.fragments) < 2 or table.nrows == 0:
            return
        bpr = sum(table.column(source.fields[i]).data.dtype.itemsize
                  + (table.column(source.fields[i]).validity is not None)
                  for i in used)
        budget = (self.config.exec.scan_stream_bytes
                  or self.config.storage.device_cache_budget_bytes // 2)
        wd = self.config.exec.watchdog
        if bpr * table.nrows > budget or (wd.enable and wd.time_limit_ms):
            raise NotImplementedError(
                "fragment-streamed aggregation (scan over the device budget "
                "or a watchdog time limit) is not ported yet (ROADMAP A4)")

    # ------------------------------------------------------------------
    def _perfect_layout(self, node: nd.Aggregate, source: ExecTable, chain,
                        src_node) -> gb.PerfectHashLayout:
        """The dense layout from static key ranges, else from a device
        min/max probe of the keys; raises where there is none."""
        layout = None
        if all(_perfect_key_type(k.type) for k in node.keys):
            ranges = [rng.infer_range(k) for k in node.keys]
            bounded = all(r is not None for r in ranges)
            if bounded:
                layout = gb.choose_perfect_layout(
                    [k.type for k in node.keys], ranges, self._layout_limit)
            # a layout refused for its size stays refused; unknown
            # bounds are probed on the device
            if layout is None and (not bounded or any(
                    r[0] is None or r[1] is None for r in ranges)):
                layout = self._probed_layout(node, source, chain, src_node)
        if layout is None:
            raise NotImplementedError(
                "GROUP BY keys without a dense layout need the sort-based "
                "group-by, which is not ported yet (ROADMAP A1)")
        return layout

    @property
    def _layout_limit(self) -> int:
        return self.config.exec.group_by.perfect_hash_entries_limit

    def _probed_layout(self, node: nd.Aggregate, source: ExecTable, chain,
                       src_node) -> Optional[gb.PerfectHashLayout]:
        """Key ranges from one device min/max pass (a host sync), cached
        while the same input tensors are alive."""
        used = self._used_columns(src_node, chain, list(node.keys))
        key = chain_key(_schema_sig(source), chain, node,
                        self._dict_generation_sig(chain, node)
                        + f"rangeprobe/n{source.nrows}")
        objs = [source.columns[i].data for i in used] + [source.row_mask]
        hit = self._probe_cache.get(key)
        if hit is not None and all(
                (r() if r is not None else None) is o
                for r, o in zip(hit[0], objs)):
            return hit[1]
        resolve, rm = self._terminal_env(
            src_node, [source.columns[i] for i in used], used,
            len(source.fields), chain, source.row_mask, source.nrows)
        bounds = []
        for kx in node.keys:
            v = _broadcast(self.scalar.evaluate(kx, resolve), source.nrows)
            data = v.data.to(torch.int64)
            live = combine_masks(v.mask, rm)
            if live is not None:
                big = torch.iinfo(torch.int64)
                lo = torch.where(live, data, big.max).min()
                hi = torch.where(live, data, big.min).max()
            else:
                lo, hi = data.min(), data.max()
            bounds.append(torch.stack([lo, hi]))
        ranges = []
        for (lo_i, hi_i), k in zip(torch.stack(bounds).tolist(), node.keys):
            if lo_i > hi_i:  # no live rows
                lo_i, hi_i = 0, 0
            ranges.append((int(lo_i), int(hi_i), k.type.nullable))
        layout = gb.choose_perfect_layout([k.type for k in node.keys],
                                          ranges, self._layout_limit)
        self._probe_cache[key] = (
            tuple(None if o is None else weakref.ref(o) for o in objs),
            layout)
        return layout


def _window(live: torch.Tensor, nbuf: int, limit: Optional[int],
            offset: int) -> torch.Tensor:
    """Validity of output positions [0, nbuf) under LIMIT/OFFSET, where
    the first ``live`` positions hold live rows."""
    pos = torch.arange(nbuf, dtype=torch.int64, device=live.device)
    end = live if limit is None else torch.clamp(live, max=offset + limit)
    return (pos >= offset) & (pos < end)
