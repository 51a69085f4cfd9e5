"""Distributed execution (counterpart of hdk_tpu/exec/dist_exec.py, the
executor's mixin for multi-device sessions).

A dist session's scan pads its rows to a multiple of the shard count
(the padding dead in the row mask) and shards them: on one card the
shards are ``narrow`` views of the scan's column tensors.  In a
multi-host session every rank holds a replicated table whole and reads
its own shards of it; a process-local table holds each rank's own rows,
padded to a common quota (``_exec_scan_process_local``), and its
gathered view is an all-gather onto every rank.  Steps with a
distributed route read those shards and run their bodies per shard:

  * GROUP BY (``_dist_agg_route``): ``dense_psum`` (a dense layout and
    mergeable aggregates, per-shard partial slots combined by psum),
    ``dense_psum_fused_sort`` (the same, with an ORDER BY/LIMIT over the
    replicated buffer), ``two_phase`` (algebraic aggregates without a
    dense layout), ``shuffled`` (holistic aggregates) and
    ``distinct_split`` (DISTINCT-class aggregates under key skew, chosen
    by a hot-key probe); the JAX package's ``gspmd_dense`` (its Pallas
    opt-in modes) has no counterpart;
  * ORDER BY without a small LIMIT: the sampled range-partition sort;
  * equi-joins: broadcast of a build side up to
    ``dist.broadcast_join_threshold`` rows, else both sides partitioned;
  * window functions with PARTITION BY (``_dist_window_route``
    ``dist_window``; ``gspmd`` where the route declines).

Their Project/Filter chains run per shard.  Every other step reads the
gathered view (``Mesh.gather``, recorded by ``utils/commlog`` as an
all_gather marked as a gather): on one card, the scan's own tensors.
The shuffling routes size their buffers ahead, count overflow and widen
and retry (3 attempts, ``exec.allow_retry``), as the JAX package's
shard bodies must; an exhausted ladder falls back to the single-device
route, never to a short result.  Every rank of a multi-host session
must take the same host decisions: live counts, join capacities, the
hot-key probe and the NDV sample read every rank's shards
(``commlog.all_shards`` / ``all_rows``), never this rank's alone.
"""

from __future__ import annotations

import contextlib
import dataclasses as _dc
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..ir import expr as ir
from ..ir import node as nd
from ..utils import commlog
from ..utils.logger import get_channel
from . import groupby as gb
from .common import ExecTable, _LazyScanColumns, _broadcast
from .masked import MaskedCol, combine_masks, torch_dtype

_LOG = get_channel("exec")

# aggregate kinds the two-phase route merges (algebraic and sketches)
_TWO_PHASE_KINDS = frozenset({
    ir.AggKind.COUNT, ir.AggKind.SUM, ir.AggKind.AVG, ir.AggKind.MIN,
    ir.AggKind.MAX, ir.AggKind.STDDEV_SAMP, ir.AggKind.VAR_SAMP,
    ir.AggKind.SAMPLE, ir.AggKind.SINGLE_VALUE,
    ir.AggKind.APPROX_COUNT_DISTINCT, ir.AggKind.APPROX_QUANTILE,
})


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class _ShardedScanColumns(_LazyScanColumns):
    """A dist scan's columns, padded to a multiple of the shard count.
    ``peek(i)`` gives the padded column to a distributed route, which
    shards it; indexing (a step without a distributed route) gives the
    gathered view and records the gather.  ``local_rows`` (a
    process-local table): the rows every rank pads its own to, and a
    peeked column holds this rank's rows only."""

    def __init__(self, table, fields, device, mesh,
                 local_rows: Optional[int] = None) -> None:
        super().__init__(table, fields, device)
        self._mesh = mesh
        self._peeked: Dict[int, MaskedCol] = {}
        self.local_rows = local_rows

    @property
    def local(self) -> bool:
        return self.local_rows is not None

    def peek(self, i: int) -> MaskedCol:
        got = self._peeked.get(i)
        if got is None:
            col = self._table.column(self._fields[i])
            data, mask = col.device_arrays(self._device)
            if self.local:
                got = _padded_local(col, data, mask, self._mesh,
                                    self.local_rows)
            else:
                got = _padded(col, data, mask, self._mesh)
            self._peeked[i] = got
        return got

    def __getitem__(self, i):
        got = list.__getitem__(self, i)
        if got is None and isinstance(i, int):
            c = self.peek(i)
            view = self._mesh.view_local if self.local else self._mesh.view
            got = MaskedCol(view(c.data), view(c.mask))
            self[i] = got
        return got


def _padded(col, data, mask, mesh) -> MaskedCol:
    """The column's device tensors padded to the mesh (cached on the
    storage column while its device tensor lives)."""
    from ..parallel.mesh import pad_rows

    if data.shape[0] % mesh.size == 0:
        return MaskedCol(data, mask)
    key = (str(data.device), mesh.size)
    cache = getattr(col, "_torch_dist_padded", None)
    if cache is None:
        cache = col._torch_dist_padded = {}
    hit = cache.get(key)
    if hit is not None and hit[0] is data:
        return hit[1]
    out = MaskedCol(pad_rows(data, mesh.size), pad_rows(mask, mesh.size))
    cache[key] = (data, out)
    return out


def _padded_local(col, data, mask, mesh, per: int) -> MaskedCol:
    """This rank's rows of a process-local column padded to the common
    quota ``per``; a rowid column holds the rows' positions in the
    global padded layout (rank * per + local row)."""
    from ..parallel.mesh import pad_to

    key = (str(data.device), "local", mesh.rank, per)
    cache = getattr(col, "_torch_dist_padded", None)
    if cache is None:
        cache = col._torch_dist_padded = {}
    hit = cache.get(key)
    if hit is not None and hit[0] is data:
        return hit[1]
    src = data
    if col.info.is_rowid:
        src = mesh.rank * per + torch.arange(data.shape[0], dtype=torch.int64,
                                             device=data.device)
    out = MaskedCol(pad_to(src, per),
                    None if mask is None else pad_to(mask, per, False))
    cache[key] = (data, out)
    return out


def _is_local(table: ExecTable) -> bool:
    """A dist scan (or its peeked view) of a process-local table."""
    return bool(getattr(table.columns, "local", False))


def _gathered(table: ExecTable) -> ExecTable:
    """The table whose columns are the gathered view, for a peeked one."""
    cols = table.columns
    return cols._table if isinstance(cols, _PeekColumns) else table


@dataclass
class _Shards:
    """A step input split over the mesh: per column, one MaskedCol per
    shard; per shard a row mask (None: all live)."""

    fields: List[str]
    types: list
    cols: List[List[MaskedCol]]
    rm: Optional[List[torch.Tensor]]
    rows_per_shard: int
    shards: int  # global

    @property
    def nrows(self) -> int:
        return self.rows_per_shard * self.shards

    def live_count(self) -> int:
        """Live rows over every rank's shards (a host sync)."""
        if self.rm is None:
            return self.nrows
        return sum(commlog.all_ranks(sum(int(r.sum()) for r in self.rm)))


def _peek(table: ExecTable, i: int) -> MaskedCol:
    cols = table.columns
    return cols.peek(i) if isinstance(cols, _ShardedScanColumns) else cols[i]


class _PeekColumns(list):
    """A table's columns as a distributed route reads them: a dist scan's
    padded columns, not its recorded gathered view."""

    def __init__(self, table: ExecTable) -> None:
        super().__init__([None] * len(table.fields))
        self._table = table
        self.local = _is_local(table)

    def __getitem__(self, i):
        if isinstance(i, int):
            return _peek(self._table, i)
        return list.__getitem__(self, i)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class DistExecMixin:
    # -- sharding -----------------------------------------------------------
    def _exec_scan_sharded(self, node: nd.Scan) -> ExecTable:
        """Rows padded to a multiple of the shard count, padding dead in
        the row mask; the columns shard on first use."""
        mesh = self._mesh
        if getattr(node.table, "process_local", False) and mesh.world > 1:
            return self._exec_scan_process_local(node)
        nrows = node.table.nrows
        total = nrows + (-nrows) % mesh.size
        rm = (None if total == nrows else
              torch.arange(total, device=self.device) < nrows)
        cols = _ShardedScanColumns(node.table, list(node.fields),
                                   self.device, mesh)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         total, rm)

    def _exec_scan_process_local(self, node: nd.Scan) -> ExecTable:
        """Multi-controller scan: every rank contributes its own rows,
        padded to the common quota (``parallel/mesh.quota`` over the row
        counts every rank reported at ingest), and no rank holds the
        whole table.  Rank r's rows are global rows [r * per, (r + 1) *
        per); the row mask (None where no rank pads) is the global one,
        built from the counts without a collective."""
        from ..parallel.mesh import quota

        mesh = self._mesh
        counts = node.table.rank_rows
        per, total = quota(counts, mesh.local_size)
        rm = None
        if any(c != per for c in counts):
            pos = torch.arange(per, device=self.device)
            rm = torch.cat([pos < c for c in counts])
        cols = _ShardedScanColumns(node.table, list(node.fields),
                                   self.device, mesh, local_rows=per)
        return ExecTable(list(node.fields), list(node.output_types), cols,
                         total, rm)

    def _local_frame(self, table: ExecTable):
        """(row mask, rows) of this rank's part of a peeked process-local
        table, whose columns hold this rank's rows."""
        per = table.nrows // self._mesh.world
        rm = table.row_mask
        if rm is not None:
            rm = rm.narrow(0, self._mesh.rank * per, per)
        return rm, per

    def _strided_sample(self, source: ExecTable, used, stride: int, s: int):
        """(columns, row mask) of the source's rows 0, stride, 2 * stride,
        ... (``s`` of them) in global row order: of a process-local
        source, each rank's rows among them, gathered onto every rank."""
        cols = [source.columns[i] for i in used]
        rm = source.row_mask
        rm0 = None if rm is None else rm[::stride][:s]
        if not _is_local(source):
            return [MaskedCol(c.data[::stride][:s],
                              c.mask[::stride][:s] if c.mask is not None
                              else None) for c in cols], rm0
        per = source.nrows // self._mesh.world
        base = self._mesh.rank * per
        k0 = -(-base // stride)
        k1 = max(k0, min(s, -(-(base + per) // stride)))
        idx = (torch.arange(k0, k1, dtype=torch.int64, device=self.device)
               * stride - base)
        samp = [MaskedCol(commlog.all_rows(c.data[idx]),
                          None if c.mask is None
                          else commlog.all_rows(c.mask[idx])) for c in cols]
        return samp, rm0

    def _peeked(self, table: ExecTable) -> ExecTable:
        if not isinstance(table.columns, _ShardedScanColumns):
            return table
        return ExecTable(table.fields, table.types, _PeekColumns(table),
                         table.nrows, table.row_mask,
                         unique_sets=table.unique_sets)

    def _split_cols(self, cols: List[Optional[MaskedCol]], rm, nrows: int,
                    local: bool = False):
        """(per-column lists of this rank's shards, their row masks, rows
        a shard) of columns of ``nrows`` rows, padded to the mesh where
        needed (the padding dead in the row mask).  ``local``: the columns
        are a process-local scan's (this rank's rows, padded to the
        quota) and ``rm`` its global row mask."""
        from ..parallel.mesh import pad_rows

        mesh = self._mesh
        if local:
            return ([None if c is None else mesh.split_col(c, local=True)
                     for c in cols],
                    None if rm is None else mesh.split(rm),
                    nrows // mesh.size)
        pad = (-nrows) % mesh.size
        if pad:
            if rm is None:
                rm = torch.ones((nrows,), dtype=torch.bool,
                                device=self.device)
            rm = pad_rows(rm, mesh.size, False)
            cols = [None if c is None else _broadcast(c, nrows)
                    for c in cols]
            cols = [None if c is None else
                    MaskedCol(pad_rows(c.data, mesh.size),
                              pad_rows(c.mask, mesh.size, False))
                    for c in cols]
        return ([mesh.split_col(c) if c is not None else None
                 for c in cols],
                None if rm is None else mesh.split(rm),
                (nrows + pad) // mesh.size)

    @contextlib.contextmanager
    def _on_shard(self, s: int):
        """Per-shard evaluation places constants on the shard's device."""
        dev = self._mesh.devices[s]
        if dev == self.scalar.device:
            yield
            return
        prev = self.scalar.device
        self.scalar.device = dev
        try:
            with torch.cuda.device(dev):
                yield
        finally:
            self.scalar.device = prev

    def _chain_has_window(self, chain) -> bool:
        from .optimizer import _contains_window

        return any(_contains_window(e) for n_ in chain
                   if isinstance(n_, nd.Project) for e in n_.exprs)

    def _dist_input(self, node: nd.Node, results,
                    resolved=None) -> _Shards:
        """A join or sort input split over the mesh; its Project/Filter
        chain runs per shard (a chain whose window the distributed route
        declined runs on the gathered view).  ``resolved``: the input's
        ``_resolve_chain_windowed`` where the caller has it."""
        source, chain, src_node = (
            resolved or self._resolve_chain_windowed(node, results))
        fields, types_ = list(node.fields), list(node.output_types)
        p = self._mesh.size
        if chain and self._chain_has_window(chain):
            source, chain = self._exec_chain_root(node, results), []
        src = self._peeked(source)
        size = len(src.fields)
        used = (self._used_columns(src_node, chain, [])
                if any(isinstance(n, nd.Project) for n in chain)
                else list(range(size)))
        scols, srm, rps = self._split_cols([src.columns[i] for i in used],
                                           src.row_mask, src.nrows,
                                           local=_is_local(src))
        if not chain:
            return _Shards(fields, types_, scols, srm, rps, p)
        per_shard, rms = [], []
        for s in range(self._mesh.local_size):
            with self._on_shard(s):
                env, final, rm = self._chain_env(
                    src_node, self._expand_cols([c[s] for c in scols], used,
                                                size), chain,
                    None if srm is None else srm[s], nrows=rps)
            per_shard.append([_broadcast(c, rps) for c in env[final.id]])
            rms.append(rm)
        cols = [[shard[j] for shard in per_shard]
                for j in range(len(fields))]
        return _Shards(fields, types_, cols,
                       None if rms[0] is None else rms, rps, p)

    def _gather_shards(self, sh: _Shards) -> ExecTable:
        mesh = self._mesh
        cols = [mesh.gather_col(c) for c in sh.cols]
        rm = None if sh.rm is None else mesh.gather(sh.rm)
        return ExecTable(sh.fields, sh.types, cols, sh.nrows, rm)

    # -- windows ------------------------------------------------------------
    def _resolve_chain_windowed(self, node: nd.Node, results):
        """``_resolve_chain``; in a dist session a window Project in the
        chain is computed first on the ``dist_window`` route and the
        consumer reads its output as its source (the unchanged chain
        where the route declines)."""
        source, chain, src_node = self._resolve_chain(node, results)
        if (self._mesh is None or not chain or source.nrows == 0
                or not self._chain_has_window(chain)):
            return source, chain, src_node
        last = chain[-1]
        out = self._exec_chain_dist_window(last, source, chain, src_node)
        if out is None:
            return source, chain, src_node
        return out, [], last

    def _exec_chain_dist_window(self, node: nd.Node, source: ExecTable,
                                chain, src_node) -> Optional[ExecTable]:
        """Window functions with PARTITION BY through
        ``parallel/dist_window.py``: their inputs evaluated per shard,
        each window computed on the partition owners, and the chain then
        evaluated with those values substituted.  None (route ``gspmd``)
        for windows without PARTITION BY, a row count that is not a
        multiple of the shard count, two window Projects in one chain or
        an exhausted retry ladder."""
        from .optimizer import _contains_window
        from ..parallel.dist_window import dist_window

        self._dist_window_route = "gspmd"
        wi = next(i for i, n_ in enumerate(chain)
                  if isinstance(n_, nd.Project)
                  and any(_contains_window(e) for e in n_.exprs))
        prefix, wp, suffix = chain[:wi], chain[wi], chain[wi + 1:]
        if self._chain_has_window(suffix):
            return None  # one window Project a step
        wfs: List[ir.WindowFunction] = []

        def collect(e: ir.Expr):
            if isinstance(e, ir.WindowFunction):
                wfs.append(e)
                return
            for o in e.operands():
                collect(o)

        for e in wp.exprs:
            collect(e)
        mesh = self._mesh
        p = mesh.size
        if not wfs or any(not w.partition_keys for w in wfs):
            return None
        if source.nrows < p or source.nrows % p:
            return None
        src = self._peeked(source)
        size = len(src.fields)
        used = self._used_columns(src_node, chain, [])
        scols, srm, rps = self._split_cols([src.columns[i] for i in used],
                                           src.row_mask, src.nrows,
                                           local=_is_local(src))
        inputs = []
        rms = []
        for s in range(mesh.local_size):
            with self._on_shard(s):
                env, _f, rmx = self._chain_env(
                    src_node, self._expand_cols([c[s] for c in scols], used,
                                                size), prefix,
                    None if srm is None else srm[s], nrows=rps)

                def resolve(ref, env=env):
                    return env[ref.node.id][ref.index]

                inputs.append([[[_broadcast(self.scalar.evaluate(
                    a, resolve, rmx), rps) for a in exprs]
                    for exprs in (w.args, w.partition_keys, w.order_keys)]
                    for w in wfs])
            rms.append(rmx)
        rm_sh = None if rms[0] is None else rms
        attempts = 3 if self.config.exec.allow_retry else 1
        vals: Dict[int, MaskedCol] = {}
        for wi_, w in enumerate(wfs):
            aa, pp, oo = ([[inp[wi_][g][j] for inp in inputs]
                           for j in range(len(inputs[0][wi_][g]))]
                          for g in range(3))
            slack = 2.0
            for _ in range(attempts):
                col, overflow = dist_window(
                    mesh, w.kind, aa, pp, oo, list(w.order_desc), w.arg1,
                    rps, rm_sh, torch_dtype(w.type.physical_dtype()),
                    frame=w.frame, slack=slack)
                if int(overflow) == 0:  # host sync: the retry contract
                    break
                slack *= 2.0
            else:
                return None
            vals[id(w)] = col
        # the chain's output reads every row: the gathered view
        full = _gathered(src)
        env, final, rm_out = self._chain_env(
            src_node, self._expand_cols([full.columns[i] for i in used],
                                        used, size), chain,
            src.row_mask, nrows=src.nrows, window_override=vals)
        self._dist_window_route = "dist_window"
        return ExecTable(list(node.fields), list(node.output_types),
                         [_broadcast(c, src.nrows) for c in env[final.id]],
                         src.nrows, rm_out)

    # -- aggregates ---------------------------------------------------------
    def _exec_aggregate_dist_any(self, node: nd.Aggregate, source: ExecTable,
                                 chain, src_node) -> Optional[ExecTable]:
        """The distributed routes of a keyed GROUP BY (None: the
        single-device route on the gathered view)."""
        source = self._peeked(source)
        layout, key_ranges = self._layout_and_ranges(node, source, chain,
                                                     src_node)
        self._sort_cap(node, source, chain, src_node, layout, key_ranges)
        all_alg = all(a.kind in _TWO_PHASE_KINDS and not a.distinct
                      for a in node.aggs)
        if all_alg and layout is None:
            return self._exec_aggregate_dist(node, source, chain, src_node,
                                             "two_phase")
        if not all_alg and self._distinct_split_applicable(node):
            return self._exec_aggregate_dist_distinct(node, source, chain,
                                                      src_node)
        if not all_alg:
            return self._exec_aggregate_dist(node, source, chain, src_node,
                                             "shuffled")
        return self._exec_aggregate_dist_perfect(node, source, chain,
                                                 src_node, layout)

    def _dist_prep(self, node: nd.Aggregate, source: ExecTable, chain,
                   src_node):
        """Per shard, the keys, the aggregate operands and the row mask
        of a GROUP BY: (keys as shard lists, [(operand shards or None,
        operand2 shards or None)], row-mask shards or None, rows a
        shard)."""
        used = self._agg_used(node, chain, src_node)
        size = len(source.fields)
        local = _is_local(source)

        def prep(sub_cols, row_mask, nrows):
            resolve, rm = self._terminal_env(src_node, sub_cols, used, size,
                                             chain, row_mask, nrows)
            keys = [_broadcast(self.scalar.evaluate(k, resolve), nrows)
                    for k in node.keys]
            ops = []
            for a in node.aggs:
                ops.append(tuple(
                    None if e is None else
                    _broadcast(self.scalar.evaluate(e, resolve), nrows)
                    for e in (a.operand, getattr(a, "operand2", None))))
            return keys, ops, rm

        if self._chain_has_window(chain):
            # the declined window runs over all rows; its outputs split
            full = _gathered(source)
            keys, ops, rm = prep([full.columns[i] for i in used],
                                 source.row_mask, source.nrows)
            flat = list(keys) + [o for pair in ops for o in pair]
            shards, rms, rps = self._split_cols(flat, rm, source.nrows)
            nk = len(keys)
            ops_sh = [(shards[nk + 2 * i], shards[nk + 2 * i + 1])
                      for i in range(len(ops))]
            return shards[:nk], ops_sh, rms, rps
        scols, srm, rps = self._split_cols(
            [source.columns[i] for i in used], source.row_mask, source.nrows,
            local=local)
        per = []
        for s in range(self._mesh.local_size):
            with self._on_shard(s):
                per.append(prep([c[s] for c in scols],
                                None if srm is None else srm[s], rps))
        keys = [[sh[0][j] for sh in per] for j in range(len(node.keys))]
        ops = [tuple(None if per[0][1][i][k] is None else
                     [sh[1][i][k] for sh in per] for k in (0, 1))
               for i in range(len(node.aggs))]
        rm = None if per[0][2] is None else [sh[2] for sh in per]
        return keys, ops, rm, rps

    def _dist_specs(self, node: nd.Aggregate, ops) -> List[gb.AggSpec]:
        return [self._agg_spec(a, op, op2)
                for a, (op, op2) in zip(node.aggs, ops)]

    def _dist_group_cap(self, node, ndev: int, rows_per_shard: int) -> int:
        """Per-shard group capacity: bounded by the key ranges' NDV where
        they bound it (2x slack for hash imbalance), else by the sampled
        NDV estimate (3x slack); an undershoot costs a retry."""
        from . import cost as _cost

        cap = max(64, min(
            self.config.exec.group_by.default_max_groups // ndev,
            rows_per_shard * 2))
        ndv = _cost._ndv_bound(node)
        if ndv is not None and ndv < cap * ndev:
            cap = max(64, min(cap, int(ndv // ndev * 2 + 64)))
        elif getattr(self, "_ndv_estimate", None) is not None:
            cap = max(64, min(cap, self._ndv_estimate // ndev * 3 + 64))
        return cap

    def _exec_aggregate_dist_perfect(self, node, source, chain, src_node,
                                     layout) -> ExecTable:
        """A dense layout with mergeable aggregates: per-shard dense
        partial slots (K1-K4 once per shard) combined by psum/pmin/pmax
        into a replicated buffer."""
        from ..parallel import dist_groupby as dg

        keys, ops, rm, _rps = self._dist_prep(node, source, chain, src_node)
        key_cols, agg_cols, exists = dg.dist_groupby_perfect(
            self._mesh, keys, layout, self._dist_specs(node, ops),
            row_valid=rm)
        self._dist_agg_route = "dense_psum"
        return ExecTable(list(node.fields), list(node.output_types),
                         list(key_cols) + list(agg_cols),
                         layout.entry_count, exists)

    def _exec_fused_agg_sort_dist(self, sort_node: nd.Sort,
                                  node: nd.Aggregate,
                                  results) -> Optional[ExecTable]:
        """Aggregate -> Sort on the dense route: the psum-combined
        replicated buffer ordered and windowed as the single-device fused
        step does.  None (the parts run apart) off the dense route."""
        from ..parallel import dist_groupby as dg

        source, chain, src_node = self._resolve_chain_windowed(
            node.inputs[0], results)
        if source.nrows == 0 or not node.keys:
            return None
        source = self._peeked(source)
        ranges = self._static_ranges(node)
        if ranges is None:
            return None
        layout = gb.choose_perfect_layout([k.type for k in node.keys],
                                          ranges, self._layout_limit)
        if layout is None or any(a.kind not in dg._COMBINE or a.distinct
                                 for a in node.aggs):
            return None
        if self._grouped_stream_plan(node, source, chain, src_node):
            return None
        keys, ops, rm, _rps = self._dist_prep(node, source, chain, src_node)
        kc, ac, exists = dg.dist_groupby_perfect(
            self._mesh, keys, layout, self._dist_specs(node, ops),
            row_valid=rm)
        self._dist_agg_route = "dense_psum_fused_sort"
        return self._sort_group_buffer(sort_node, node, list(kc) + list(ac),
                                       exists, layout.entry_count)

    def _dist_ladder(self, run, node, keys, specs, rm, rps: int,
                     route: str, switch=None) -> Optional[ExecTable]:
        """A shuffling route under the widen-and-retry ladder: an
        overflow doubles the group cap and the slack and runs again
        (``switch``: the (run, specs) of the pair split, which the next
        attempts take instead); None after the last attempt."""
        ndev = self._mesh.size
        group_cap = self._dist_group_cap(node, ndev, rps)
        slack = 2.0
        attempts = 3 if self.config.exec.allow_retry else 1
        self._dist_agg_route = route
        self._dist_retries = 0
        for _ in range(attempts):
            key_cols, agg_cols, gvalid, overflow = run(
                self._mesh, keys, specs, rps, group_cap, slack=slack,
                row_valid=rm)
            ovf = int(overflow)  # host sync: the retry contract
            if ovf == 0:
                return ExecTable(list(node.fields), list(node.output_types),
                                 list(key_cols) + list(agg_cols),
                                 ndev * group_cap, gvalid)
            _LOG.warning("dist agg overflow (%d): widening to group_cap=%d "
                         "slack=%.1f", ovf, group_cap * 2, slack * 2.0)
            self._dist_retries += 1
            group_cap *= 2
            slack *= 2.0
            if switch is not None:
                run, specs = switch
                self._dist_agg_route = "distinct_split"
                switch = None
        return None

    def _exec_aggregate_dist(self, node, source, chain, src_node,
                             route: str) -> Optional[ExecTable]:
        """``two_phase`` (algebraic aggregates) or ``shuffled`` (holistic
        ones)."""
        from ..parallel import dist_groupby as dg

        keys, ops, rm, rps = self._dist_prep(node, source, chain, src_node)
        run = (dg.dist_groupby_two_phase if route == "two_phase"
               else dg.dist_groupby_shuffled)
        return self._dist_ladder(run, node, keys, self._dist_specs(node, ops),
                                 rm, rps, route)

    def _distinct_split_applicable(self, node) -> bool:
        """Every aggregate algebraic or DISTINCT-class, the DISTINCT-class
        ones over one operand expression."""
        def is_dist(a):
            return (a.kind == ir.AggKind.COUNT_DISTINCT
                    or (a.distinct and a.kind in (ir.AggKind.SUM,
                                                  ir.AggKind.AVG)))
        dists = [a for a in node.aggs if is_dist(a)]
        if not dists:
            return False
        if not all(is_dist(a) or (a.kind in _TWO_PHASE_KINDS
                                  and not a.distinct) for a in node.aggs):
            return False
        op0 = dists[0].operand
        return all(d.operand == op0 for d in dists[1:])

    def _probe_hot_key_share(self, keys, nrows: int) -> float:
        """The hottest key's row share in a prefix sample of
        ``dist.skew_sample_size`` rows (a host read)."""
        import time as _t

        s = min(int(self.config.dist.skew_sample_size), nrows)
        if s <= 0:
            return 1.0  # unknown: assume the worst, stay skew-proof
        t0 = _t.perf_counter()
        def prefix(shards):
            """The first ``s`` rows over every rank's shards, on this
            device."""
            out, got = [], 0
            for x in commlog.all_shards([x[:s] for x in shards]):
                if got >= s:
                    break
                out.append(x[:s - got].to(self.device))
                got += out[-1].shape[0]
            return torch.cat(out)

        parts = []
        for k in keys:
            v = gb._orderable_int64(prefix([x.data for x in k]))
            if k[0].mask is not None:
                m = prefix([x.mask for x in k])
                v = torch.where(m, v, 0)
                parts.append(m.to(torch.int64))
            parts.append(v)
        _, counts = torch.unique(torch.stack(parts, dim=1), dim=0,
                                 return_counts=True)
        top = int(counts.max()) if counts.numel() else 0
        self._ndv_sample_seconds += _t.perf_counter() - t0
        return float(top) / float(s)

    def _exec_aggregate_dist_distinct(self, node, source, chain,
                                      src_node) -> Optional[ExecTable]:
        """DISTINCT-class aggregates: the raw shuffle when the hot-key
        probe finds no key above ``heavy_hitter_threshold`` of a shard's
        share, else the pair split (every distinct-class aggregate reads
        the first one's operand); a raw shuffle that overflows moves to
        the pair split."""
        from ..parallel import dist_groupby as dg

        keys, ops, rm, rps = self._dist_prep(node, source, chain, src_node)
        specs = self._dist_specs(node, ops)
        salt = next(s.operand for s in specs if dg._is_distinct_class(s))
        salted = [_dc.replace(s, operand=salt)
                  if dg._is_distinct_class(s) else s for s in specs]
        hot = self._probe_hot_key_share(keys, source.nrows)
        if hot > self.config.dist.heavy_hitter_threshold / self._mesh.size:
            return self._dist_ladder(dg.dist_groupby_distinct_split, node,
                                     keys, salted, rm, rps,
                                     "distinct_split")
        return self._dist_ladder(
            dg.dist_groupby_shuffled, node, keys, specs, rm, rps, "shuffled",
            switch=(dg.dist_groupby_distinct_split, salted))

    # -- sort -----------------------------------------------------------------
    def _exec_sort_dist(self, node: nd.Sort, results,
                        resolved) -> Optional[ExecTable]:
        """Range-partitioned sort (``parallel/dist_sort.py``): the sorted
        shards in shard order are the global order, a LIMIT/OFFSET is a
        validity window over them.  None (the single-device sort) for
        tiny inputs or an exhausted retry ladder."""
        from ..parallel.dist_sort import dist_sort

        mesh = self._mesh
        ndev = mesh.size
        self._dist_sort_route = "single"
        inp = self._dist_input(node.inputs[0], results, resolved)
        if inp.nrows < ndev * 4:
            return None
        in_types = node.inputs[0].output_types
        scols = []
        for f in node.sort_fields:
            ty = in_types[f.field_index]
            scols.append([self._sortable(c, ty)
                          for c in inp.cols[f.field_index]])
        descs = [f.desc for f in node.sort_fields]
        nfs = [f.nulls_first for f in node.sort_fields]
        slack = 2.0
        attempts = 3 if self.config.exec.allow_retry else 1
        self._dist_retries = 0
        for _ in range(attempts):
            cols, valid, overflow = dist_sort(
                mesh, scols, descs, nfs, inp.cols, inp.rows_per_shard,
                row_valid=inp.rm, slack=slack)
            if int(overflow) == 0:  # host sync: the retry contract
                break
            self._dist_retries += 1
            slack *= 2.0
        else:
            return None
        out_rows = int(valid.shape[0])
        if node.limit is not None or node.offset:
            end = None if node.limit is None else node.offset + node.limit
            pos = torch.cumsum(valid.to(torch.int64), 0) - 1
            live = valid.sum()
            stop = live if end is None else torch.clamp(live, max=end)
            valid = valid & (pos >= node.offset) & (pos < stop)
        self._dist_sort_route = "range"
        return ExecTable(list(node.fields), list(node.output_types),
                         list(cols), out_rows, valid)

    # -- joins ----------------------------------------------------------------
    def _exec_join_dist(self, node: nd.Join, results) -> Optional[ExecTable]:
        """Broadcast join for a build side up to
        ``dist.broadcast_join_threshold`` live rows, else both sides
        partitioned (``parallel/dist_join.py``).  Pair capacities come
        from counting passes, so they are exact; an overflow would fall
        back to the single-device join.  None also for a residual on a
        non-INNER join and for array columns."""
        from ..parallel import dist_join as dj
        from . import cost as _cost
        from .common import _rebind_to_join_output

        jt = node.join_type
        mesh = self._mesh
        ndev = mesh.size
        if node.residual is not None and jt != nd.JoinType.INNER:
            return None
        if any(ty.is_array() for ty in node.output_types):
            return None
        lhs = self._dist_input(node.inputs[0], results)
        rhs = self._dist_input(node.inputs[1], results)
        if lhs.nrows < ndev or rhs.nrows == 0:
            return None

        def eval_keys(exprs, cols, nrows):
            return [_broadcast(self.scalar.evaluate(
                e, lambda ref: cols[ref.index]), nrows) for e in exprs]

        lexprs = [l for l, _ in node.key_pairs]
        rexprs = [r for _, r in node.key_pairs]
        local = range(mesh.local_size)
        lkeys_s = []
        for s in local:
            with self._on_shard(s):
                lkeys_s.append(eval_keys(lexprs, [c[s] for c in lhs.cols],
                                         lhs.rows_per_shard))
        broadcast = _cost.dist_join_strategy(
            lhs.live_count(), rhs.live_count(), ndev,
            self.config.dist.broadcast_join_threshold) == "broadcast"
        lcols = lhs.cols
        if broadcast:
            rt = self._gather_shards(rhs).compact()
            if rt.nrows == 0:
                return None
            rkeys = eval_keys(rexprs, rt.columns, rt.nrows)
            self._unify_key_types(node, lkeys_s[0], rkeys)
            for s in local[1:]:  # the probe keys' promotions
                lkeys_s[s] = [MaskedCol(k.data.to(k0.data.dtype), k.mask)
                              for k, k0 in zip(lkeys_s[s], lkeys_s[0])]
            lkeys = [[lkeys_s[s][j] for s in local]
                     for j in range(len(lexprs))]
            totals = dj.count_candidates_broadcast(mesh, lkeys, lhs.rm, rkeys)
            pair_cap = _next_pow2(max(64, int(totals.max())))
            out_cols, out_mask, ov = dj.dist_join_broadcast(
                mesh, lcols, lkeys, lhs.rm, list(rt.columns), rkeys, jt,
                pair_cap)
            self._dist_join_route = "broadcast"
        else:
            rkeys_s = []
            for s in local:
                with self._on_shard(s):
                    rk = eval_keys(rexprs, [c[s] for c in rhs.cols],
                                   rhs.rows_per_shard)
                    self._unify_key_types(node, lkeys_s[s], rk)
                rkeys_s.append(rk)
            lkeys = [[lkeys_s[s][j] for s in local]
                     for j in range(len(lexprs))]
            rkeys = [[rkeys_s[s][j] for s in local]
                     for j in range(len(rexprs))]
            hp, hb = dj.partition_histograms(mesh, lkeys, lhs.rm, rkeys,
                                             rhs.rm)
            probe_cap = _next_pow2(max(64, int(hp.max())))
            build_cap = _next_pow2(max(64, int(hb.max())))
            totals = dj.count_candidates_partitioned(
                mesh, lkeys, lhs.rm, rkeys, rhs.rm, probe_cap, build_cap)
            pair_cap = _next_pow2(max(64, int(totals.max())))
            out_cols, out_mask, ov = dj.dist_join_partitioned(
                mesh, lcols, lkeys, lhs.rm, rhs.cols, rkeys, rhs.rm, jt,
                probe_cap, build_cap, pair_cap)
            self._dist_join_route = "partitioned"
        if int(ov) > 0:  # the caps were exact: an overflow is a fault
            _LOG.warning("dist join overflow (%d): single-device join",
                         int(ov))
            return None
        if out_cols is None:  # broadcast SEMI/ANTI: a keep mask on lhs
            lt = self._gather_shards(lhs)
            rm = combine_masks(lt.row_mask, out_mask)
            return ExecTable(list(node.fields), list(node.output_types),
                             list(lt.columns), lt.nrows, rm)
        nrows = int(out_cols[0].data.shape[0])
        out = ExecTable(list(node.fields), list(node.output_types),
                        list(out_cols), nrows, out_mask)
        if node.residual is not None:
            cond = self.scalar.evaluate(
                _rebind_to_join_output(node.residual, node),
                lambda ref: out.columns[ref.index])
            m = cond.data.to(torch.bool)
            if cond.mask is not None:
                m = m & cond.mask
            out = ExecTable(out.fields, out.types, out.columns, out.nrows,
                            out.row_mask & m)
        return out
