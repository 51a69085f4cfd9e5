"""The collectives of multi-device sessions, and their accounting
(counterpart of hdk_tpu/utils/commlog.py).

A session's shards are the entries of a list, one per shard, each on its
shard's device.  Every collective of the distributed operators goes
through the functions below, which take that list and return one:
``all_to_all`` (the shuffle's exchange), ``psum`` / ``pmin`` / ``pmax``
(replicated reductions), ``all_gather`` (replicated concatenation) and
``gather`` (the mesh's concatenation onto its first device, which every
consumer without a distributed route reads).

In one process the list holds every shard.  In a multi-host session
(``parallel/mesh.init_distributed``) each process holds its own local
shards, rank r the global shards ``[r * L, (r + 1) * L)``, and a
``Transport`` over ``torch.distributed`` carries the functions across
processes, each rank's shards in one exchange.  A reduction all-gathers every shard's partial and reduces them in global
shard order on each rank, so a float result is bit for bit the one
process's.  The transport is gloo: it serves ranks on the CPU and ranks
that share a card (NCCL refuses a communicator whose ranks share a
GPU), and since gloo moves host tensors only, a CUDA operand is staged
through pinned host memory (bool as uint8); it counts the bytes it
staged and the time its calls took.

Inside ``capture()`` each call records its op, the bytes of one shard's
operand and the global shard count, as the JAX package records them at
trace time, so a 2-process x 2-shard session records what a 1 x 4
session records; ``gather`` records an ``all_gather`` marked
``"gather": True``, so a capture shows every fall-back to the gathered
view apart from the operators' own collectives.  ``summarize`` keeps
the JAX package's wire model (bytes that leave a device per
collective); no link rate is assumed for it here.  The host decisions
that every rank must take alike (join capacities, live counts, samples)
read other ranks' shards through ``all_shards`` / ``all_ranks``, which
record nothing: the one-process session reads those shards directly.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Sequence

import torch

from .logger import get_channel

_active: Optional[List[dict]] = None
_LOG = get_channel("dist")


class Transport:
    """The cross-process leg of the collectives: gloo over
    ``torch.distributed``'s default group, operands staged through
    pinned host buffers where they lie on a card.  ``staged_bytes`` and
    ``seconds`` count what its calls moved through host memory and the
    wall time they took, staging copies included."""

    def __init__(self, world: int, rank: int, staged: bool) -> None:
        self.world = world
        self.rank = rank
        self.staged = staged
        self.backend = "gloo"
        self.reason = (
            "ranks on CUDA: operands staged through pinned host memory "
            "(NCCL refuses ranks that share a card; a transport for "
            "ranks with cards of their own is not wired)" if staged
            else "ranks on the CPU")
        self.calls = 0
        self.staged_bytes = 0
        self.seconds = 0.0

    def stats(self) -> Dict:
        return {"backend": self.backend, "world": self.world,
                "rank": self.rank, "calls": self.calls,
                "staged_bytes": self.staged_bytes,
                "ms": self.seconds * 1e3}

    def reset_stats(self) -> None:
        self.calls = 0
        self.staged_bytes = 0
        self.seconds = 0.0

    @staticmethod
    def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
        return torch.uint8 if dtype == torch.bool else dtype

    def _host(self, shape, dtype: torch.dtype, staged: bool) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=self._wire_dtype(dtype),
                           pin_memory=staged)

    def _finish(self, t0: float, nbytes: int, op: str) -> None:
        self.calls += 1
        self.staged_bytes += nbytes
        dt = time.perf_counter() - t0
        self.seconds += dt
        _LOG.debug1("transport %s: %d bytes through host memory, %.3f ms",
                   op, nbytes, dt * 1e3)

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every rank's local shards of one shape, stacked in global
        shard order: a (world * L, ...) tensor on ``xs[0]``'s device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        x0 = xs[0]
        staged = x0.device.type != "cpu"
        wire = self._wire_dtype(x0.dtype)
        send = self._host((len(xs),) + tuple(x0.shape), x0.dtype, staged)
        for i, x in enumerate(xs):
            send[i].copy_(x.to(wire) if x.dtype != wire else x)
        recv = self._host((self.world * len(xs),) + tuple(x0.shape),
                          x0.dtype, staged)
        dist.all_gather_into_tensor(recv, send)
        out = recv.to(x0.device)
        if out.dtype != x0.dtype:
            out = out.to(x0.dtype)
        self._finish(t0, send.numel() * send.element_size()
                     + recv.numel() * recv.element_size(), "all_gather")
        return out

    def all_gather_rows(self, xs: Sequence[torch.Tensor]):
        """Every shard's rows concatenated in global shard order, on
        ``xs[0]``'s device, and every shard's row count; the counts may
        differ (a count exchange comes first)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        x0 = xs[0]
        staged = x0.device.type != "cpu"
        n = torch.tensor([v.shape[0] for v in xs], dtype=torch.int64)
        every = torch.empty((self.world * len(xs),), dtype=torch.int64)
        dist.all_gather_into_tensor(every, n)
        shard_rows = every.tolist()
        counts = [sum(shard_rows[r * len(xs):(r + 1) * len(xs)])
                  for r in range(self.world)]
        most = max(counts)
        wire = self._wire_dtype(x0.dtype)
        send = self._host((most,) + tuple(x0.shape[1:]), x0.dtype, staged)
        off = 0
        for v in xs:  # each shard straight into its rows of the buffer
            send[off:off + v.shape[0]].copy_(v.to(wire) if v.dtype != wire
                                             else v)
            off += v.shape[0]
        if most > off:
            send[off:].zero_()
        recv = self._host((self.world * most,) + tuple(x0.shape[1:]),
                          x0.dtype, staged)
        dist.all_gather_into_tensor(recv, send)
        got = recv.to(x0.device)  # one copy; the trim runs on the device
        parts = [got[r * most:r * most + c] for r, c in enumerate(counts)]
        out = torch.cat(parts) if len(parts) > 1 else parts[0]
        if out.dtype != x0.dtype:
            out = out.to(x0.dtype)
        self._finish(t0, send.numel() * send.element_size()
                     + recv.numel() * recv.element_size(), "gather")
        return out, shard_rows

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``xs[l]`` is local shard l's (P, ...) send buffer, P = world *
        L, row d bound for global shard d; local shard l receives the
        (P, ...) buffer whose row s came from global shard s.  Only the
        rows bound for other ranks go through host memory, each rank's
        block contiguous; this rank's own rows stay on the device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        nl, me = len(xs), self.rank
        x0 = xs[0]
        dev = x0.device
        rest = tuple(x0.shape[1:])
        staged = dev.type != "cpu"
        wire = self._wire_dtype(x0.dtype)
        others = [r for r in range(self.world) if r != me]
        # (other rank, source local shard, dest local shard, ...)
        send = self._host((len(others), nl, nl) + rest, x0.dtype, staged)
        for i, r in enumerate(others):
            for src, x in enumerate(xs):
                blk = _to(x[r * nl:(r + 1) * nl], dev)
                send[i, src].copy_(blk.to(wire) if blk.dtype != wire
                                   else blk)
        recv = self._host(send.shape, x0.dtype, staged)
        splits = [0 if r == me else 1 for r in range(self.world)]
        dist.all_to_all_single(recv, send, splits, splits)
        got = recv.to(dev)
        if got.dtype != x0.dtype:
            got = got.to(x0.dtype)
        out = []
        for dst, x in enumerate(xs):
            parts = []
            for r in range(self.world):
                if r == me:
                    parts.append(torch.stack([
                        _to(xs[src][me * nl + dst], dev)
                        for src in range(nl)]))
                else:
                    parts.append(got[others.index(r), :, dst])
            out.append(_to(torch.cat(parts), x.device))
        self._finish(t0, send.numel() * send.element_size()
                     + recv.numel() * recv.element_size(), "all_to_all")
        return out


_transport: Optional[Transport] = None


def set_transport(t: Optional[Transport]) -> None:
    """Install (or, with None, remove) the process's cross-process
    transport; ``parallel/mesh.init_distributed`` installs it."""
    global _transport
    _transport = t


def transport() -> Optional[Transport]:
    """The installed transport when this process is one of several
    ranks, else None."""
    t = _transport
    if t is None or t.world <= 1:
        return None
    return t


def _shards(n_local: int) -> int:
    """The global shard count of a list of ``n_local`` local shards."""
    t = transport()
    return n_local * (t.world if t is not None else 1)


@contextlib.contextmanager
def capture():
    """Collect the collective records made under this scope; the yielded
    list fills as the calls run.  Nested captures are not supported (the
    inner one wins)."""
    global _active
    prev = _active
    records: List[dict] = []
    _active = records
    try:
        yield records
    finally:
        _active = prev


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _record(op: str, shard_operand, n_shards: int,
            gather: bool = False, nbytes: Optional[int] = None) -> None:
    if _active is None:
        return
    rec = {"op": op, "axis": "frag", "bytes_per_device":
           _nbytes(shard_operand) if nbytes is None else nbytes,
           "shards": n_shards}
    if gather:
        rec["gather"] = True
    _active.append(rec)


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x if x.device == device else x.to(device)


def _replicate(x: torch.Tensor, like: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """``x`` once per shard, on each shard's device (the same tensor for
    shards that share a device)."""
    return [_to(x, s.device) for s in like]


def all_to_all(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``xs[s]`` is shard s's (P, cap, ...) send buffer, row d bound for
    shard d; shard d receives the (P, cap, ...) buffer whose row s came
    from shard s."""
    _record("all_to_all", xs[0], _shards(len(xs)))
    t = transport()
    if t is not None:
        return t.all_to_all(xs)
    p = len(xs)
    return [torch.stack([_to(xs[s][d], xs[d].device) for s in range(p)])
            for d in range(p)]


def all_shards(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's tensor in global shard order, on ``xs[0]``'s device
    (``xs`` itself in one process); the shards' shapes must agree across
    ranks.  Records nothing: host decisions that every rank must take
    alike read it."""
    t = transport()
    if t is None:
        return list(xs)
    return list(t.all_gather(xs).unbind(0))


def all_ranks(value: int) -> List[int]:
    """One host integer from every rank, in rank order (``[value]`` in
    one process).  Records nothing."""
    t = transport()
    if t is None:
        return [int(value)]
    return [int(v) for v in t.all_gather(
        [torch.tensor(int(value), dtype=torch.int64)]).tolist()]


def all_ranks_obj(obj) -> list:
    """One picklable host object from every rank, in rank order
    (``[obj]`` in one process): ingest metadata.  Records nothing."""
    t = transport()
    if t is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * t.world
    dist.all_gather_object(out, obj)
    return out


def all_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order (``x`` in
    one process); the ranks' row counts may differ.  Records nothing."""
    t = transport()
    return x if t is None else t.all_gather_rows([x])[0]


def _reduce(op: str, xs: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    _record(op, xs[0], _shards(len(xs)))
    dev = xs[0].device
    parts = all_shards(xs)
    acc = parts[0]
    for x in parts[1:]:
        acc = fn(acc, _to(x, dev))
    return _replicate(acc, xs)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce("psum", xs, torch.add)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce("pmin", xs, torch.minimum)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce("pmax", xs, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0,
               tiled: bool = False) -> List[torch.Tensor]:
    """Every shard's operand, concatenated along ``axis`` (``tiled``) or
    stacked in a new leading axis, on every shard."""
    _record("all_gather", xs[0], _shards(len(xs)))
    dev = xs[0].device
    parts = [_to(x, dev) for x in all_shards(xs)]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts)
    return _replicate(out, xs)


def gather(xs: Sequence[torch.Tensor], device: torch.device
           ) -> torch.Tensor:
    """The shards' rows concatenated on ``device``.  Shards that are
    consecutive views of one tensor (a scan's shards on one card) give
    that tensor back, nothing copied.  Across ranks every rank receives
    every shard's rows (their counts may differ); the record counts
    global shard 0's bytes, as in one process."""
    t = transport()
    if t is not None:
        out, rows = t.all_gather_rows(xs)
        x0 = xs[0]
        _record("all_gather", x0, _shards(len(xs)), gather=True,
                nbytes=rows[0] * math.prod(x0.shape[1:]) * x0.element_size())
        return _to(out, device)
    _record("all_gather", xs[0], _shards(len(xs)), gather=True)
    base = _contiguous_base(xs)
    if base is not None and base.device == device:
        return base
    return torch.cat([_to(x, device) for x in xs])


def note_gather(shard: torch.Tensor, n_local: int) -> None:
    """Record the gather of a replicated tensor whose shard is ``shard``:
    every rank holds the whole tensor already, so nothing moves."""
    _record("all_gather", shard, _shards(n_local), gather=True)


def _contiguous_base(xs: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """The one tensor whose consecutive row ranges the shards are, or
    None."""
    x0 = xs[0]
    if not all(x.is_contiguous() and x.device == x0.device
               and x.dtype == x0.dtype and x.shape[1:] == x0.shape[1:]
               for x in xs):
        return None
    try:
        ptr = x0.untyped_storage().data_ptr()
    except RuntimeError:
        return None
    off = x0.storage_offset()
    row = math.prod(x0.shape[1:])
    for x in xs:
        if x.untyped_storage().data_ptr() != ptr or x.storage_offset() != off:
            return None
        off += x.shape[0] * row
    rows = sum(x.shape[0] for x in xs)
    return x0.as_strided((rows,) + tuple(x0.shape[1:]),
                         x0.stride(), x0.storage_offset())


def summarize(records: List[dict], n_devices: int) -> Dict:
    """Per-op bytes and the modeled bytes that leave each device: an
    all_to_all sends (n-1)/n of its operand, a psum/pmin/pmax (ring
    all-reduce) about twice its operand, an all_gather receives the n-1
    other shards'; a ``gather`` counts as the all_gather it is."""
    per_op: Dict[str, int] = {}
    wire = 0.0
    n = max(n_devices, 1)
    for r in records:
        b = r["bytes_per_device"]
        per_op[r["op"]] = per_op.get(r["op"], 0) + b
        if r["op"] == "all_to_all":
            wire += b * (n - 1) / n
        elif r["op"] in ("psum", "pmin", "pmax"):
            wire += 2.0 * b * (n - 1) / n
        elif r["op"] == "all_gather":
            wire += b * (n - 1)
    return {
        "n_collectives": len(records),
        "bytes_per_device_by_op": per_op,
        "wire_bytes_per_device": int(wire),
    }
