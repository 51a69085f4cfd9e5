"""The device mesh of a multi-device session (counterpart of
hdk_tpu/parallel/mesh.py).

A mesh is a list of shard devices, one per local shard, and a device may
repeat: local shard i sits on ``devices[i % count]`` of the session's
device type, so four shards on one card share it and run one after
another on its current stream.  A session asked for the card never
computes on the CPU: it places several shards on one card and logs that
it did.

One process addresses every shard, as the JAX package's single
controller does, unless it joined a multi-host job
(``init_distributed``): then each of the ``world`` processes (ranks)
holds ``L`` local shards, rank r the global shards ``[r * L, (r + 1) *
L)`` as the JAX package's id-sorted devices give, ``size`` counts the
global shards, and the collectives of ``utils/commlog`` go across the
ranks.  Every rank runs the same program, so every rank must take the
same host decisions.

Rows shard in equal consecutive ranges.  A replicated column (every
rank holds all its rows) is padded to a multiple of the global shard
count (``pad_rows``) and ``split`` gives this rank's shards of it; a
process-local column (each rank holds its own rows, padded to the
common quota of ``process_row_quota``) splits with ``split_local``.  The
padding rides the row mask.  Where every shard is on the tensor's own
device the shards are ``narrow`` views of it, nothing copied, and
``gather`` of those views gives the tensor back; shards on other
devices are copies, kept per source tensor while it lives.
"""

from __future__ import annotations

import datetime
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exec.masked import MaskedCol
from ..utils import commlog
from ..utils.logger import get_channel


class Mesh:
    """Shard devices of one process, ``devices[i]`` holding local shard
    i, which is global shard ``first + i``."""

    def __init__(self, devices: Sequence[torch.device], world: int = 1,
                 rank: int = 0) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.local_size = len(self.devices)
        self.world = world
        self.rank = rank
        self.size = self.local_size * world
        self.first = rank * self.local_size
        # per-shard copies on other devices, by source tensor
        self._copies: Dict[int, tuple] = {}

    @property
    def device(self) -> torch.device:
        """The device of local shard 0, where gathered and replicated
        results live."""
        return self.devices[0]

    def split(self, x: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """This rank's shards of a replicated ``x`` (rows a multiple of
        the global shard count)."""
        if x is None:
            return [None] * self.local_size
        rows = x.shape[0]
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split over "
                             f"{self.size} shards (pad_rows first)")
        return self._shards(x, self.first, rows // self.size)

    def split_local(self, x: Optional[torch.Tensor]
                    ) -> List[Optional[torch.Tensor]]:
        """This rank's shards of a process-local ``x`` (its own rows, a
        multiple of the local shard count)."""
        if x is None:
            return [None] * self.local_size
        rows = x.shape[0]
        if rows % self.local_size:
            raise ValueError(f"{rows} local rows do not split over "
                             f"{self.local_size} shards")
        return self._shards(x, 0, rows // self.local_size)

    def _shards(self, x: torch.Tensor, first: int, per: int
                ) -> List[torch.Tensor]:
        views = [x.narrow(0, (first + i) * per, per)
                 for i in range(self.local_size)]
        if all(d == x.device for d in self.devices):
            return views
        key = (id(x), first)
        got = self._copies.get(key)
        if got is not None and got[0]() is x:
            return list(got[1])
        out = [v if d == x.device else v.to(d)
               for v, d in zip(views, self.devices)]
        self._copies = {k: v for k, v in self._copies.items()
                        if v[0]() is not None}
        self._copies[key] = (weakref.ref(x), tuple(out))
        return out

    def split_col(self, c: Optional[MaskedCol], local: bool = False
                  ) -> List[Optional[MaskedCol]]:
        if c is None:
            return [None] * self.local_size
        split = self.split_local if local else self.split
        ds, ms = split(c.data), split(c.mask)
        return [MaskedCol(d, m) for d, m in zip(ds, ms)]

    def gather(self, xs: Sequence[Optional[torch.Tensor]]
               ) -> Optional[torch.Tensor]:
        """Every shard's rows concatenated in global shard order on local
        shard 0's device (a recorded ``all_gather``, see
        ``utils/commlog.gather``)."""
        if xs[0] is None:
            return None
        return commlog.gather(list(xs), self.device)

    def view(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The gathered view of a replicated ``x``'s shards, as a step
        without a distributed route reads it (a recorded gather): ``x``
        itself where every shard lies on its device, and on every rank
        of a multi-host session, which holds all of ``x`` already."""
        if x is None:
            return None
        if self.world > 1:
            commlog.note_gather(self.split(x)[0], self.local_size)
            return x
        got = self.gather(self.split(x))
        return x if all(d == x.device for d in self.devices) else got

    def view_local(self, x: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
        """The gathered view of a process-local ``x``: every rank's
        rows, in rank order, on every rank."""
        if x is None:
            return None
        return self.gather(self.split_local(x))

    def gather_col(self, cs: Sequence[MaskedCol]) -> MaskedCol:
        return MaskedCol(self.gather([c.data for c in cs]),
                         self.gather([c.mask for c in cs]))


def make_mesh(n_shards: int, device: torch.device) -> Mesh:
    """``n_shards`` global shards, this rank's share of them on the
    devices of ``device``'s type: on CUDA local shard i on card (first +
    i) % count, where ``first`` is the session's card; on the CPU every
    shard on the CPU.  In a multi-host job ``n_shards`` must divide by
    the number of ranks."""
    log = get_channel("dist")
    device = torch.device(device)
    t = commlog.transport()
    world, rank = (t.world, t.rank) if t is not None else (1, 0)
    if n_shards % world:
        raise ValueError(f"dist.num_devices={n_shards} does not divide "
                         f"over {world} processes")
    n_shards //= world
    if device.type == "cuda":
        count = torch.cuda.device_count()
        first = device.index if device.index is not None else 0
        devs = [torch.device("cuda", (first + i) % count)
                for i in range(n_shards)]
        if n_shards > count:
            log.info("mesh: %d shards on %d card(s); shards on one card "
                     "share it and run one after another", n_shards, count)
    else:
        devs = [device] * n_shards
    if world > 1:
        log.info("mesh: rank %d of %d holds global shards %d..%d on %s",
                 rank, world, rank * n_shards, (rank + 1) * n_shards - 1,
                 sorted({str(d) for d in devs}))
    return Mesh(devs, world, rank)


def default_shards(device: torch.device) -> int:
    """``dist.num_devices`` 0: every card on CUDA, one device on the
    CPU, times the number of ranks in a multi-host job."""
    device = torch.device(device)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    t = commlog.transport()
    return local * (t.world if t is not None else 1)


# -- multi-host jobs ---------------------------------------------------------

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, timeout_s: float = 600.0) -> None:
    """Join a multi-host job before building meshes (idempotent).

    Wraps ``torch.distributed.init_process_group``.  ``"host:port"``
    becomes ``tcp://host:port`` (an address with a scheme, such as
    ``file://``, is passed on as it is); no address means ``env://``,
    where torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK`` give everything, as the JAX package's auto-detection
    does on a pod.  ``timeout_s`` bounds every collective, so a rank that
    diverged fails instead of hanging.  A CUDA ``device`` becomes this
    process's current card.

    The backend follows the session's layout: gloo for ranks on the CPU
    and for CUDA ranks, whose operands it stages through pinned host
    memory (NCCL refuses ranks that share a card, and a transport for
    ranks with cards of their own is not wired).  The choice is logged.
    """
    import torch.distributed as dist

    log = get_channel("dist")
    device = None if device is None else torch.device(device)
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        addr = coordinator_address or ""
        if not addr:
            init_method = "env://"
        elif "://" in addr:
            init_method = addr
        else:
            init_method = f"tcp://{addr}"
        dist.init_process_group(
            "gloo", init_method=init_method,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    world, rank = dist.get_world_size(), dist.get_rank()
    staged = device is not None and device.type == "cuda"
    cur = commlog._transport
    if cur is not None and (cur.world, cur.rank, cur.staged) == (
            world, rank, staged):
        return
    t = commlog.Transport(world, rank, staged)
    commlog.set_transport(t)
    log.info("multi-host: rank %d of %d; transport %s: %s", rank, world,
             t.backend, t.reason)


def process_count() -> int:
    """The ranks of this process's multi-host job (1 outside one)."""
    t = commlog.transport()
    return 1 if t is None else t.world


def quota(counts: Sequence[int], local_shards: int) -> Tuple[int, int]:
    """(per-rank rows, global rows) of ranks holding ``counts`` rows:
    every rank pads to the largest count rounded up to a multiple of its
    shard count."""
    share = max(int(local_shards), 1)
    per = int(-(-int(max(counts)) // share) * share)
    return per, per * len(counts)


def process_row_quota(local_rows: int, mesh: Mesh) -> Tuple[int, int]:
    """(per_process_rows, global_rows) for process-local ingest: every
    process pads its local rows to a common quota divisible by its
    shard count, so the global row-sharded layout is uniform.  Runs one
    tiny allgather of the local counts."""
    if mesh.world == 1:
        return local_rows, local_rows
    return quota(commlog.all_ranks(local_rows), mesh.local_size)


def global_from_process_local(mesh: Mesh, local: torch.Tensor, per: int,
                              fill=0) -> List[torch.Tensor]:
    """This rank's shards of a global row-sharded column, from its own
    rows padded to the common quota ``per`` (each rank feeds its
    shards; no rank holds the whole column)."""
    return mesh.split_local(pad_to(local, per, fill))


def pad_to(x: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """``x`` padded with ``fill`` to ``rows`` rows."""
    pad = rows - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def allgather_host_strings(strings: Sequence[str]) -> List[List[str]]:
    """Every process's string list, in rank order.  Strings ship as one
    NUL-separated utf-8 blob padded to the largest (two tiny
    collectives: sizes, then blobs)."""
    t = commlog.transport()
    if t is None:
        return [list(strings)]
    blob = np.frombuffer("\x00".join(strings).encode("utf-8"), np.uint8)
    sizes = commlog.all_ranks(blob.size)
    padded = np.zeros((max(max(sizes), 1),), np.uint8)
    padded[:blob.size] = blob
    blobs = t.all_gather([torch.from_numpy(padded)]).numpy()
    out = []
    for r, n in enumerate(sizes):
        b = bytes(blobs[r][:n])
        out.append(b.decode("utf-8").split("\x00") if b else [])
    return out


def unify_process_dictionary(dct) -> np.ndarray:
    """Multi-controller dictionary unification: every process
    contributes its process-local dictionary and all adopt the
    rank-ordered union as the canonical code space.  Returns the
    translation array old_local_code -> global_code for rewriting
    already-encoded columns.  Every process must call it at the same
    point of the same program (ingest is SPMD, so the order holds)."""
    local = dct.all_strings()
    canonical: list = []
    seen: dict = {}
    for proc_strings in allgather_host_strings(local):
        for s in proc_strings:
            if s not in seen:
                seen[s] = len(canonical)
                canonical.append(s)
    dct.replace_contents(canonical)
    return np.asarray([seen[s] for s in local], np.int32)


def pad_rows(x: Optional[torch.Tensor], multiple: int, fill=0
             ) -> Optional[torch.Tensor]:
    """Rows padded with ``fill`` to a multiple of ``multiple`` (the
    tensor itself when no padding is needed)."""
    if x is None:
        return None
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def align_process_local(name: str, cols, mesh: Optional[Mesh]):
    """Every rank's columns of a process-local table under one type, as
    (name, type, data, validity) tuples: the same names and physical
    types on every rank (else every rank raises), nullable with a
    validity array wherever one rank's is.  A job of several ranks needs
    a mesh over them."""
    if commlog.transport() is not None and (mesh is None or mesh.world == 1):
        raise ValueError(
            f"process_local table {name!r} needs a dist session over every "
            "rank (dist.enable with dist.multi_host)")
    mine = [(c, str(np.dtype(data.dtype)), data.shape[1:],
             typ.nullable or validity is not None)
            for c, typ, data, validity in cols]
    every = commlog.all_ranks_obj(mine)
    if any([m[:3] for m in r] != [m[:3] for m in mine] for r in every):
        raise ValueError(f"process_local table {name!r}: the ranks' columns "
                         f"differ ({[[m[:2] for m in r] for r in every]})")
    out = []
    for i, (c, typ, data, validity) in enumerate(cols):
        if any(r[i][3] for r in every):
            typ = typ.with_nullable(True)
            if validity is None:
                validity = np.ones(data.shape, np.bool_)
        out.append((c, typ, data, validity))
    return out


def share_process_layout(table) -> None:
    """Every rank's row count and each column's (min, max, has_nulls)
    over every rank, onto a process-local table: the planner reads
    these, so every rank plans alike."""
    local = {c: table.column_range(c) for c in table.column_names()}
    every = commlog.all_ranks_obj((table.nrows, local))
    ranges = {}
    for c in local:
        los = [r[1][c][0] for r in every if r[1][c][0] is not None]
        his = [r[1][c][1] for r in every if r[1][c][1] is not None]
        ranges[c] = (min(los) if los else None, max(his) if his else None,
                     any(r[1][c][2] for r in every))
    table.set_process_layout([r[0] for r in every], ranges)
