"""The collectives of multi-device sessions, and their accounting
(counterpart of hdk_tpu/utils/commlog.py).

A session's mesh lives in one process (``parallel/mesh.py``): a shard's
tensors are the entries of a list, one per shard, each on its shard's
device.  Every collective of the distributed operators goes through the
functions below, which take that list and return one: ``all_to_all``
(the shuffle's exchange), ``psum`` / ``pmin`` / ``pmax`` (replicated
reductions), ``all_gather`` (replicated concatenation) and ``gather``
(the mesh's concatenation onto its first device, which every consumer
without a distributed route reads).  A later multi-process transport goes
under these same functions.

Inside ``capture()`` each call records its op, the bytes of one shard's
operand and the shard count, as the JAX package records them at trace
time; ``gather`` records an ``all_gather`` marked ``"gather": True``, so
a capture shows every fall-back to the gathered view apart from the
operators' own collectives.  ``summarize`` keeps the JAX package's wire
model (bytes that leave a device per collective); no link rate is
assumed for it here.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch

_active: Optional[List[dict]] = None


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
            gather: bool = False) -> None:
    if _active is None:
        return
    rec = {"op": op, "axis": "frag", "bytes_per_device":
           _nbytes(shard_operand), "shards": n_shards}
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
    _record("all_to_all", xs[0], len(xs))
    p = len(xs)
    return [torch.stack([_to(xs[s][d], xs[d].device) for s in range(p)])
            for d in range(p)]


def _reduce(op: str, xs: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    _record(op, xs[0], len(xs))
    dev = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
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
    _record("all_gather", xs[0], len(xs))
    dev = xs[0].device
    parts = [_to(x, dev) for x in xs]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts)
    return _replicate(out, xs)


def gather(xs: Sequence[torch.Tensor], device: torch.device
           ) -> torch.Tensor:
    """The shards' rows concatenated on ``device``.  Shards that are
    consecutive views of one tensor (a scan's shards on one card) give
    that tensor back, nothing copied."""
    _record("all_gather", xs[0], len(xs), gather=True)
    base = _contiguous_base(xs)
    if base is not None and base.device == device:
        return base
    return torch.cat([_to(x, device) for x in xs])


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
