"""The device mesh of a multi-device session (counterpart of the
single-process part of hdk_tpu/parallel/mesh.py).

One process addresses every shard, as the JAX package's single
controller does.  A mesh is a list of shard devices, one per shard, and a
device may repeat: shard i sits on ``devices[i % count]`` of the
session's device type, so four shards on one card share it and run one
after another on its current stream.  A session asked for the card never
computes on the CPU: it places several shards on one card and logs that
it did.

Rows shard in equal consecutive ranges (``split``); a column whose rows
are not a multiple of the shard count is padded first (``pad_rows``) and
the padding rides the row mask.  Where every shard is on the tensor's own
device the shards are ``narrow`` views of it, nothing copied, and
``gather`` of those views gives the tensor back; shards on other devices
are copies, kept per source tensor while it lives.  Multi-host meshes
wait for ROADMAP A9b.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence

import torch

from ..exec.masked import MaskedCol
from ..utils import commlog
from ..utils.logger import get_channel


class Mesh:
    """Shard devices of one process, ``devices[i]`` holding shard i."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        # per-shard copies on other devices, by source tensor
        self._copies: Dict[int, tuple] = {}

    @property
    def device(self) -> torch.device:
        """The device of shard 0, where gathered and replicated results
        live."""
        return self.devices[0]

    def split(self, x: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """Row shards of ``x`` (rows a multiple of the shard count)."""
        if x is None:
            return [None] * self.size
        rows = x.shape[0]
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split over "
                             f"{self.size} shards (pad_rows first)")
        per = rows // self.size
        views = [x.narrow(0, i * per, per) for i in range(self.size)]
        if all(d == x.device for d in self.devices):
            return views
        got = self._copies.get(id(x))
        if got is not None and got[0]() is x:
            return list(got[1])
        out = [v if d == x.device else v.to(d)
               for v, d in zip(views, self.devices)]
        self._copies = {k: v for k, v in self._copies.items()
                        if v[0]() is not None}
        self._copies[id(x)] = (weakref.ref(x), tuple(out))
        return out

    def split_col(self, c: Optional[MaskedCol]) -> List[Optional[MaskedCol]]:
        if c is None:
            return [None] * self.size
        ds, ms = self.split(c.data), self.split(c.mask)
        return [MaskedCol(d, m) for d, m in zip(ds, ms)]

    def gather(self, xs: Sequence[Optional[torch.Tensor]]
               ) -> Optional[torch.Tensor]:
        """The shards' rows concatenated on shard 0's device (a recorded
        ``all_gather``, see ``utils/commlog.gather``)."""
        if xs[0] is None:
            return None
        return commlog.gather(list(xs), self.device)

    def view(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The gathered view of ``x``'s shards, as a step without a
        distributed route reads it (a recorded gather): ``x`` itself
        where every shard lies on its device."""
        if x is None:
            return None
        got = self.gather(self.split(x))
        return x if all(d == x.device for d in self.devices) else got

    def gather_col(self, cs: Sequence[MaskedCol]) -> MaskedCol:
        return MaskedCol(self.gather([c.data for c in cs]),
                         self.gather([c.mask for c in cs]))


def make_mesh(n_shards: int, device: torch.device) -> Mesh:
    """``n_shards`` shards on the devices of ``device``'s type: on CUDA
    shard i on card (first + i) % count, where ``first`` is the session's
    card; on the CPU every shard on the CPU."""
    log = get_channel("dist")
    device = torch.device(device)
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
    return Mesh(devs)


def default_shards(device: torch.device) -> int:
    """``dist.num_devices`` 0: every card on CUDA, one device on the
    CPU."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


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
