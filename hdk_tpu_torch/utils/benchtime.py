"""Query timing on a torch device (counterpart of hdk_tpu/utils/benchtime.py).

A query's result is not finished when ``run()`` returns:

  * CUDA kernels run after the host has queued them;
  * a join's output columns are gathered only when a consumer reads them
    (``exec/common.py::_LazyThunkColumns``), and a scan's are copied to
    the device on first access;
  * the shards of a multi-device session may sit on other cards than the
    session's (``parallel/mesh.py``: shard i on card i mod count).

``QueryResult.block()`` only synchronizes the session's card, so a timer
built on it would time a join without its gathers.  ``sync`` reads every
column of the result (which forces the lazy ones), then synchronizes
every CUDA device that the result's tensors and the session's mesh live
on.  That is the completion signal: CUDA streams run in order, so a host
readback is not needed.

Two measurements, both on the host clock (``time.perf_counter``):

  * ``latency`` -- the median of single calls, each synced.  What an
    interactive user sees.
  * ``throughput`` -- ``iters`` calls back to back, each result's lazy
    columns forced, one sync at the end.  What a client sending queries
    back to back sustains.

An eager torch query synchronizes inside ``run()`` wherever the host
needs a device value (a ``.item()``, the row count of a ``nonzero``, a
live count), so throughput amortizes less of the host's time than it
does on the JAX package's asynchronous dispatch; both figures are
reported anyway.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Set

import torch


def _tips(result) -> List[torch.Tensor]:
    """Every tensor behind ``result``: a ``QueryResult``'s columns (each
    indexed, which forces a lazy one), their masks and the row mask; or
    the tensors in a tensor, tuple, list or dict."""
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, dict):
        return [x for v in result.values() for x in _tips(v)]
    if isinstance(result, (tuple, list)):
        return [x for v in result for x in _tips(v)]
    table = getattr(result, "_table", None)
    if table is None:  # an offloaded result, or no tensor at all
        return []
    out = []
    for i in range(len(table.columns)):
        c = table.columns[i]
        out.append(c.data)
        if c.mask is not None:
            out.append(c.mask)
    if table.row_mask is not None:
        out.append(table.row_mask)
    return out


def _mesh_devices(result) -> Set[torch.device]:
    session = getattr(result, "_session", None)
    mesh = getattr(getattr(session, "_executor", None), "_mesh", None)
    return set(mesh.devices) if mesh is not None else set()


def _devices(result) -> Set[torch.device]:
    """The CUDA devices of ``result``'s tensors and its session's mesh
    (reading the tensors forces the lazy columns)."""
    devs = {t.device for t in _tips(result)} | _mesh_devices(result)
    return {d for d in devs if d.type == "cuda"}


def _synchronize(devices: Set[torch.device]) -> None:
    for d in sorted(devices, key=str):
        torch.cuda.synchronize(d)


def sync(result):
    """Force ``result``'s lazy columns and wait for every CUDA device it
    and its session's shards live on; returns ``result``."""
    _synchronize(_devices(result))
    return result


def measure(fn: Callable, warmup: int = 2, iters: int = 8,
            latency_iters: int = 5) -> Dict[str, float]:
    """Time ``fn`` (a no-argument callable returning a QueryResult or
    tensors).  Returns {"latency_s", "throughput_s"}: seconds a query."""
    for _ in range(max(warmup, 1)):  # builds, caches, route feedback
        sync(fn())

    lat = []
    for _ in range(latency_iters):
        t0 = time.perf_counter()
        sync(fn())
        lat.append(time.perf_counter() - t0)

    devices: Set[torch.device] = set()
    t0 = time.perf_counter()
    for _ in range(iters):
        devices |= _devices(fn())  # queues the lazy columns' work too
    _synchronize(devices)
    thr = (time.perf_counter() - t0) / iters

    lat.sort()
    return {"latency_s": lat[len(lat) // 2] if lat else float("nan"),
            "throughput_s": thr}

