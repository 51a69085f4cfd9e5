"""The device trace of a fixed slice of the traced window.

``torch.profiler`` records the device's operations (CUDA activity only:
recording every host operator would slow the host side it measures).  A
marker kernel launched at a known host time ties the profiler's clock to
``time.perf_counter``, so the host spans of the benchmark and the
program's step spans can label the device's idle gaps.  Busy time is the
union of the operations' intervals (``profile_smoke.py``'s ``_busy_us``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

MARKER_CYCLES = 1000
MARKER = "spin"  # torch.cuda._sleep's kernel
NAME_CHARS = 160


def start():
    """Start the profiler; returns (profiler, host time of the marker)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    prof.start()
    torch.cuda.synchronize()
    t_marker = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    return prof, t_marker


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of each device operation of a stopped
    profiler."""
    from torch.autograd import DeviceType

    return [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
            for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(t: float, spans) -> str:
    """The deepest host span open at host time ``t``."""
    best, depth = "between queries", -1
    for t0, t1, d, name in spans:
        if t0 <= t < t1 and d > depth:
            best, depth = name, d
    return best


def summarize(events, t_marker: float, t_end: float,
              spans: List[Tuple[float, float, int, str]], top: int = 10
              ) -> Optional[Dict]:
    """Busy and window seconds, device time by operation name, and the
    longest idle gaps labelled by ``spans`` ((host start, host end,
    depth, label); the deepest open span names a gap).  None where the
    trace holds no device operation."""
    marker = next((e for e in events if MARKER in e[0]), None)
    ops = [e for e in events if e is not marker]
    if not ops:
        return None
    window_s = t_end - t_marker
    by_name: Dict[str, float] = {}
    for name, s, e in ops:
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    gaps = []
    if marker is not None:
        to_host = lambda us: t_marker + (us - marker[1]) / 1e6  # noqa: E731
        edges = [[marker[1], marker[1]]] + _merged([(s, e) for _, s, e in ops])
        end_us = marker[1] + window_s * 1e6
        edges.append([end_us, end_us])
        for (_, e0), (s1, _) in zip(edges, edges[1:]):
            if s1 > e0:
                mid = to_host((e0 + s1) / 2)
                gaps.append((_label(mid, spans), (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": window_s,
        "busy_s": busy_us([(s, e) for _, s, e in ops]) / 1e6,
        "ops_s": by_name,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": [[n, s] for n, s in gaps[:top]],
    }
