"""Measured-feedback route tuning (counterpart of
hdk_tpu/exec/feedback.py).

Near a cost-model tier boundary either route can win, so the first
repetitions of a plan shape run each candidate route once, timed warm
with a device synchronize; the EWMA of those times is kept, and later
repetitions run the measured winner.  Exploring costs one extra warm
execution per candidate route per plan shape; the steady state pays
nothing.  ``PlanChoiceFeedback`` lifts the same pattern to whole-plan
variants (the eager-aggregation rewrite against the original plan).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import torch


class RouteFeedback:
    """Per-session (plan signature, route) -> EWMA seconds."""

    def __init__(self, enabled: bool = True, ewma: float = 0.3,
                 limit: int = 4096) -> None:
        self.enabled = enabled
        self._ewma = ewma
        self._limit = limit
        self._t: Dict[Tuple[str, str], float] = {}

    def choose(self, sig: str, routes: Sequence[str]
               ) -> Tuple[str, bool]:
        """(route, measure): an unmeasured route to explore (in order),
        else the measured winner.  ``measure`` asks the caller to time
        this execution with a synchronize and call ``record``."""
        if not self.enabled or len(routes) == 1:
            return routes[0], False
        for r in routes:
            if (sig, r) not in self._t:
                return r, True
        return min(routes, key=lambda r: self._t[(sig, r)]), False

    def record(self, sig: str, route: str, seconds: float) -> None:
        if not self.enabled:
            return
        if len(self._t) > self._limit:
            self._t.clear()
        k = (sig, route)
        old = self._t.get(k)
        self._t[k] = (seconds if old is None
                      else (1 - self._ewma) * old + self._ewma * seconds)

    def measured(self, sig: str) -> Dict[str, float]:
        return {r: s for (g, r), s in self._t.items() if g == sig}


class PlanChoiceFeedback:
    """Explore-once A/B between whole-plan variants.  Per (plan
    signature, variant) the first repetition runs cold (untimed: it pays
    the set-up), the second runs warm and is recorded; once every
    variant is measured, the winner runs.  ``choose`` returns (variant,
    mode), mode one of "cold", "timed" or None."""

    def __init__(self, fb: RouteFeedback) -> None:
        self._fb = fb
        self._cold: set = set()

    def choose(self, sig: str, variants: Sequence[str]
               ) -> Tuple[str, Optional[str]]:
        if not self._fb.enabled or len(variants) == 1:
            return variants[0], None
        for v in variants:
            if (sig, v) in self._fb._t:
                continue
            if (sig, v) in self._cold:
                return v, "timed"
            if len(self._cold) > 4096:
                self._cold.clear()
            self._cold.add((sig, v))
            return v, "cold"
        return min(variants, key=lambda v: self._fb._t[(sig, v)]), None

    def record(self, sig: str, variant: str, seconds: float) -> None:
        self._fb.record(sig, variant, seconds)

    def measured(self, sig: str) -> Dict[str, float]:
        return self._fb.measured(sig)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU, where torch runs each call to its end)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_sync(fn, *args, device: torch.device):
    """Run ``fn(*args)`` twice, each ending in a device synchronize, and
    time the second: (outputs, warm seconds).  The first run pays the
    set-up (first launches, allocator growth), so an explored route is timed
    warm, as the JAX package times its compiled program."""
    fn(*args)
    synchronize(device)
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize(device)
    return out, time.perf_counter() - t0


def timed_wall(fn):
    """Explore-once wall timing of a route with host syncs inside: run
    ``fn`` twice and time the second run.  ``fn`` forces its own outputs
    (``Executor._force_table``).  Returns (out, seconds)."""
    fn()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
