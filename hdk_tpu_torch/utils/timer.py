"""Nested debug timers.

Reference: omniscidb/Logger/Logger.h:318-374 — RAII DebugTimer /
DurationTree: per-thread nested timer trees with JSON export, enabled by
``enable_debug_timer``.  Same shape here: a context manager building a
per-thread tree; ``timer_report()`` returns the last root as a dict.

A node's ``children`` are the step tree: the executor's step spans
(``step:<Node>#<id>``) and any span a caller opens, each under the
innermost open span that is not a stage.  The front end's spans are
stages (``DebugTimer(name, stage=True)``), kept apart in the innermost
open span's ``stages``:

- ``sql:bind`` around the binder in ``HDK.sql``, with ``sql:parse``
  (the parser) inside it;
- ``plan:optimize`` around ``optimize_dag`` and the plan-variant choice
  in ``HDK._run``;
- ``exec:prepare``: the executor's analysis of the plan before its
  first step (order, column demand, consumers, fusions, recycled
  builds).

So a span's children are what they were before the stages existed: a
step that runs inside a stage (a subquery the binder executes) still
hangs under the span around the query, and a root less its children is
still the host time outside the steps.  The program opens no root of
its own, so after a bare ``run()`` the last root is the last step.

A span reads the host clock and forces nothing.  On a CUDA device a step
span therefore measures the step's launches and the host syncs inside
it, not its device time; EXPLAIN ANALYZE (``HDK.explain(q,
analyze=True)``) forces each step and gives that.

While the timer is on and a span is open, each device-to-host
synchronisation that PyTorch's CUDA backend makes (``.item()``,
``nonzero``, boolean-mask indexing, a copy to the host: what
``torch.cuda.set_sync_debug_mode`` flags; an explicit
``torch.cuda.synchronize()`` is not flagged) adds one to the ``syncs``
of the innermost open span.  The first root to open sets the sync debug
mode to "warn" inside a ``warnings.catch_warnings()`` that takes those
warnings; the last root to close puts the mode and the warning state
back.  Where the mode was already set, or there is no CUDA, nothing is
counted.

Named counters (``COUNTERS``) go on the innermost open span too:
``count(name)`` adds to it while the timer is on.  ``exec/groupby.py``
counts ``gid_array`` for a dense-route or scalar reduction that builds
the group-id array, ``gid_keys`` for one whose ids the histogram step
derives from the keys; for each exact quantile reduction it counts
``pair_segsort`` where each group's value keys are sorted in place (the
pair-sort kernel) and ``pair_lexsort`` where the permutation of the
sorted (group, value) pairs is built.  Its spans ``agg:gid_array``
(building the array) and ``agg:pair_sort`` (the sort of (group, value)
pairs behind quantiles, DISTINCT and TOP_K, either route) hang under the
step that runs them.

``span_totals()`` sums self times (a span's ms less the ms of the spans
opened inside it), syncs and counters by span name over every span
closed since the timer was turned on.
"""

from __future__ import annotations

import json
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

_state = threading.local()
_enabled = False
_cuda = False
_SYNC_WARNING = "called a synchronizing CUDA operation"
_capture = None  # the warning state the open roots count syncs in
_roots_open = 0  # roots open, every thread
_totals: Dict[str, list] = {}
_lock = threading.Lock()
COUNTERS = ("gid_array", "gid_keys", "pair_segsort", "pair_lexsort")


def enable_debug_timer(on: bool = True) -> None:
    global _enabled, _cuda
    if on and not _enabled:
        with _lock:
            _totals.clear()
        _cuda = torch.cuda.is_available()
    _enabled = on


def _root_opened() -> None:
    """The first open root sets the sync debug mode to "warn" and takes
    its warnings into the innermost open span of the warning's thread."""
    global _capture, _roots_open
    with _lock:
        _roots_open += 1
        if (_roots_open > 1 or not _cuda
                or torch.cuda.get_sync_debug_mode()):
            return
        _capture = warnings.catch_warnings()
        _capture.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        # set_sync_debug_mode's notice that the mode is a prototype
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if not str(message).startswith(_SYNC_WARNING):
                shown(message, category, filename, lineno, file, line)
                return
            stack = getattr(_state, "stack", None)
            if stack:
                stack[-1].syncs += 1

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")


def _root_closed() -> None:
    """The last root to close puts the sync debug mode ("default") and
    the warning state back."""
    global _capture, _roots_open
    with _lock:
        _roots_open -= 1
        if _roots_open or _capture is None:
            return
        torch.cuda.set_sync_debug_mode(0)
        _capture.__exit__(None, None, None)
        _capture = None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of ``COUNTERS``) of this
    thread's innermost open span; nothing while the timer is off or no
    span is open."""
    if name not in COUNTERS:
        raise ValueError(f"no counter {name!r}; the counters: {COUNTERS}")
    stack = getattr(_state, "stack", None) if _enabled else None
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


class _TimerNode:
    __slots__ = ("name", "start", "elapsed_ms", "children", "stages",
                 "syncs", "counts", "inner_ms", "stage")

    def __init__(self, name: str, stage: bool) -> None:
        self.name = name
        self.stage = stage
        self.start = time.perf_counter()
        self.elapsed_ms: float = 0.0
        self.inner_ms = 0.0  # the ms of the spans opened inside this one
        self.children: List[_TimerNode] = []
        self.stages: List[_TimerNode] = []
        self.syncs = 0
        self.counts: Dict[str, int] = {}

    def to_dict(self) -> Dict:
        out = {"name": self.name, "ms": round(self.elapsed_ms, 3)}
        if self.syncs:
            out["syncs"] = self.syncs
        out.update(self.counts)
        if self.stages:
            out["stages"] = [c.to_dict() for c in self.stages]
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class DebugTimer:
    """``with DebugTimer("step"): ...`` — no-op unless enabled.  A
    ``stage`` goes into the open span's ``stages``, not its children."""

    def __init__(self, name: str, stage: bool = False) -> None:
        self.name = name
        self.stage = stage
        self.node: Optional[_TimerNode] = None
        self._root = False

    def __enter__(self):
        if not _enabled:
            return self
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        node = self.node = _TimerNode(self.name, self.stage)
        if self.stage:
            parent = stack[-1] if stack else None
            if parent is not None:
                parent.stages.append(node)
        else:
            parent = next((n for n in reversed(stack) if not n.stage), None)
            if parent is not None:
                parent.children.append(node)
        self._root = parent is None
        if not stack:
            _root_opened()
        stack.append(node)
        return self

    def __exit__(self, *exc):
        node = self.node
        if node is None:
            return False
        node.elapsed_ms = (time.perf_counter() - node.start) * 1e3
        stack = _state.stack
        stack.pop()
        if stack:
            stack[-1].inner_ms += node.elapsed_ms
        else:
            _root_closed()
        if self._root:
            _state.last_root = node
        with _lock:
            tot = _totals.setdefault(node.name.split("#")[0],
                                     [0, 0.0, 0, {}])
            tot[0] += 1
            tot[1] += node.elapsed_ms - node.inner_ms
            tot[2] += node.syncs
            for name, n in node.counts.items():
                tot[3][name] = tot[3].get(name, 0) + n
        return False


def timer_report() -> Optional[Dict]:
    """Last completed root timer tree (reference: DebugTimer JSON export)."""
    root = getattr(_state, "last_root", None)
    return root.to_dict() if root is not None else None


def timer_report_json() -> str:
    rep = timer_report()
    return json.dumps(rep, indent=2) if rep else "{}"


def span_totals() -> Dict[str, Dict]:
    """Per span name (a step's ``#<id>`` dropped), over the spans of every
    thread closed since the timer was last turned on: ``{"spans": how
    many, "self_ms": their ms less the ms of the spans opened inside
    them, "syncs": the syncs counted in them and not in an inner span}``,
    and beside ``syncs`` each of ``COUNTERS`` that counted in them."""
    with _lock:
        return {k: {"spans": n, "self_ms": ms, "syncs": s, **counts}
                for k, (n, ms, s, counts) in _totals.items()}
