"""Nested debug timers.

Reference: omniscidb/Logger/Logger.h:318-374 — RAII DebugTimer /
DurationTree: per-thread nested timer trees with JSON export, enabled by
``enable_debug_timer``.  Same shape here: a context manager building a
per-thread tree; ``timer_report()`` returns the last root as a dict.

A span reads the host clock and forces nothing.  On a CUDA device the
executor's step spans (``step:<Node>#<id>``) therefore measure the
step's launches and the host syncs inside it, not its device time;
EXPLAIN ANALYZE (``HDK.explain(q, analyze=True)``) forces each step and
gives that.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

_state = threading.local()
_enabled = False


def enable_debug_timer(on: bool = True) -> None:
    global _enabled
    _enabled = on


class _TimerNode:
    __slots__ = ("name", "start", "elapsed_ms", "children")

    def __init__(self, name: str) -> None:
        self.name = name
        self.start = time.perf_counter()
        self.elapsed_ms: float = 0.0
        self.children: List[_TimerNode] = []

    def to_dict(self) -> Dict:
        out = {"name": self.name, "ms": round(self.elapsed_ms, 3)}
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class DebugTimer:
    """``with DebugTimer("step"): ...`` — no-op unless enabled."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.node: Optional[_TimerNode] = None

    def __enter__(self):
        if not _enabled:
            return self
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        self.node = _TimerNode(self.name)
        if stack:
            stack[-1].children.append(self.node)
        stack.append(self.node)
        return self

    def __exit__(self, *exc):
        if self.node is None:
            return False
        self.node.elapsed_ms = (time.perf_counter() - self.node.start) * 1e3
        stack = _state.stack
        stack.pop()
        if not stack:
            _state.last_root = self.node
        return False


def timer_report() -> Optional[Dict]:
    """Last completed root timer tree (reference: DebugTimer JSON export)."""
    root = getattr(_state, "last_root", None)
    return root.to_dict() if root is not None else None


def timer_report_json() -> str:
    rep = timer_report()
    return json.dumps(rep, indent=2) if rep else "{}"
