"""Severity/channel logging with per-query ids.

Reference semantics matched (not copied): Logger/Logger.h:95 severity
ladder (DEBUG4..DEBUG1 < INFO < WARNING < ERROR < FATAL), per-channel
loggers, and the query_str/query-id correlation the reference threads
through its request logs.

Thin layer over stdlib ``logging``: every record carries a ``qid``
attribute bound via a contextvar by ``query_context()`` so one query's
whole execution (routing decisions, retries, prune stats, timings) is
greppable by id.  Severity + optional file output come from DebugConfig
(``debug.log_severity``, ``debug.log_to_file`` under ``debug.log_dir``).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
from typing import Iterator, Optional

# reference ladder: DEBUG4 is the most verbose (Logger.h:95)
SEVERITIES = {
    "DEBUG4": 6,
    "DEBUG3": 7,
    "DEBUG2": 8,
    "DEBUG1": 9,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}

for _name, _level in SEVERITIES.items():
    logging.addLevelName(_level, _name)

_query_id: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "hdk_query_id", default=None)
_qid_counter = itertools.count(1)
_root = logging.getLogger("hdk_tpu_torch")
_configured = False


class _QidFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        qid = _query_id.get()
        record.qid = f"q{qid}" if qid is not None else "-"
        return True


class Channel:
    """One log channel (e.g. EXEC, DIST, IR) with severity helpers."""

    def __init__(self, name: str) -> None:
        self._log = logging.getLogger(f"hdk_tpu_torch.{name.lower()}")

    def _emit(self, sev: str, msg: str, *args) -> None:
        self._log.log(SEVERITIES[sev], msg, *args)

    def debug2(self, msg: str, *args) -> None:
        self._emit("DEBUG2", msg, *args)

    def debug1(self, msg: str, *args) -> None:
        self._emit("DEBUG1", msg, *args)

    def info(self, msg: str, *args) -> None:
        self._emit("INFO", msg, *args)

    def warning(self, msg: str, *args) -> None:
        self._emit("WARNING", msg, *args)

    def error(self, msg: str, *args) -> None:
        self._emit("ERROR", msg, *args)

    def enabled_for(self, sev: str) -> bool:
        return self._log.isEnabledFor(SEVERITIES[sev])


def get_channel(name: str) -> Channel:
    return Channel(name)


def configure(severity: str = "WARNING", log_to_file: bool = False,
              log_dir: str = "hdk_tpu_log") -> None:
    """Install handlers on the hdk_tpu_torch logger tree (idempotent; the last
    call wins, matching the reference's logger re-init)."""
    global _configured
    sev = severity.upper()
    if sev not in SEVERITIES:
        raise ValueError(
            f"unknown log severity {severity!r}; one of {list(SEVERITIES)}")
    for h in list(_root.handlers):
        _root.removeHandler(h)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(qid)s %(name)s: %(message)s")
    handler: logging.Handler = logging.StreamHandler()
    handler.setFormatter(fmt)
    handler.addFilter(_QidFilter())
    _root.addHandler(handler)
    if log_to_file:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "hdk_tpu_torch.log"))
        fh.setFormatter(fmt)
        fh.addFilter(_QidFilter())
        _root.addHandler(fh)
    _root.setLevel(SEVERITIES[sev])
    _root.propagate = False
    _configured = True


@contextlib.contextmanager
def query_context() -> Iterator[int]:
    """Bind a fresh query id to every log record in the block."""
    qid = next(_qid_counter)
    token = _query_id.set(qid)
    try:
        yield qid
    finally:
        _query_id.reset(token)


def current_query_id() -> Optional[int]:
    return _query_id.get()
