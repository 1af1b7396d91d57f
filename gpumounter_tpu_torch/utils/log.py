"""Logging for the control plane: child loggers under one root, and the
daemons' sinks.

The counterpart of ``gpumounter_tpu/utils/log.py``. Two output modes
(TPUMOUNTER_LOG_FORMAT, or ``init_logger(json_mode=...)``):

  console  a tab-separated line: time, level, logger, message (default)
  json     one JSON object per line: ts, level, logger, msg, and the trace
           id whenever an ``obs.trace`` span is open, so that log lines and
           spans join on it.

The trace id is stamped by a ``logging.Filter`` on the handlers in both
modes (the console line does not render it); the filter imports
``obs.trace`` lazily, since that module logs through this one.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading

ROOT = "gpumounter_tpu_torch"

_LOCK = threading.Lock()
_INITIALIZED = False

_FMT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s"
_DATEFMT = "%Y-%m-%dT%H:%M:%S%z"


class TraceIdFilter(logging.Filter):
    """Stamp the ambient trace id (the ``obs.trace`` contextvar) on every
    record as ``trace_id`` ("" outside a span)."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            from gpumounter_tpu_torch.obs.trace import current_trace_id
            record.trace_id = current_trace_id()
        except Exception:  # noqa: BLE001 — logging must never raise
            record.trace_id = ""
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line; ``trace_id`` only when traced."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, _DATEFMT),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            out["trace_id"] = trace_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def init_logger(json_mode: bool | None = None) -> logging.Logger:
    """The daemons' log stream: the package root's handler on stderr (the
    reference's writes stdout), at INFO, with the trace-id filter.
    json_mode None reads TPUMOUNTER_LOG_FORMAT ("json" turns it on). A later
    call changes nothing."""
    global _INITIALIZED
    if json_mode is None:
        json_mode = os.environ.get("TPUMOUNTER_LOG_FORMAT", "console").strip().lower() == "json"
    root = logging.getLogger(ROOT)
    with _LOCK:
        if _INITIALIZED:
            return root
        root.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(JsonFormatter(datefmt=_DATEFMT) if json_mode
                             else logging.Formatter(_FMT, datefmt=_DATEFMT))
        # on the handler: a child logger's record reaches the root's
        # handlers without the root's own filters
        handler.addFilter(TraceIdFilter())
        root.addHandler(handler)
        root.propagate = False
        _INITIALIZED = True
    return root


def get_logger(name: str) -> logging.Logger:
    """Child logger under the package's root logger."""
    return logging.getLogger(ROOT).getChild(name)
