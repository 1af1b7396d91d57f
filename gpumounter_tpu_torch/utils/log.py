"""Logging for the control plane: child loggers under one root.

The counterpart of ``gpumounter_tpu/utils/log.py``'s ``get_logger``. The
daemon's sinks (stdout, a file, JSON lines with the trace id) come with the
daemons, in a later slice; until then a process that wants these lines
configures ``logging`` itself.
"""

from __future__ import annotations

import logging

ROOT = "gpumounter_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    """Child logger under the package's root logger."""
    return logging.getLogger(ROOT).getChild(name)
