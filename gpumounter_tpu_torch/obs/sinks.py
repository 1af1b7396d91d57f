"""Shared durable-spill discipline for the observability stores.

The counterpart of ``gpumounter_tpu/obs/sinks.py``, whole.

The trace ring, the audit trail, and the flight recorder all pair a
bounded in-memory store with an optional append-only JSONL file. The
failure discipline is identical everywhere — a write failure logs once
and the sink disables itself, because recording must never take down
the operation being recorded (a full disk must not fail a mount) —
so it lives here once instead of three diverging copies.

Stdlib-only (lazy-grpc policy: every consumer is on the mount path).
"""

from __future__ import annotations

import json

from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("obs.sinks")


class JsonlSink:
    """Append-only one-record-per-line JSONL spill, self-disabling on
    the first OSError. `label` names the owning store in the one error
    line the failure gets."""

    def __init__(self, label: str, path: str = ""):
        self.label = label
        self.path = path
        self.broken = False

    def configure(self, path: str) -> None:
        self.path = path
        self.broken = False

    def write(self, rec: dict) -> None:
        if not self.path or self.broken:
            return
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        except OSError as exc:
            self.broken = True
            logger.error("%s JSONL sink %s failed (%s); disabling",
                         self.label, self.path, exc)
