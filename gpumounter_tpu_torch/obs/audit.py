"""Append-only audit trail for every mutating control-plane operation.

The counterpart of ``gpumounter_tpu/obs/audit.py``, whole. A record keeps
the reference's keys, the JSON contract of /audit: ``chips`` lists the
UUIDs of the GPUs an operation moved.

Each record answers, without log spelunking: who asked (actor), what
moved (operation, pod, chips, idempotency key), how it ended (outcome),
how long it took, and which trace tells the full story (trace id — the
join key into obs.trace and the structured logs).

The `audited()` context manager is the writing discipline: the record
is emitted in a finally block, so every operation — including one died
by an injected CrashError mid-phase — leaves a terminal record. The
chaos harness asserts exactly that (testing/chaos.py invariant 5/6:
terminal audit records, no orphan open spans).

Storage is a bounded in-memory ring (the master /audit route and the
`tpumounter audit` CLI of the reference read it) plus an optional append-only JSONL file
for durability across restarts. Stdlib-only (lazy-grpc policy).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque

from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("obs.audit")


class AuditLog:
    """Thread-safe bounded append-only record store."""

    def __init__(self, capacity: int = 4096):
        from gpumounter_tpu_torch.obs.sinks import JsonlSink
        self._records: deque[dict] = deque(maxlen=capacity)
        self._lock = OrderedLock("audit.records")
        self._seq = itertools.count(1)
        self._jsonl = JsonlSink("audit")
        # Record subscribers (the flight recorder's timeline feed):
        # called outside the lock, exceptions logged and swallowed —
        # a broken observer must never fail the mutation being audited.
        self._subscribers: list = []

    def subscribe(self, fn) -> None:
        """fn(record) after every append. Idempotent by identity, so a
        process-global hook can re-install itself freely."""
        with self._lock:
            if not any(s is fn for s in self._subscribers):
                self._subscribers.append(fn)

    def configure_jsonl(self, path: str) -> None:
        self._jsonl.configure(path)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._records = deque(self._records, maxlen=max(1, capacity))

    def record(self, operation: str, actor: str = "", namespace: str = "",
               pod: str = "", chips: list[str] | tuple | None = None,
               idempotency_key: str = "", outcome: str = "",
               duration_s: float = 0.0, trace_id: str | None = None,
               **details) -> dict:
        """Append one record. trace_id defaults to the ambient one —
        callers inside a span need not thread it through."""
        rec = {
            "seq": next(self._seq),
            "at": round(time.time(), 3),
            "operation": operation,
            "actor": actor,
            "namespace": namespace,
            "pod": pod,
            "chips": sorted(chips) if chips else [],
            "idempotency_key": idempotency_key,
            "outcome": outcome,
            "duration_s": round(duration_s, 6),
            "trace_id": trace.current_trace_id()
            if trace_id is None else trace_id,
        }
        if details:
            rec["details"] = {k: v for k, v in details.items()}
        with self._lock:
            self._records.append(rec)
            subscribers = list(self._subscribers)
        self._jsonl.write(rec)
        for fn in subscribers:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — observers never fail the op
                logger.exception("audit subscriber failed")
        return rec

    def query(self, operation: str | None = None,
              namespace: str | None = None, pod: str | None = None,
              trace_id: str | None = None, outcome: str | None = None,
              limit: int = 100) -> list[dict]:
        """Newest-first filtered view. `operation` and `outcome` match
        as prefixes (op="worker." or outcome="error" sweep a family)."""
        with self._lock:
            records = list(self._records)
        out = []
        for rec in reversed(records):
            if operation and not rec["operation"].startswith(operation):
                continue
            if namespace and rec["namespace"] != namespace:
                continue
            if pod and rec["pod"] != pod:
                continue
            if trace_id and rec["trace_id"] != trace_id:
                continue
            if outcome and not rec["outcome"].startswith(outcome):
                continue
            out.append(dict(rec))
            if len(out) >= max(1, limit):
                break
        return out

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._jsonl.configure("")


AUDIT = AuditLog()


def query_from_params(params: dict[str, list[str]],
                      log: AuditLog | None = None) -> dict:
    """The /audit query contract, shared by the master route and the
    worker ops port so the two daemons cannot drift: last-value-wins
    params `namespace`/`pod`/`op`/`trace`/`outcome`/`limit` (default
    100). Raises ValueError on a non-integer limit."""

    def _one(key: str) -> str | None:
        values = params.get(key)
        return values[-1] if values else None

    limit = int(_one("limit") or 100)
    sink = log or AUDIT
    return {"records": sink.query(
        operation=_one("op"), namespace=_one("namespace"),
        pod=_one("pod"), trace_id=_one("trace"),
        outcome=_one("outcome"), limit=limit)}


def configure(cfg) -> None:
    """Daemon-startup wiring (master/worker main): record capacity and
    the optional JSONL sink from config."""
    AUDIT.set_capacity(cfg.audit_capacity)
    AUDIT.configure_jsonl(cfg.audit_jsonl)


@contextlib.contextmanager
def audited(operation: str, actor: str = "", namespace: str = "",
            pod: str = "", chips: list[str] | None = None,
            idempotency_key: str = "", log: AuditLog | None = None,
            **details):
    """Wrap one mutating operation; ALWAYS writes a terminal record.

    Yields a mutable dict the body may enrich ("outcome", "chips",
    "details"). An unhandled exception (CrashError included) records
    `error: <type>: <msg>` as the outcome and re-raises.
    """
    sink = log or AUDIT
    holder: dict = {"chips": list(chips or []), "details": dict(details)}
    t0 = time.monotonic()
    try:
        yield holder
        holder.setdefault("outcome", "success")
    except BaseException as exc:
        # setdefault: a body that already classified the failure (the
        # HTTP edge recording the mapped status) wins over the generic
        # error string.
        holder.setdefault("outcome", f"error: {type(exc).__name__}: {exc}")
        raise
    finally:
        sink.record(
            operation, actor=actor, namespace=namespace, pod=pod,
            chips=holder.get("chips"),
            idempotency_key=idempotency_key,
            outcome=holder.get("outcome", "error: abandoned"),
            duration_s=time.monotonic() - t0,
            **holder.get("details", {}))
