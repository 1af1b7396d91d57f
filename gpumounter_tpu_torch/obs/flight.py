"""Incident flight recorder: one chronological timeline per process.

The counterpart of ``gpumounter_tpu/obs/flight.py``, whole. In the port
the ApiHealth transitions have no source until ``k8s/health.py`` lands,
nor the recovery markers until ``recovery/``: ``install(apihealth=None)``
hooks the spans and the audit trail, and ``k8s/events.py`` records each
Event.

After an incident the operator's first question is "what happened, in
order?" — and before this module the answer was scattered across four
stores with four query surfaces (spans in the trace ring, mutations in
the audit trail, k8s Events in the cluster, ApiHealth verdicts in
/apihealth) plus log files. The flight recorder merges the control
plane's significant moments into ONE bounded, durably-spillable
timeline:

  * root and error spans (via a tracer exporter — child spans stay in
    the trace ring where /trace/<id> tells their detailed story),
  * every audit record (via the audit log's subscriber hook),
  * every Kubernetes Event this process posts (k8s/events.py + the SLO
    engine's breach Events),
  * ApiHealth state transitions (k8s/health.py subscriber),
  * recovery/evacuation markers (recovery/controller.py).

Queryable at GET /timeline?node=&trace=&kind=&from=&to=&limit= on the
master (and the worker ops port) and as `tpumounter timeline`; each
entry carries the trace id that was ambient when it was recorded, so
the walkthrough is timeline -> trace -> audit (docs/RUNBOOK.md
"Reconstructing an incident with the flight recorder").

Bounded in memory (TPUMOUNTER_FLIGHT_CAPACITY); with a spill path
configured (TPUMOUNTER_FLIGHT_JSONL) every record is also appended to
an append-only JSONL file so a post-mortem can reach past the ring —
same write-failure discipline as the audit sink (log once, disable,
never fail the operation being recorded).

Stdlib-only (lazy-grpc policy: this is on the mount path via the span
exporter).
"""

from __future__ import annotations

import itertools
import time
from collections import deque

from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.metrics import REGISTRY

FLIGHT_RECORDS = REGISTRY.counter(
    "tpumounter_flight_records_total",
    "Flight-recorder timeline records by kind (span / audit / event / "
    "apihealth / recovery / health / marker)")

#: the bounded record-kind vocabulary (the `kind` label rides on
#: FLIGHT_RECORDS; anything else is folded to "marker").
KINDS = frozenset({"span", "audit", "event", "apihealth", "recovery",
                   "health", "marker"})


class FlightRecorder:
    """Thread-safe bounded chronological record store."""

    def __init__(self, capacity: int = 4096):
        from gpumounter_tpu_torch.obs.sinks import JsonlSink
        self._records: deque[dict] = deque(maxlen=capacity)
        self._lock = OrderedLock("flight.records")
        self._seq = itertools.count(1)
        self._jsonl = JsonlSink("flight")

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._records = deque(self._records, maxlen=max(1, capacity))

    def configure_jsonl(self, path: str) -> None:
        self._jsonl.configure(path)

    def record(self, kind: str, summary: str, node: str = "",
               trace_id: str | None = None, at: float | None = None,
               **details) -> dict:
        """Append one timeline record. trace_id defaults to the ambient
        one (records written inside a span join that trace's story);
        `at` defaults to now — sources that know their own timestamp
        (a span's start) pass it so the merge stays chronological."""
        kind = kind if kind in KINDS else "marker"
        rec = {
            "seq": next(self._seq),
            "at": round(time.time() if at is None else at, 6),
            "kind": kind,
            "node": node,
            "trace_id": trace.current_trace_id()
            if trace_id is None else trace_id,
            "summary": summary,
        }
        if details:
            rec["details"] = {k: v for k, v in details.items()}
        with self._lock:
            self._records.append(rec)
        self._jsonl.write(rec)
        FLIGHT_RECORDS.inc(kind=kind)
        return rec

    def query(self, node: str | None = None, trace_id: str | None = None,
              kind: str | None = None, since: float | None = None,
              until: float | None = None, limit: int = 500) -> list[dict]:
        """Chronological (oldest-first) filtered view; with more matches
        than `limit`, the NEWEST `limit` win — an incident review reads
        toward the present."""
        with self._lock:
            records = list(self._records)
        records.sort(key=lambda r: (r["at"], r["seq"]))
        out = []
        for rec in records:
            if node and rec.get("node") != node:
                continue
            if trace_id and rec.get("trace_id") != trace_id:
                continue
            if kind and rec.get("kind") != kind:
                continue
            if since is not None and rec["at"] < since:
                continue
            if until is not None and rec["at"] > until:
                continue
            out.append(dict(rec))
        return out[-max(1, limit):]

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._jsonl.configure("")


FLIGHT = FlightRecorder()


def query_from_params(params: dict[str, list[str]],
                      recorder: FlightRecorder | None = None) -> dict:
    """The /timeline query contract, shared by the master route, the
    worker ops port and the CLI so the surfaces cannot drift:
    last-value-wins params `node`/`trace`/`kind`/`from`/`to`/`limit`.
    Raises ValueError on non-numeric from/to/limit."""

    def _one(key: str) -> str | None:
        values = params.get(key)
        return values[-1] if values else None

    def _stamp(key: str) -> float | None:
        raw = _one(key)
        return float(raw) if raw is not None else None

    sink = recorder or FLIGHT
    return {"records": sink.query(
        node=_one("node"), trace_id=_one("trace"), kind=_one("kind"),
        since=_stamp("from"), until=_stamp("to"),
        limit=int(_one("limit") or 500))}


def configure(cfg) -> None:
    """Daemon-startup wiring (master/worker main): record capacity and
    the optional JSONL spill from config."""
    FLIGHT.set_capacity(cfg.flight_capacity)
    if cfg.flight_jsonl:
        FLIGHT.configure_jsonl(cfg.flight_jsonl)


# --- source hooks ---


class _SpanFlightExporter:
    """Root and error spans become timeline records; child ok-spans
    stay in the trace ring (the timeline is the table of contents, the
    trace is the chapter)."""

    def export(self, span: dict) -> None:
        is_root = not (span.get("parent_id") or "")
        failed = span.get("status") == "error"
        if not is_root and not failed:
            return
        name = span.get("name", "")
        duration_ms = round(float(span.get("duration_s", 0.0)) * 1000.0, 3)
        summary = f"{name} {span.get('status', '')} ({duration_ms}ms)"
        attrs = span.get("attrs") or {}
        FLIGHT.record(
            "span", summary,
            node=str(attrs.get("node", "")),
            trace_id=span.get("trace_id", ""),
            at=span.get("start"),
            span_id=span.get("span_id", ""),
            duration_ms=duration_ms,
            **({"error": span["error"]} if span.get("error") else {}))


_SPAN_EXPORTER = _SpanFlightExporter()


def _on_audit_record(rec: dict) -> None:
    pod = f"{rec.get('namespace', '')}/{rec.get('pod', '')}".strip("/")
    summary = f"{rec.get('operation', '')} -> {rec.get('outcome', '')}" \
              + (f" [{pod}]" if pod else "")
    FLIGHT.record("audit", summary, trace_id=rec.get("trace_id", ""),
                  at=rec.get("at"), operation=rec.get("operation", ""),
                  outcome=rec.get("outcome", ""), actor=rec.get("actor", ""))


def _on_apihealth(old_state: str, new_state: str) -> None:
    FLIGHT.record("apihealth", f"kube API {old_state} -> {new_state}",
                  old=old_state, new=new_state)


def install(tracer=None, apihealth=None) -> None:
    """Idempotent hook registration: the span exporter onto the tracer,
    the audit subscriber onto the global audit log, and (when given)
    the ApiHealth transition subscriber. Called from MasterApp /
    GpuMountService construction so any live daemon — and any test that
    builds one — records its timeline without extra wiring; safe to
    call repeatedly (each sink deduplicates by identity)."""
    from gpumounter_tpu_torch.obs.audit import AUDIT
    (tracer or trace.TRACER).add_exporter(_SPAN_EXPORTER)
    AUDIT.subscribe(_on_audit_record)
    if apihealth is not None:
        apihealth.subscribe(_on_apihealth)
