"""Contextvar-based distributed tracing for the hot-mount control plane.

The counterpart of ``gpumounter_tpu/obs/trace.py``, whole. Until the
worker's ops port and the fleet's assembly land, the master's /trace/<id>
serves ``trace_payload`` from this process's ring (``master/app.py``).

A trace id is minted once, at the master HTTP edge (master/app.py
stamps it on the response as the X-Tpumounter-Trace header), and flows

  HTTP route span -> rpc.<Method> client span -> [wire: trace_context
  field on the request message] -> worker.<Method> span -> mount-phase
  spans (cgroup grant, mknod, rollback, journal writes)

so one id strings together everything an operation touched on both
daemons. The wire carrier is a plain `<trace_id>-<span_id>` string in a
proto3 field legacy peers skip (rpc/api.py) — a reference worker simply
drops it, and garbage from a hostile/buggy peer parses to None (the
span then starts a fresh trace rather than failing the RPC).

Spans nest through a contextvar: `span()` makes the new span current
for its body, children parent to it automatically, and threads that
must carry a context across an explicit boundary (slice fan-out, the
migration machine's per-migration thread) capture `current()` and enter
`attached(ctx)`.

Exporters: every finished span goes to an in-memory ring buffer (the
master /trace/<id> route and the worker ops port serve it) and, when
configured, an append-only JSONL file. Open spans are tracked so the
chaos harness can assert none leak — a span closes even on an injected
CrashError because the context manager's finally always runs.

Stdlib-only (lazy-grpc policy: this is imported by the mount path).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import re
import secrets
import time
from collections import deque
from dataclasses import dataclass

from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("obs.trace")

TRACE_RING_EVICTIONS = REGISTRY.counter(
    "tpumounter_trace_ring_evictions_total",
    "Finished spans rotated out of the in-memory ring by capacity "
    "pressure — silent trace loss that an incident review would hit "
    "(raise TPUMOUNTER_TRACE_RING or add a JSONL sink when it grows)")

#: HTTP header carrying a wire context: accepted on requests at the
#: master edge (CLI/test continuity), stamped on every routed response
#: with the trace id the operation ran under.
TRACE_HEADER = "x-tpumounter-trace"
RESPONSE_HEADER = "X-Tpumounter-Trace"

_WIRE_RE = re.compile(r"^([0-9a-f]{16,32})-([0-9a-f]{8,16})$")


@dataclass(frozen=True)
class TraceContext:
    """The ambient (trace id, span id) pair a new span parents to."""

    trace_id: str
    span_id: str = ""

    def to_wire(self) -> str:
        return f"{self.trace_id}-{self.span_id or _new_span_id()}"


def new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


def parse_wire_context(raw: object) -> TraceContext | None:
    """Tolerant wire-context parse: absent (empty/None), wrong-typed,
    or malformed input — anything a legacy or buggy peer could send —
    yields None, never an exception. The caller then starts a fresh
    trace instead of failing the operation."""
    if not raw or not isinstance(raw, str):
        return None
    match = _WIRE_RE.match(raw.strip())
    if match is None:
        return None
    return TraceContext(match.group(1), match.group(2))


_current: contextvars.ContextVar[TraceContext | None] = \
    contextvars.ContextVar("tpumounter_trace", default=None)

#: when set, finished spans in this context buffer here instead of
#: exporting — see deferred().
_deferred: contextvars.ContextVar["_DeferredSpans | None"] = \
    contextvars.ContextVar("tpumounter_trace_deferred", default=None)

#: the innermost open span's mutable attribute dict — set_attrs()
#: writes through it for outcomes only known mid-span (a mount's
#: warm-pool hit/gap is decided by the allocator, inside the
#: already-open slave_pod_schedule span).
_span_attrs: contextvars.ContextVar[dict | None] = \
    contextvars.ContextVar("tpumounter_trace_attrs", default=None)


def set_attrs(**attrs) -> None:
    """Attach attributes to the innermost open span of THIS context.
    No-op when no span is open — call sites need no conditional, and a
    background thread without an attached context simply records
    nothing. Attributes land when the span closes (same export record
    as open-time attrs; later writes to the same key win)."""
    current_attrs = _span_attrs.get()
    if current_attrs is not None:
        current_attrs.update(attrs)


def current() -> TraceContext | None:
    """The ambient context (for explicit cross-thread handoff)."""
    return _current.get()


def current_trace_id() -> str:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else ""


def wire_context() -> str:
    """Serialized ambient context for the RPC wire ("" when untraced —
    proto3 omits the empty string, so an untraced call is byte-identical
    to a legacy client's)."""
    ctx = _current.get()
    return ctx.to_wire() if ctx is not None else ""


class RingBufferExporter:
    """Last-N finished spans, queryable by trace id (served by the
    master /trace/<id> route and the worker ops port)."""

    def __init__(self, capacity: int = 2048):
        self._spans: deque[dict] = deque(maxlen=capacity)
        self._lock = OrderedLock("trace.ring")

    def export(self, span: dict) -> None:
        with self._lock:
            evicting = (self._spans.maxlen is not None
                        and len(self._spans) >= self._spans.maxlen)
            self._spans.append(span)
        if evicting:
            TRACE_RING_EVICTIONS.inc()

    def spans_for(self, trace_id: str) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._spans
                    if s.get("trace_id") == trace_id]

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._spans]

    def tail(self, n: int) -> list[dict]:
        """Newest n spans, copying ONLY those n under the lock — the
        span-export path calls this every telemetry pass, and copying
        the whole ring to keep a quarter of it would contend with the
        hot mount path's exports for nothing."""
        if n <= 0:
            return []
        with self._lock:
            start = max(0, len(self._spans) - n)
            return [dict(s) for s in
                    itertools.islice(self._spans, start, None)]

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._spans = deque(self._spans, maxlen=max(1, capacity))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


class JsonlExporter:
    """Append-only JSONL sink (one span per line), on the shared
    self-disabling spill discipline (obs/sinks.py) — tracing must never
    take down a mount because a disk filled."""

    def __init__(self, path: str):
        from gpumounter_tpu_torch.obs.sinks import JsonlSink
        self.path = path
        self._lock = OrderedLock("trace.jsonl")
        self._sink = JsonlSink("trace", path)

    def export(self, span: dict) -> None:
        with self._lock:
            self._sink.write(span)


class Tracer:
    """Exporter fan-out + open-span accounting. One global instance
    (module-level `span()`/`TRACER`); tests may build private ones."""

    def __init__(self, ring_capacity: int = 2048):
        self.ring = RingBufferExporter(ring_capacity)
        self._exporters: list = [self.ring]
        self._lock = OrderedLock("trace.tracer")
        self._open: dict[str, str] = {}  # span_id -> name

    def add_exporter(self, exporter) -> None:
        """Idempotent by identity: process-global exporters (the flight
        recorder) re-install themselves after a test reset without ever
        double-exporting."""
        with self._lock:
            if not any(e is exporter for e in self._exporters):
                self._exporters.append(exporter)

    def configure_jsonl(self, path: str) -> None:
        if path:
            self.add_exporter(JsonlExporter(path))

    def export(self, span: dict) -> None:
        with self._lock:
            exporters = list(self._exporters)
        for exporter in exporters:
            try:
                exporter.export(span)
            except Exception as exc:  # noqa: BLE001 — never fail the op
                logger.error("span exporter %r failed: %s", exporter, exc)

    # --- open-span accounting (chaos invariant: none leak) ---

    def _open_add(self, span_id: str, name: str) -> None:
        with self._lock:
            self._open[span_id] = name

    def _open_remove(self, span_id: str) -> None:
        with self._lock:
            self._open.pop(span_id, None)

    def open_spans(self) -> list[str]:
        """Names of spans entered but not yet exited."""
        with self._lock:
            return sorted(self._open.values())

    def reset(self) -> None:
        """Test hook: drop buffered spans, open-span records, and any
        configured extra exporters (the ring stays)."""
        with self._lock:
            self._exporters = [self.ring]
            self._open.clear()
        self.ring.clear()


TRACER = Tracer()


def configure(cfg) -> None:
    """Daemon-startup wiring (master/worker main): ring capacity and
    the optional JSONL sink from config."""
    TRACER.ring.set_capacity(cfg.trace_ring_capacity)
    TRACER.configure_jsonl(cfg.trace_jsonl)


def trace_payload(trace_id: str, tracer: Tracer | None = None) -> dict | None:
    """The /trace/<id> response contract, shared by the master route
    and the worker ops port: buffered spans for one trace sorted by
    start time, or None when the ring holds nothing for the id."""
    spans = (tracer or TRACER).ring.spans_for(trace_id)
    if not spans:
        return None
    spans.sort(key=lambda s: s.get("start", 0.0))
    return {"trace": trace_id, "spans": spans}


@contextlib.contextmanager
def span(name: str, wire_parent: str | None = None,
         tracer: Tracer | None = None, **attrs):
    """One traced operation phase. Yields the span's TraceContext
    (children opened in the body parent to it via the contextvar).

    Parent resolution, in order:
      1. the ambient contextvar (nested span),
      2. `wire_parent` — a serialized context off the wire (HTTP header
         or rpc trace_context field); malformed/absent input is ignored,
      3. none: a fresh trace id is minted (background loops like the
         elastic reconciler start their own traces).
    """
    t = tracer or TRACER
    parent = _current.get()
    remote = parse_wire_context(wire_parent) if wire_parent else None
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    elif remote is not None:
        trace_id, parent_id = remote.trace_id, remote.span_id
    else:
        trace_id, parent_id = new_trace_id(), ""
    span_id = _new_span_id()
    ctx = TraceContext(trace_id, span_id)
    token = _current.set(ctx)
    mutable_attrs = dict(attrs)
    attrs_token = _span_attrs.set(mutable_attrs)
    t._open_add(span_id, name)
    started_at = time.time()
    t0 = time.monotonic()
    status, error = "ok", ""
    try:
        yield ctx
    except BaseException as exc:
        status, error = "error", f"{type(exc).__name__}: {exc}"
        raise
    finally:
        _current.reset(token)
        _span_attrs.reset(attrs_token)
        t._open_remove(span_id)
        record = {
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "name": name,
            "start": round(started_at, 6),
            "duration_s": round(time.monotonic() - t0, 6),
            "status": status,
        }
        if error:
            record["error"] = error
        if mutable_attrs:
            record["attrs"] = dict(mutable_attrs)
        pending = _deferred.get()
        if pending is not None:
            pending.append(record)
        else:
            t.export(record)


class _DeferredSpans:
    """Spans buffered by a deferred() block; publish() exports them."""

    def __init__(self, tracer: Tracer):
        self._tracer = tracer
        self._spans: list[dict] = []
        self._published = False

    def append(self, span: dict) -> None:
        if self._published:  # late closer after an early publish()
            self._tracer.export(span)
        else:
            self._spans.append(span)

    def publish(self) -> None:
        if self._published:
            return
        self._published = True
        for span in self._spans:
            self._tracer.export(span)
        self._spans = []


@contextlib.contextmanager
def deferred(tracer: Tracer | None = None):
    """Buffer this context's spans; the caller decides afterwards to
    publish() or drop them. For high-frequency control loops (the
    elastic resync) whose no-op passes would otherwise rotate real
    operation traces out of the ring — trace everything, keep only the
    passes that did something. Spans in OTHER threads (slice fan-out
    workers) export directly as usual; only this context buffers."""
    pending = _DeferredSpans(tracer or TRACER)
    token = _deferred.set(pending)
    try:
        yield pending
    finally:
        _deferred.reset(token)


@contextlib.contextmanager
def attached(ctx: TraceContext | None):
    """Re-attach a captured context in another thread (slice fan-out
    workers, the migration machine's thread). No-op for None, so call
    sites need no conditional."""
    if ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)
