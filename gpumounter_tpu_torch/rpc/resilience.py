"""The master's worker calls, made resilient: typed errors, bounded retry,
a circuit breaker.

The counterpart of ``gpumounter_tpu/rpc/resilience.py:44-235``. The
original master dials each worker with one long timeout and no memory of
failures, so one wedged node makes every request routed to it hang in turn.
Here every call gets

  * a deadline of its method's (config);
  * a bounded, capped-exponential retry on the transport's UNAVAILABLE and
    DEADLINE_EXCEEDED (safe for AddGPU and RemoveGPU: they carry an
    idempotency key the worker remembers);
  * a circuit breaker a worker: after `failure_threshold` transport
    failures in a row calls fail fast with BreakerOpenError, which the
    master's routes answer 503 with Retry-After; after `reset_s` one
    half-open probe goes through, and its outcome closes or re-opens it.

The breaker's state and trips, and the retries, are series of the
registry (``utils/metrics.py``). A mutation the worker refuses as fenced (a
stale epoch) raises ``FencedError``, which is never retried. Stdlib only.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("rpc.resilience")

BREAKER_OPEN = REGISTRY.gauge(
    "tpumounter_worker_breaker_open",
    "1 while the named worker's circuit breaker is open (degraded)")
BREAKER_TRIPS = REGISTRY.counter(
    "tpumounter_worker_breaker_trips_total",
    "Circuit-breaker open transitions by worker")
RPC_RETRIES = REGISTRY.counter(
    "tpumounter_rpc_retries_total",
    "Worker RPC attempts retried after a retriable transport failure")


class RpcCallError(RuntimeError):
    """A failed master -> worker call. `code` is the gRPC status name
    ("DEADLINE_EXCEEDED", "UNAVAILABLE", ...) or "BREAKER_OPEN"."""

    def __init__(self, message: str, code: str = "UNKNOWN", address: str = "",
                 method: str = ""):
        super().__init__(message)
        self.code = code
        self.address = address
        self.method = method


class DeadlineExceededError(RpcCallError):
    """The call's deadline elapsed (DEADLINE_EXCEEDED)."""

    def __init__(self, message: str, address: str = "", method: str = ""):
        super().__init__(message, "DEADLINE_EXCEEDED", address, method)


class WorkerUnavailableError(RpcCallError):
    """The transport failed: connection refused or dropped (UNAVAILABLE)."""

    def __init__(self, message: str, address: str = "", method: str = ""):
        super().__init__(message, "UNAVAILABLE", address, method)


class BreakerOpenError(RpcCallError):
    """The worker's breaker is open: fail fast, retry after `retry_after_s`."""

    def __init__(self, message: str, retry_after_s: float, address: str = "",
                 method: str = ""):
        super().__init__(message, "BREAKER_OPEN", address, method)
        self.retry_after_s = retry_after_s


class FencedError(RpcCallError):
    """The worker refused a stale-epoch write (epoch fencing): another
    master has taken over the node since this epoch was read. Never retried:
    the answer is fresh routing, not the stale write again."""

    def __init__(self, message: str, address: str = "", method: str = ""):
        super().__init__(message, "FENCED", address, method)


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff between bounded attempts. `max_attempts`
    counts the first try, so a call takes at most max_attempts deadlines
    plus the delays."""

    max_attempts: int = 3
    base_s: float = 0.1
    factor: float = 2.0
    cap_s: float = 2.0

    def delay_for(self, attempt: int) -> float:
        """Sleep before retry number `attempt` (1-based)."""
        if attempt <= 0:
            return 0.0
        return min(self.base_s * self.factor ** (attempt - 1), self.cap_s)


class CircuitBreaker:
    """Consecutive-failure breaker a key (a worker's address).

    closed -> open after `failure_threshold` transport failures in a row ->
    half-open after `reset_s` (one probe call let through) -> closed when the
    probe succeeds, open again when it fails."""

    def __init__(self, failure_threshold: int = 5, reset_s: float = 30.0):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_s = reset_s
        self._lock = threading.Lock()
        #: key -> [consecutive_failures, opened_at or None, probe_in_flight]
        self._entries: dict[str, list] = {}
        #: called outside the lock with the key on every transition to
        #: open; the registry drops the worker's pooled channel there, so a
        #: recovered worker gets a fresh dial.
        self.on_open = None

    # --- views (no side effect) ---

    def state(self, key: str) -> str:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[1] is None:
                return "closed"
            if time.monotonic() - entry[1] >= self.reset_s:
                return "half-open"
            return "open"

    def retry_after(self, key: str) -> float | None:
        """Seconds until a call is worth making, None when calls may go. A
        pure read: it does not take the half-open probe's slot."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[1] is None:
                return None
            remaining = self.reset_s - (time.monotonic() - entry[1])
            return remaining if remaining > 0 else None

    def prune(self, active_keys) -> None:
        """Drop the state of workers that are gone; an open breaker's gauge
        goes back to 0 with it."""
        active = set(active_keys)
        with self._lock:
            removed = [(k, self._entries.pop(k)) for k in list(self._entries)
                       if k not in active]
        for key, entry in removed:
            if entry[1] is not None:
                BREAKER_OPEN.set(0.0, worker=key)

    # --- the dialing contract ---

    def allow(self, key: str) -> float | None:
        """None: go ahead (in half-open this call takes the probe's slot);
        a float: open, retry after that many seconds."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[1] is None:
                return None
            elapsed = time.monotonic() - entry[1]
            if elapsed < self.reset_s:
                return self.reset_s - elapsed
            if entry[2]:  # half-open, the probe is out
                return 1.0
            entry[2] = True
            return None

    def record_success(self, key: str) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
        if entry is not None and entry[1] is not None:
            logger.info("circuit breaker for %s closed (probe ok)", key)
            BREAKER_OPEN.set(0.0, worker=key)

    def record_failure(self, key: str) -> None:
        tripped = reopened = False
        with self._lock:
            entry = self._entries.setdefault(key, [0, None, False])
            entry[0] += 1
            if entry[1] is not None:
                # open or half-open: a failure (the probe's, or a racer's)
                # re-opens and restarts the clock
                reopened = entry[2]
                entry[1] = time.monotonic()
                entry[2] = False
            elif entry[0] >= self.failure_threshold:
                entry[1] = time.monotonic()
                entry[2] = False
                tripped = True
        if tripped:
            logger.error("circuit breaker for %s OPEN after %d consecutive failures; "
                         "failing fast for %.0f s", key, self.failure_threshold, self.reset_s)
            BREAKER_TRIPS.inc(worker=key)
            BREAKER_OPEN.set(1.0, worker=key)
        if (tripped or reopened) and self.on_open is not None:
            self.on_open(key)
