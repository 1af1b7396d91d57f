"""ApiHealth: one state machine a Kubernetes API endpoint, fed by every call.

The counterpart of ``gpumounter_tpu/k8s/health.py``. Every call's outcome
is sorted by ``k8s/errors.py``'s ``is_outage`` and counted on its plane,
read or write (a partition is often one-way: writes black-holed while reads
flow through a stale balancer, or the other way round), and the verdict is
the worse plane's:

    healthy    calls succeed, or fail with a 4xx (an answer)
    degraded   API_HEALTH_DEGRADED_FAILURES outage-shaped failures in a row
    down       the streak has lasted API_HEALTH_DOWN_AFTER_S; the store
               then queues annotation writes without a doomed round trip

A plane recovers after API_HEALTH_RECOVERY_SUCCESSES successes in a row,
not one, so that a lucky call in an outage cannot flap the fleet. The clock
is injectable. Subscribers get (old, new) on every change of the verdict,
called outside the lock.

``api_health(endpoint, cfg)`` is the process's machine for an endpoint (a
process talks to one API server, so the master's routes, the store and the
worker share it); ``reset_all()`` drops them (tests).
``HealthTrackingKubeClient`` wraps a client and feeds the machine from each
call, on its plane; ``wrap_health`` wraps once. The series:
``tpumounter_api_health_state`` (0 healthy, 1 degraded, 2 down),
``tpumounter_api_health_transitions_total`` and
``tpumounter_api_call_failures_total`` by error class.
"""

from __future__ import annotations

import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.k8s.errors import classify_exception, is_outage
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("k8s.health")

HEALTHY, DEGRADED, DOWN = "healthy", "degraded", "down"
_LEVEL = {HEALTHY: 0, DEGRADED: 1, DOWN: 2}

API_HEALTH_STATE = REGISTRY.gauge(
    "tpumounter_api_health_state",
    "Kubernetes API health verdict per endpoint "
    "(0=healthy, 1=degraded, 2=down)")
API_HEALTH_TRANSITIONS = REGISTRY.counter(
    "tpumounter_api_health_transitions_total",
    "ApiHealth state transitions by endpoint and new state")
API_CALL_FAILURES = REGISTRY.counter(
    "tpumounter_api_call_failures_total",
    "Outage-shaped Kubernetes API call failures by error class")


class _PlaneState:
    """One plane's streaks: it judges itself, so that the other plane's
    successes cannot mask it."""

    __slots__ = ("state", "failures", "successes", "first_failure_at", "last_error")

    def __init__(self):
        self.state = HEALTHY
        self.failures = 0
        self.successes = 0
        self.first_failure_at: float | None = None
        self.last_error = ""


class ApiHealth:
    """One endpoint's machine. Thread-safe; `now` is the clock."""

    PLANES = ("read", "write")

    def __init__(self, cfg=None, endpoint: str = "kube", now=None):
        cfg = cfg or Config()
        self.endpoint = endpoint
        self.degraded_failures = max(1, int(cfg.api_health_degraded_failures))
        self.down_after_s = float(cfg.api_health_down_after_s)
        self.recovery_successes = max(1, int(cfg.api_health_recovery_successes))
        self._now = now or time.monotonic
        self._lock = threading.Lock()
        self._planes = {plane: _PlaneState() for plane in self.PLANES}
        self._state = HEALTHY  # the worse plane's
        self._since = self._now()
        self._transitions = 0
        self._subscribers: list = []
        API_HEALTH_STATE.set(0.0, endpoint=endpoint)

    # --- observation ---

    def record_success(self, kind: str = "read") -> None:
        self._record(True, None, kind)

    def record_failure(self, exc: Exception, kind: str = "read") -> None:
        """An outage-shaped failure (a 4xx is recorded as a success)."""
        self._record(False, exc, kind)

    def observe(self, exc: Exception | None, kind: str = "read") -> None:
        """One call's outcome on `kind`'s plane: None or a 4xx counts for
        it, an outage-shaped failure against it."""
        if exc is None or not is_outage(exc):
            self._record(True, None, kind)
        else:
            self._record(False, exc, kind)

    def _record(self, ok: bool, exc: Exception | None, kind: str) -> None:
        now = self._now()
        transition: tuple[str, str] | None = None
        with self._lock:
            plane = self._planes.get(kind) or self._planes["read"]
            if ok:
                plane.successes += 1
                plane.failures = 0
                plane.first_failure_at = None
                if plane.state != HEALTHY and plane.successes >= self.recovery_successes:
                    plane.state = HEALTHY
            else:
                typed = classify_exception(exc)
                plane.last_error = f"{type(typed).__name__}: {typed.message or typed}"
                API_CALL_FAILURES.inc(kind=type(typed).__name__)
                plane.successes = 0
                plane.failures += 1
                if plane.first_failure_at is None:
                    plane.first_failure_at = now
                if plane.failures >= self.degraded_failures:
                    if now - plane.first_failure_at >= self.down_after_s:
                        plane.state = DOWN
                    elif plane.state == HEALTHY:
                        plane.state = DEGRADED
            old = self._state
            worst = max((p.state for p in self._planes.values()), key=_LEVEL.get)
            if worst != old:
                self._state = worst
                self._since = now
                self._transitions += 1
                transition = (old, worst)
                API_HEALTH_STATE.set(float(_LEVEL[worst]), endpoint=self.endpoint)
                API_HEALTH_TRANSITIONS.inc(endpoint=self.endpoint, state=worst)
            subscribers = list(self._subscribers) if transition else []
            last_error = self._last_error_locked()
        if transition:
            old_state, new_state = transition
            log = logger.warning if new_state != HEALTHY else logger.info
            log("api endpoint %r %s -> %s (%s)", self.endpoint, old_state, new_state,
                last_error if new_state != HEALTHY else "recovered")
            for fn in subscribers:
                try:
                    fn(old_state, new_state)
                except Exception:  # noqa: BLE001 — advisory hooks
                    logger.exception("api-health subscriber failed")

    def _last_error_locked(self) -> str:
        for plane in self._planes.values():
            if plane.state != HEALTHY and plane.last_error:
                return plane.last_error
        for plane in self._planes.values():
            if plane.last_error:
                return plane.last_error
        return ""

    # --- verdicts ---

    def state(self) -> str:
        with self._lock:
            return self._state

    def plane_state(self, kind: str) -> str:
        with self._lock:
            plane = self._planes.get(kind)
            return plane.state if plane is not None else HEALTHY

    def ok(self) -> bool:
        """Every plane healthy: the gate of destructive work."""
        with self._lock:
            return self._state == HEALTHY

    def is_down(self) -> bool:
        with self._lock:
            return self._state == DOWN

    def write_plane_ok(self) -> bool:
        """Do writes still land? (A read partition leaves them deliverable.)"""
        with self._lock:
            return self._planes["write"].state == HEALTHY

    def subscribe(self, fn) -> None:
        """fn(old, new) on every change of the verdict, outside the lock;
        idempotent by identity."""
        with self._lock:
            if not any(s is fn for s in self._subscribers):
                self._subscribers.append(fn)

    def unsubscribe(self, fn) -> None:
        """Drop fn (a bound method matches the same object's method): an
        owner that closes leaves the process-wide machine no callback."""
        with self._lock:
            self._subscribers = [s for s in self._subscribers if s != fn]

    def payload(self) -> dict:
        with self._lock:
            return {
                "endpoint": self.endpoint,
                "state": self._state,
                "sinceS": round(self._now() - self._since, 3),
                "consecutiveFailures": max(p.failures for p in self._planes.values()),
                "transitions": self._transitions,
                "lastError": self._last_error_locked(),
                "planes": {
                    kind: {
                        "state": plane.state,
                        "consecutiveFailures": plane.failures,
                        "consecutiveSuccesses": plane.successes,
                        "lastError": plane.last_error,
                    } for kind, plane in self._planes.items()},
                "config": {
                    "degradedFailures": self.degraded_failures,
                    "downAfterS": self.down_after_s,
                    "recoverySuccesses": self.recovery_successes,
                },
            }

    def reset(self) -> None:
        """Back to a new healthy machine, without subscribers."""
        with self._lock:
            self._planes = {plane: _PlaneState() for plane in self.PLANES}
            self._state = HEALTHY
            self._since = self._now()
            self._transitions = 0
            self._subscribers = []
            API_HEALTH_STATE.set(0.0, endpoint=self.endpoint)


_registry_lock = threading.Lock()
_instances: dict[str, ApiHealth] = {}


def api_health(endpoint: str = "kube", cfg=None) -> ApiHealth:
    """The process's machine for `endpoint`, made from `cfg` at the first
    call."""
    with _registry_lock:
        instance = _instances.get(endpoint)
        if instance is None:
            instance = _instances[endpoint] = ApiHealth(cfg=cfg, endpoint=endpoint)
        return instance


def reset_all() -> None:
    """Reset and drop every endpoint's machine, so that one test's outage
    leaves no verdict to the next."""
    with _registry_lock:
        for instance in _instances.values():
            instance.reset()
        _instances.clear()


class HealthTrackingKubeClient(KubeClient):
    """A KubeClient that feeds each call's outcome to an ApiHealth, on the
    call's plane. A NotImplementedError is a gap of the client, not an
    outcome. Other attributes (the fake's helpers) pass through untracked."""

    def __init__(self, inner: KubeClient, health: ApiHealth | None = None):
        self.inner = inner
        self.health = health or api_health()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _call(self, kind: str, name: str, *args, **kwargs):
        try:
            out = getattr(self.inner, name)(*args, **kwargs)
        except NotImplementedError:
            raise
        except Exception as exc:  # noqa: BLE001 — the classification boundary
            self.health.observe(exc, kind)
            raise
        self.health.observe(None, kind)
        return out

    def get_pod(self, namespace, name):
        return self._call("read", "get_pod", namespace, name)

    def create_pod(self, namespace, manifest):
        return self._call("write", "create_pod", namespace, manifest)

    def delete_pod(self, namespace, name, grace_period_seconds=0):
        return self._call("write", "delete_pod", namespace, name,
                          grace_period_seconds=grace_period_seconds)

    def list_pods(self, namespace=None, label_selector="", field_selector=""):
        return self._call("read", "list_pods", namespace, label_selector=label_selector,
                          field_selector=field_selector)

    def list_pods_with_rv(self, namespace=None, label_selector="", field_selector=""):
        return self._call("read", "list_pods_with_rv", namespace,
                          label_selector=label_selector, field_selector=field_selector)

    def patch_pod(self, namespace, name, patch):
        return self._call("write", "patch_pod", namespace, name, patch)

    def watch_pods(self, namespace, *, label_selector="", field_selector="", timeout_s=60.0,
                   resource_version=""):
        # the open is tracked (the call an outage fails); the stream is the
        # caller's
        return self._call("read", "watch_pods", namespace, label_selector=label_selector,
                          field_selector=field_selector, timeout_s=timeout_s,
                          resource_version=resource_version)

    def create_event(self, namespace, manifest):
        return self._call("write", "create_event", namespace, manifest)

    def get_lease(self, namespace, name):
        return self._call("read", "get_lease", namespace, name)

    def create_lease(self, namespace, manifest):
        return self._call("write", "create_lease", namespace, manifest)

    def update_lease(self, namespace, name, manifest):
        return self._call("write", "update_lease", namespace, name, manifest)

    def get_node(self, name):
        return self._call("read", "get_node", name)

    def list_nodes(self):
        return self._call("read", "list_nodes")


def wrap_health(kube: KubeClient, health: ApiHealth | None = None) -> KubeClient:
    """`kube` tracked by `health` (the process's machine by default); a
    client that is tracked already is returned as it is."""
    if isinstance(kube, HealthTrackingKubeClient):
        return kube
    return HealthTrackingKubeClient(kube, health)
