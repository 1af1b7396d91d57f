"""The master's gRPC client of the worker, and its pool of channels.

The counterpart of ``gpumounter_tpu/rpc/client.py:62-210, 234-520``. The
original master dials ``workerIP:1200`` insecure for each request and calls
AddGPU / RemoveGPU (``cmd/GPUMounter-master/main.go:82-96, 185-199``). This
client speaks the original's service names, and adds (``rpc/resilience.py``):

  * a deadline a method from config (RPC_ADD_TIMEOUT_S, RPC_REMOVE_TIMEOUT_S,
    RPC_TELEMETRY_TIMEOUT_S, RPC_PROBE_TIMEOUT_S, RPC_QUIESCE_TIMEOUT_S);
  * bounded capped-exponential retries on UNAVAILABLE and
    DEADLINE_EXCEEDED, each mutation carrying one idempotency key across its
    attempts, so a retry whose first attempt landed is answered from the
    worker's record and mounts nothing twice (a worker built from the
    original proto skips the key);
  * the breaker it is given, told of every transport outcome;
  * typed errors: DeadlineExceededError, WorkerUnavailableError,
    BreakerOpenError, FencedError (FAILED_PRECONDITION whose detail starts
    "FENCED": the call's epoch, field 8, is stale; never retried), and
    RpcCallError with the status name for a call the worker refused
    (FAILED_PRECONDITION, INVALID_ARGUMENT, INTERNAL, UNAUTHENTICATED);
  * one ``rpc.<Method>`` span a call, stamped on the request as its
    ``trace_context`` (field 7), so that the worker's span is its child;
  * the failpoint sites ``rpc.client.deadline`` (a value: the deadline) and
    ``rpc.client.call`` (before each attempt); an injected drop
    (``InjectedUnavailable``) is retried as UNAVAILABLE is, under the same
    idempotency key.

``collect_telemetry`` is the fleet collector's pull (``obs/fleet.py``) and
the recovery controller's liveness probe; ``probe_gpu`` the health plane's
canary read and the reconciler's (RPC_PROBE_TIMEOUT_S); ``quiesce_status``
the migration machine's poll of the tenant's ack (RPC_QUIESCE_TIMEOUT_S).
Every method takes a ``timeout_s`` that overrides its method's deadline for
the call. The pool's hits, misses,
evictions and size are series of the registry (``utils/metrics.py``). grpc
is imported when a channel is built; without grpcio that raises
ModuleNotFoundError naming grpcio, and nothing falls back.
"""

from __future__ import annotations

import secrets
import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.rpc.resilience import (
    RPC_RETRIES,
    BreakerOpenError,
    CircuitBreaker,
    DeadlineExceededError,
    FencedError,
    RetryPolicy,
    RpcCallError,
    WorkerUnavailableError,
)
from gpumounter_tpu_torch.utils.auth import resolve_token
from gpumounter_tpu_torch.utils.lazy_grpc import grpc
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("rpc.client")

CHANNEL_POOL_HITS = REGISTRY.counter(
    "tpumounter_channel_pool_hits_total",
    "Worker RPCs served over an already-established pooled channel")
CHANNEL_POOL_MISSES = REGISTRY.counter(
    "tpumounter_channel_pool_misses_total",
    "Pool lookups that had to dial a fresh channel")
CHANNEL_POOL_EVICTIONS = REGISTRY.counter(
    "tpumounter_channel_pool_evictions_total",
    "Pooled channels closed, by reason (idle / invalidated / pruned / "
    "shutdown)")
CHANNEL_POOL_SIZE = REGISTRY.gauge(
    "tpumounter_channel_pool_size",
    "Live channels currently held by the pool")

#: transport codes worth another bounded attempt
_RETRIABLE = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED"})


class ChannelPool:
    """Cached gRPC channels, one an address, with keepalive and idle
    eviction: the dial is paid once a worker, not once a request. A
    ``WorkerClient`` built with ``channel_pool=`` borrows the address's
    channel, and its close() only gives it back.

      * ``invalidate(address)``: the breaker opened, or the worker's
        address changed: the channel must serve no further call;
      * ``retain(active)``: close the channels of workers that are gone;
      * an idle channel with no borrower closes after CHANNEL_IDLE_EVICT_S.

    The books are exact, ``dialed == live + closed`` at every moment, so
    the chaos harness can hold the pool to no leaked channel (invariant 7)."""

    def __init__(self, cfg=None):
        cfg = cfg or Config()
        self.idle_evict_s = cfg.channel_idle_evict_s
        self.keepalive_time_s = cfg.channel_keepalive_time_s
        self._lock = threading.Lock()
        #: address -> [channel, last_used_monotonic, borrowers]
        self._channels: dict[str, list] = {}
        self._dialed = 0
        self._closed = 0
        self._shutdown = False

    def channel(self, address: str):
        now = time.monotonic()
        to_close = []
        try:
            with self._lock:
                if self._shutdown:
                    raise RuntimeError("channel pool is shut down")
                to_close = self._sweep_locked(now)
                entry = self._channels.get(address)
                if entry is not None:
                    entry[1] = now
                    entry[2] += 1
                    CHANNEL_POOL_HITS.inc()
                    return entry[0]
                ch = grpc.insecure_channel(address, options=(
                    ("grpc.keepalive_time_ms", int(self.keepalive_time_s * 1000)),
                    ("grpc.keepalive_timeout_ms", 5000),
                    ("grpc.keepalive_permit_without_calls", 1),
                ))
                self._channels[address] = [ch, now, 1]
                self._dialed += 1
                CHANNEL_POOL_MISSES.inc()
                CHANNEL_POOL_SIZE.set(float(len(self._channels)))
                return ch
        finally:
            self._close_channels(to_close, "idle")

    def release(self, address: str) -> None:
        """A borrower is done: the channel stays, its idle clock restarts."""
        with self._lock:
            entry = self._channels.get(address)
            if entry is not None:
                entry[1] = time.monotonic()
                entry[2] = max(0, entry[2] - 1)

    def _sweep_locked(self, now: float) -> list:
        """Idle channels with no borrower, taken out under the lock and
        returned to be closed outside it."""
        if self.idle_evict_s <= 0:
            return []
        stale = [addr for addr, (_, used, refs) in self._channels.items()
                 if refs <= 0 and now - used > self.idle_evict_s]
        out = [self._channels.pop(addr)[0] for addr in stale]
        if out:
            self._closed += len(out)
            CHANNEL_POOL_SIZE.set(float(len(self._channels)))
        return out

    @staticmethod
    def _close_channels(channels: list, reason: str) -> None:
        """Close channels already taken out of the pool, each an eviction
        of `reason`."""
        for ch in channels:
            ch.close()
            CHANNEL_POOL_EVICTIONS.inc(reason=reason)

    def invalidate(self, address: str, reason: str = "invalidated") -> None:
        """Drop an address even while borrowed: its transport is dead or
        wrong, and a call on it is failing anyway."""
        with self._lock:
            entry = self._channels.pop(address, None)
            if entry is not None:
                self._closed += 1
            CHANNEL_POOL_SIZE.set(float(len(self._channels)))
        if entry is not None:
            logger.info("channel to %s dropped (%s)", address, reason)
            self._close_channels([entry[0]], reason)

    def retain(self, active_addresses) -> None:
        """Close every channel whose address is not in the active set."""
        active = set(active_addresses)
        with self._lock:
            stale = [a for a in self._channels if a not in active]
            out = [self._channels.pop(a)[0] for a in stale]
            self._closed += len(out)
            CHANNEL_POOL_SIZE.set(float(len(self._channels)))
        self._close_channels(out, "pruned")

    def close_all(self) -> None:
        with self._lock:
            out = [entry[0] for entry in self._channels.values()]
            self._closed += len(out)
            self._channels.clear()
            self._shutdown = True
            CHANNEL_POOL_SIZE.set(0.0)
        self._close_channels(out, "shutdown")

    def stats(self) -> dict:
        """The books: live channels, dialed and closed since the start."""
        with self._lock:
            return {"live": len(self._channels), "dialed": self._dialed,
                    "closed": self._closed}


_TOKEN_FROM_CONFIG = object()


def _code_name(exc: Exception) -> str:
    if isinstance(exc, failpoints.InjectedUnavailable):
        return "UNAVAILABLE"
    code = getattr(exc, "code", None)
    if callable(code):
        return getattr(code(), "name", "") or "UNKNOWN"
    return "UNKNOWN"


def _details(exc: Exception) -> str:
    details = getattr(exc, "details", None)
    return str(details() or "") if callable(details) else str(exc)


class WorkerClient:
    def __init__(self, address: str, token=_TOKEN_FROM_CONFIG, cfg=None,
                 breaker: CircuitBreaker | None = None,
                 channel_pool: ChannelPool | None = None, breaker_key: str | None = None):
        """token: the worker's bearer secret; by default TPUMOUNTER_AUTH_TOKEN
        (or its file) from `cfg`; None sends none. breaker: a shared breaker
        (the registry's), told of each outcome under `breaker_key` (by
        default the address: the registry's address of the worker, where a
        test dials it elsewhere).
        channel_pool: borrow the address's pooled channel; else the client
        dials and owns one."""
        cfg = cfg or Config()
        if token is _TOKEN_FROM_CONFIG:
            token = resolve_token(cfg)
        self._metadata = (("authorization", f"Bearer {token}"),) if token else None
        self.address = address
        self.timeouts = {api.ADD_METHOD: cfg.rpc_add_timeout_s,
                         api.REMOVE_METHOD: cfg.rpc_remove_timeout_s,
                         api.TELEMETRY_METHOD: cfg.rpc_telemetry_timeout_s,
                         api.PROBE_METHOD: cfg.rpc_probe_timeout_s,
                         api.QUIESCE_METHOD: cfg.rpc_quiesce_timeout_s}
        self.retry = RetryPolicy(max_attempts=cfg.rpc_max_attempts,
                                 base_s=cfg.rpc_retry_base_s, cap_s=cfg.rpc_retry_cap_s)
        self.breaker = breaker
        self.breaker_key = breaker_key or address
        self._pool = channel_pool
        if channel_pool is not None:
            self._channel = channel_pool.channel(address)
        else:
            self._channel = grpc.insecure_channel(address)
        self._stubs = {
            api.ADD_METHOD: self._channel.unary_unary(
                f"/{api.ADD_SERVICE}/{api.ADD_METHOD}",
                request_serializer=lambda m: m.encode(),
                response_deserializer=api.AddGPUResponse.decode),
            api.REMOVE_METHOD: self._channel.unary_unary(
                f"/{api.REMOVE_SERVICE}/{api.REMOVE_METHOD}",
                request_serializer=lambda m: m.encode(),
                response_deserializer=api.RemoveGPUResponse.decode),
            # a worker without the service answers UNIMPLEMENTED, and the
            # fleet collector scrapes its /metrics instead (obs/fleet.py)
            api.TELEMETRY_METHOD: self._channel.unary_unary(
                f"/{api.TELEMETRY_SERVICE}/{api.TELEMETRY_METHOD}",
                request_serializer=lambda m: m.encode(),
                response_deserializer=api.CollectTelemetryResponse.decode),
            api.PROBE_METHOD: self._channel.unary_unary(
                f"/{api.PROBE_SERVICE}/{api.PROBE_METHOD}",
                request_serializer=lambda m: m.encode(),
                response_deserializer=api.ProbeGPUResponse.decode),
            api.QUIESCE_METHOD: self._channel.unary_unary(
                f"/{api.QUIESCE_SERVICE}/{api.QUIESCE_METHOD}",
                request_serializer=lambda m: m.encode(),
                response_deserializer=api.QuiesceStatusResponse.decode),
        }

    def close(self) -> None:
        channel, self._channel = self._channel, None
        if channel is None:
            return
        if self._pool is not None:
            self._pool.release(self.address)
        else:
            channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --- the call, with its deadline, retries and breaker ---

    def _call(self, method: str, request, timeout_s: float | None = None):
        if self._channel is None:
            raise RuntimeError(f"WorkerClient for {self.address} is closed")
        with trace.span(f"rpc.{method}", address=self.address):
            # the span just opened goes on the wire: the worker's span is
            # its child, not the caller's
            request.trace_context = trace.wire_context()
            return self._call_attempts(method, request, timeout_s)

    def _call_attempts(self, method: str, request, timeout_s: float | None = None):
        deadline = float(failpoints.value(
            "rpc.client.deadline", self.timeouts[method] if timeout_s is None else timeout_s,
            method=method))
        last_exc: Exception | None = None
        for attempt in range(1, self.retry.max_attempts + 1):
            if self.breaker is not None:
                retry_after = self.breaker.allow(self.breaker_key)
                if retry_after is not None:
                    raise BreakerOpenError(
                        f"worker {self.address} degraded (circuit open); retry in "
                        f"{retry_after:.1f}s", retry_after, self.address, method) from last_exc
            try:
                failpoints.fire("rpc.client.call", method=method, address=self.address)
                response = self._stubs[method](request, timeout=deadline,
                                               metadata=self._metadata)
            except (grpc.RpcError, failpoints.InjectedUnavailable) as exc:
                code = _code_name(exc)
                transport = code in _RETRIABLE
                if self.breaker is not None:
                    # only the transport's failures count against the
                    # worker: a refusal proves it alive and answering
                    if transport:
                        self.breaker.record_failure(self.breaker_key)
                    else:
                        self.breaker.record_success(self.breaker_key)
                if not transport or attempt >= self.retry.max_attempts:
                    raise self._typed(exc, code, method) from exc
                last_exc = exc
                delay = self.retry.delay_for(attempt)
                RPC_RETRIES.inc(method=method)
                logger.warning("%s to %s failed (%s, attempt %d/%d); retrying in %.2fs",
                               method, self.address, code, attempt,
                               self.retry.max_attempts, delay)
                time.sleep(delay)
            else:
                if self.breaker is not None:
                    self.breaker.record_success(self.breaker_key)
                return response
        raise AssertionError("unreachable")

    def _typed(self, exc: Exception, code: str, method: str) -> RpcCallError:
        if code == "DEADLINE_EXCEEDED":
            return DeadlineExceededError(f"{method} to {self.address} exceeded its deadline",
                                         self.address, method)
        if code == "UNAVAILABLE":
            return WorkerUnavailableError(
                f"{method} to {self.address}: worker unavailable ({_details(exc)})",
                self.address, method)
        if code == "FAILED_PRECONDITION" and _details(exc).startswith("FENCED"):
            # typed, so that a caller tells a stale shard view from a refusal
            # like CanMount's
            return FencedError(f"{method} to {self.address}: {_details(exc)}", self.address,
                               method)
        return RpcCallError(_details(exc), code, self.address, method)

    # --- methods ---

    def add_gpu(self, pod_name: str, namespace: str, gpu_num: int,
                is_entire_mount: bool = False,
                idempotency_key: str | None = None, epoch: int = 0,
                timeout_s: float | None = None) -> api.AddGPUResponse:
        """AddGPU; the response's add_gpu_result and the UUIDs mounted. One
        idempotency key covers every attempt. epoch: the caller's fencing
        epoch of the node (0: unfenced); a stale one raises FencedError."""
        request = api.AddGPURequest(
            pod_name, namespace, gpu_num, is_entire_mount,
            idempotency_key=idempotency_key or f"add-{secrets.token_hex(8)}", epoch=int(epoch))
        return self._call(api.ADD_METHOD, request, timeout_s)

    def remove_gpu(self, pod_name: str, namespace: str, uuids: list[str],
                   force: bool = False, remove_all: bool = False,
                   idempotency_key: str | None = None, epoch: int = 0,
                   timeout_s: float | None = None) -> api.RemoveGPUResponse:
        """RemoveGPU; remove_all (field 5) removes every GPU the pod's slave
        pods hold, whatever the mount type (the slice's remove). One
        idempotency key covers every attempt. epoch: as add_gpu's."""
        request = api.RemoveGPURequest(
            pod_name, namespace, list(uuids), force, remove_all=remove_all,
            idempotency_key=idempotency_key or f"rm-{secrets.token_hex(8)}", epoch=int(epoch))
        return self._call(api.REMOVE_METHOD, request, timeout_s)

    def collect_telemetry(self, quarantined: bool = False,
                          timeout_s: float | None = None) -> api.CollectTelemetryResponse:
        """The worker's telemetry snapshot (the raw response: its JSON in
        `telemetry` parses with ``obs.fleet.parse_telemetry``). A read,
        retried like one. `quarantined` carries the master's verdict on the
        node: the worker drains its warm pool while it is set. Its
        ``rpc.CollectTelemetry`` span has no worker half in the assembly."""
        return self._call(api.TELEMETRY_METHOD,
                          api.CollectTelemetryRequest(quarantined=bool(quarantined)), timeout_s)

    def probe_gpu(self, pod_name: str, namespace: str, timeout_s: float | None = None
                  ) -> tuple[api.ProbeGPUResult, list[api.ChipHealth]]:
        """ProbeGPU: (the result, the health of every GPU the pod holds). A
        read, retried like one."""
        response = self._call(api.PROBE_METHOD, api.ProbeGPURequest(pod_name, namespace),
                              timeout_s)
        return api.ProbeGPUResult(response.probe_gpu_result), list(response.chips)

    def quiesce_status(self, pod_name: str, namespace: str, timeout_s: float | None = None
                       ) -> tuple[api.QuiesceStatusResult, api.QuiesceStatusResponse]:
        """QuiesceStatus: (the result, the response: the tenant's acked
        migration id and phase, the holders of its GPUs, their count). A
        read, retried like one."""
        response = self._call(api.QUIESCE_METHOD, api.QuiesceStatusRequest(pod_name, namespace),
                              timeout_s)
        return api.QuiesceStatusResult(response.quiesce_status_result), response
