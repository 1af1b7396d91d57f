"""CachedMasterStore: the store's API-outage degraded mode.

The counterpart of ``gpumounter_tpu/store/cache.py``; it wraps any
``MasterStore`` with the two halves of riding an outage out:

  reads    every list, scan and get that succeeds refreshes a cache; when
           the API cannot be reached (``is_outage``) the cached copy is
           answered while it is younger than API_CACHE_MAX_STALENESS_S
           (``tpumounter_store_stale_reads_total``), and past that the
           failure propagates. A NotFoundError is an answer: it evicts the
           entry. Nodes (``get_node``) and the health state are never
           cached: an evacuation must not act on a stale verdict.
  writes   an annotation stamp or a journal whose write fails
           outage-shaped, or is tried while the write plane is down, goes
           into the write-behind queue (``store/writebehind.py``;
           ``tpumounter_store_deferred_writes_total``) and its caller is
           answered; once a key has writes queued, later ones queue behind
           them, so that a flush never overwrites a newer direct write
           with an older value. Intents are never deferred: a user's
           mutation that cannot be persisted fails to its caller.

The store subscribes to ApiHealth: on the way back to healthy it flushes
the queue on a thread of its own. While the write plane is unhealthy or
writes are queued, ``_probe_loop`` writes once every
API_HEALTH_PROBE_INTERVAL_S (a flush, else a touch of a lease), so that an
idle master's plane records the successes it needs to recover.
``flush_writes`` flushes at once; ``staleness`` and ``payload`` feed
/apihealth; ``close`` unsubscribes and ends the probe.
"""

from __future__ import annotations

import copy
import socket
import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.errors import NotFoundError, is_outage
from gpumounter_tpu_torch.k8s.health import api_health
from gpumounter_tpu_torch.store.base import MasterStore
from gpumounter_tpu_torch.store.writebehind import WriteBehindQueue
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("store.cache")

STALE_READS = REGISTRY.counter(
    "tpumounter_store_stale_reads_total",
    "Store reads served from the bounded-staleness cache during an "
    "API outage, by read kind")
DEFERRED_WRITES = REGISTRY.counter(
    "tpumounter_store_deferred_writes_total",
    "Annotation writes accepted into the write-behind queue instead of "
    "failing their caller")


class CachedMasterStore(MasterStore):
    def __init__(self, inner: MasterStore, cfg=None, apihealth=None, queue=None):
        self.inner = inner
        self.cfg = cfg or Config()
        self.apihealth = apihealth or api_health()
        self.queue = queue or WriteBehindQueue(self.cfg.writebehind_dir,
                                               max_bytes=self.cfg.writebehind_max_bytes)
        self.max_staleness_s = float(self.cfg.api_cache_max_staleness_s)
        self.probe_interval_s = float(self.cfg.api_health_probe_interval_s)
        self._lock = threading.Lock()
        #: key -> (monotonic stamp, value); answers are deep copies, so a
        #: caller that mutates one cannot poison the cache
        self._cache: dict[tuple, tuple[float, object]] = {}
        self._flush_lock = threading.Lock()
        self._prober_lock = threading.Lock()
        self._prober_running = False
        self._closed = threading.Event()
        self.apihealth.subscribe(self._on_health_transition)
        # a master started in an outage, or over a queue with pending
        # writes, sees no transition: probe now
        if self.apihealth.state() != "healthy" or self.queue.pending_count():
            self._ensure_prober()

    # --- reads ---

    def _cached_read(self, key: tuple, fn, *args):
        try:
            value = fn(*args)
        except NotFoundError:
            with self._lock:
                self._cache.pop(key, None)
            raise
        except Exception as exc:  # noqa: BLE001 — the outage boundary
            if not is_outage(exc):
                raise
            with self._lock:
                entry = self._cache.get(key)
            if entry is None:
                raise
            stamp, cached = entry
            age = time.monotonic() - stamp
            if age > self.max_staleness_s:
                logger.warning("store read %s failed and cache is %.0fs old (bound %.0fs); "
                               "refusing stale data: %s", key, age, self.max_staleness_s, exc)
                raise
            STALE_READS.inc(kind=key[0])
            logger.info("store read %s served from cache (%.1fs stale; api %s)", key, age,
                        self.apihealth.state())
            return copy.deepcopy(cached)
        with self._lock:
            self._cache[key] = (time.monotonic(), copy.deepcopy(value))
        return value

    def list_worker_pods(self):
        return self._cached_read(("worker_pods",), self.inner.list_worker_pods)

    def watch_worker_pods(self, timeout_s: float = 60.0):
        # a watch is deltas: the registry's cache and backoff ride it out
        return self.inner.watch_worker_pods(timeout_s=timeout_s)

    def list_intents(self):
        return self._cached_read(("intents",), self.inner.list_intents)

    def get_intent(self, namespace: str, pod_name: str):
        return self._cached_read(("intent", namespace, pod_name), self.inner.get_intent,
                                 namespace, pod_name)

    def scan_journals(self):
        return self._cached_read(("journals",), self.inner.scan_journals)

    def list_pool_pods(self, node_name: str):
        return self._cached_read(("pool_pods", node_name), self.inner.list_pool_pods,
                                 node_name)

    def get_node(self, node_name: str):
        return self.inner.get_node(node_name)  # never cached

    # --- writes ---

    def put_intent(self, namespace, pod_name, intent):
        return self.inner.put_intent(namespace, pod_name, intent)  # never deferred

    def delete_intent(self, namespace, pod_name):
        return self.inner.delete_intent(namespace, pod_name)

    def _defer(self, namespace: str, pod_name: str, annotation: str,
               payload: str | None) -> None:
        DEFERRED_WRITES.inc()
        self.queue.enqueue(namespace, pod_name, annotation, payload)

    def _deferrable_write(self, namespace: str, pod_name: str, annotation: str,
                          payload: str | None, fn, *args) -> None:
        if self.queue.has_pending(namespace, pod_name, annotation) \
                or self.apihealth.plane_state("write") == "down":
            # behind the key's queued writes; or the write plane is down:
            # no doomed round trip (a read partition defers nothing)
            self._defer(namespace, pod_name, annotation, payload)
            return
        try:
            fn(*args)
        except NotFoundError:
            raise  # the pod is gone: a queue cannot bring it back
        except Exception as exc:  # noqa: BLE001 — the outage boundary
            if not is_outage(exc):
                raise
            logger.warning("annotation write %s on %s/%s deferred to write-behind (%s)",
                           annotation, namespace, pod_name, exc)
            self._defer(namespace, pod_name, annotation, payload)

    def stamp_annotation(self, namespace, pod_name, annotation, payload):
        self._deferrable_write(namespace, pod_name, annotation, payload,
                               self.inner.stamp_annotation, namespace, pod_name, annotation,
                               payload)

    def save_journal(self, journal: dict) -> None:
        from gpumounter_tpu_torch.migrate.journal import ANNOT_JOURNAL, dump
        src = journal["source"]
        self._deferrable_write(src["namespace"], src["pod"], ANNOT_JOURNAL, dump(journal),
                               self.inner.save_journal, journal)

    # --- the health plane: never cached, best effort ---

    def load_health_state(self):
        return self.inner.load_health_state()

    def save_health_state(self, state: dict) -> None:
        return self.inner.save_health_state(state)

    # --- the flush on recovery, and the write probe ---

    def _on_health_transition(self, old: str, new: str) -> None:
        if self._closed.is_set():
            return
        if new != "healthy":
            self._ensure_prober()
            return
        if self.queue.pending_count():
            threading.Thread(target=self.flush_writes, name="writebehind-flush",
                             daemon=True).start()

    def _ensure_prober(self) -> None:
        if self.probe_interval_s <= 0 or self._closed.is_set():
            return
        with self._prober_lock:
            if self._prober_running:
                return
            self._prober_running = True
        threading.Thread(target=self._probe_loop, name="apihealth-write-probe",
                         daemon=True).start()

    def _probe_loop(self) -> None:
        """One real write an interval while the write plane is unhealthy or
        writes are queued: a flush (its patches probe and make progress),
        else a lease touch. Their outcomes reach ApiHealth through the
        tracked client."""
        try:
            while not self._closed.wait(self.probe_interval_s):
                if self.apihealth.plane_state("write") == "healthy" \
                        and self.queue.pending_count() == 0:
                    return
                try:
                    if self.queue.pending_count():
                        self.flush_writes()
                    else:
                        self._probe_write()
                except Exception as exc:  # noqa: BLE001 — a probe's outcome
                    logger.debug("write-plane probe failed: %s", exc)
        finally:
            with self._prober_lock:
                self._prober_running = False
            # a transition raced the exit: arm again
            if self.apihealth.plane_state("write") != "healthy" or self.queue.pending_count():
                self._ensure_prober()

    PROBE_LEASE = "tpumounter-apihealth-probe"

    def _probe_write(self) -> None:
        kube = self._inner_kube()
        namespace = self.cfg.worker_namespace
        manifest = {"metadata": {"name": self.PROBE_LEASE, "namespace": namespace},
                    "spec": {"holderIdentity": socket.gethostname(), "renewTime": None}}
        try:
            kube.update_lease(namespace, self.PROBE_LEASE, manifest)
        except NotFoundError:
            kube.create_lease(namespace, manifest)

    def flush_writes(self) -> dict:
        """Replay the queue now (one flush at a time: callers coalesce).
        Returns the flush's summary."""
        with self._flush_lock:
            summary = self.queue.flush(self._inner_kube())
        if summary["applied"] or summary["pending"]:
            logger.info("write-behind flush: %s", summary)
        return summary

    def _inner_kube(self):
        kube = getattr(self.inner, "kube", None)
        if kube is None:
            raise RuntimeError("write-behind flush needs the inner store's kube client")
        return kube

    # --- for /apihealth ---

    def staleness(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {"/".join(str(p) for p in key): round(now - stamp, 3)
                    for key, (stamp, _) in sorted(self._cache.items())}

    def payload(self) -> dict:
        out = {"cacheAgesS": self.staleness(), "maxStalenessS": self.max_staleness_s,
               "writeBehind": self.queue.stats()}
        inner = self.inner.payload()
        if inner:
            out["watch"] = inner
        return out

    def close(self) -> None:
        """Leave ApiHealth, end the probe, close the inner store and the
        queue: the process-wide machine outlives a master's store."""
        self._closed.set()
        self.apihealth.unsubscribe(self._on_health_transition)
        self.inner.close()
        self.queue.close()
