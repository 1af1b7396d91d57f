"""WatchMasterStore: the master's state from indexes a watch keeps.

The counterpart of ``gpumounter_tpu/store/watch.py``. The list-backed store
(``store/k8s.py``) LISTs the whole pod population at every intent list or
journal scan; this one speaks the informer protocol:

  LIST once, with the collection's resourceVersion -> build the indexes ->
  WATCH from that version -> apply the events -> on a clean end, watch
  again from the last version seen -> on 410 Gone, LIST again after a
  backoff growing from WATCH_STORE_RELIST_BASE_S to _CAP_S (with jitter),
  never a tight loop.

Reads are dictionary lookups: the worker pods, intents and journals by pod,
the pool pods by node. The worker registry's watch rides the same stream
(``watch_worker_pods``): its events fan out to the registry, and a relist
ends the registry's stream so that it LISTs the fresh indexes again, so a
master keeps one watch of the API, not a second one of the worker pods
(the reference hands the registry a live watch of its own). Writes go through the list-backed store's writes and
update the indexes at once under an own-write overlay, so that a replica
reads its own writes while the stream catches up (the overlay retires when
the write's own event arrives). Until the first sync a read waits up to
WATCH_STORE_SYNC_TIMEOUT_S and then reads through the list-backed store,
so that its errors reach the outage cache above (``store/cache.py``). It is
behind TPUMOUNTER_WATCH_STORE. ``wait_synced``, ``quiesce`` (tests) and
``stop`` (``close``); ``payload`` for /apihealth. Series:
``tpumounter_watch_store_events_total``, ``_relists_total``,
``_fallback_reads_total`` and ``tpumounter_watch_store_synced``.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from collections.abc import Iterator
from copy import deepcopy

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.k8s.errors import GoneError, classify_exception
from gpumounter_tpu_torch.k8s.types import Pod, match_label_selector
from gpumounter_tpu_torch.store.base import MasterStore
from gpumounter_tpu_torch.store.k8s import KubeMasterStore
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("store.watch")

WATCH_EVENTS = REGISTRY.counter(
    "tpumounter_watch_store_events_total",
    "watch events applied to the store indexes, by kind")
WATCH_RELISTS = REGISTRY.counter(
    "tpumounter_watch_store_relists_total",
    "full re-LISTs of the watch store, by reason")
WATCH_FALLBACK_READS = REGISTRY.counter(
    "tpumounter_watch_store_fallback_reads_total",
    "reads served by the list-backed path because the indexes were "
    "not yet synced")
WATCH_SYNCED = REGISTRY.gauge(
    "tpumounter_watch_store_synced",
    "1 while the watch store indexes are primed and serving reads")


class WatchMasterStore(MasterStore):
    """The informer-backed store; the list-backed one does its writes and
    its reads before the first sync."""

    def __init__(self, kube: KubeClient, cfg=None, start: bool = True):
        self.kube = kube
        self.cfg = cfg or Config()
        self.inner = KubeMasterStore(kube, self.cfg)
        self._mu = OrderedLock("store.watch")
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._pods: dict[tuple[str, str], dict] = {}
        self._workers: dict[tuple[str, str], dict] = {}
        self._intents: dict[tuple[str, str], object] = {}
        self._journals: dict[tuple[str, str], dict] = {}
        #: node -> {(namespace, name): pod}, the pool namespace's pods
        self._pool_by_node: dict[str, dict[tuple[str, str], dict]] = {}
        #: (namespace, name) -> {annotation: value or None}: our writes,
        #: merged over that pod's events until the stream echoes them
        self._overlays: dict[tuple[str, str], dict[str, str | None]] = {}
        self._rv = ""
        #: the worker registry's streams: (etype, pod) items, None at their end
        self._worker_streams: list[queue.SimpleQueue] = []
        self.relists = 0
        self.events_applied = 0
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(target=self._loop, name="watch-store", daemon=True)
            self._thread.start()

    # --- the informer ---

    def _backoff_wait(self, backoff: float) -> bool:
        """Wait `backoff` and up to half again; True when stopped."""
        return self._stop.wait(backoff + random.uniform(0, backoff / 2))

    def _loop(self) -> None:
        base = float(self.cfg.store_watch_relist_base_s)
        cap = float(self.cfg.store_watch_relist_cap_s)
        backoff, need_list, reason = base, True, "initial"
        while not self._stop.is_set():
            if need_list:
                try:
                    self._relist(reason)
                except Exception as exc:  # noqa: BLE001 — an outage: serve the last indexes
                    logger.warning("watch-store relist failed: %s", classify_exception(exc))
                    if self._backoff_wait(backoff):
                        return
                    backoff = min(cap, backoff * 2)
                    continue
                need_list, backoff = False, base
            try:
                stream = self.kube.watch_pods("", timeout_s=float(self.cfg.store_watch_timeout_s),
                                              resource_version=self._rv)
                for etype, pod in stream:
                    if self._stop.is_set():
                        return
                    self._apply_event(etype, pod)
                # a clean end: watch again from the last version seen (an
                # expired one raises GoneError at the open)
            except GoneError:
                logger.info("watch expired (410 Gone); re-listing")
                need_list, reason = True, "gone"
                if self._backoff_wait(backoff):
                    return
                backoff = min(cap, backoff * 2)
            except Exception as exc:  # noqa: BLE001 — a blip or a partition
                logger.warning("watch stream failed: %s", classify_exception(exc))
                if self._backoff_wait(backoff):
                    return
                backoff = min(cap, backoff * 2)

    def _relist(self, reason: str) -> None:
        pods, rv = self.kube.list_pods_with_rv()
        with self._mu:
            self._pods.clear()
            self._workers.clear()
            self._intents.clear()
            self._journals.clear()
            self._pool_by_node.clear()
            # a LIST after a write that completed shows it
            self._overlays.clear()
            for pod in pods:
                self._index(pod)
            self._rv = rv
            self.relists += 1
            # a stream's deltas end here: its reader LISTs the new indexes
            self._end_worker_streams_locked()
        self._synced.set()
        WATCH_SYNCED.set(1)
        WATCH_RELISTS.inc(reason=reason)
        logger.info("watch-store primed: %d pods at rv=%s (%s)", len(pods), rv or "?", reason)

    def _apply_event(self, etype: str, pod: dict) -> None:
        p = Pod(pod)
        key = (p.namespace, p.name)
        with self._mu:
            overlay = self._overlays.get(key)
            if overlay is not None and etype != "DELETED":
                annots = pod.get("metadata", {}).get("annotations") or {}
                if all(annots.get(k) == v if v is not None else k not in annots
                       for k, v in overlay.items()):
                    del self._overlays[key]  # the stream caught up with our write
                else:
                    meta = pod.setdefault("metadata", {})
                    merged = dict(meta.get("annotations") or {})
                    for k, v in overlay.items():
                        if v is None:
                            merged.pop(k, None)
                        else:
                            merged[k] = v
                    meta["annotations"] = merged
            was_worker = key in self._workers
            if etype == "DELETED":
                self._overlays.pop(key, None)
                self._deindex(key)
            else:
                self._index(pod)
            if key in self._workers:
                self._publish_locked(etype, pod)
            elif was_worker:
                self._publish_locked("DELETED", pod)  # it left the selector
            rv = (pod.get("metadata", {}) or {}).get("resourceVersion")
            if rv:
                self._rv = str(rv)
            self.events_applied += 1
        WATCH_EVENTS.inc(kind=etype.lower() or "unknown")

    # --- the worker registry's streams (the caller holds _mu) ---

    def _publish_locked(self, etype: str, pod: dict) -> None:
        for stream in self._worker_streams:
            stream.put((etype, deepcopy(pod)))

    def _end_worker_streams_locked(self) -> None:
        for stream in self._worker_streams:
            stream.put(None)
        self._worker_streams = []

    def _drain(self, stream: queue.SimpleQueue, timeout_s: float
               ) -> Iterator[tuple[str, dict]]:
        deadline = time.monotonic() + timeout_s
        try:
            while not self._stop.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    return  # a clean end, as a watch's timeout
                try:
                    item = stream.get(timeout=min(left, 0.5))
                except queue.Empty:
                    continue
                if item is None:
                    return
                yield item
        finally:
            with self._mu:
                if stream in self._worker_streams:
                    self._worker_streams.remove(stream)

    # --- the indexes (the caller holds _mu) ---

    def _index(self, pod: dict) -> None:
        from gpumounter_tpu_torch.elastic.intents import Intent, IntentError
        from gpumounter_tpu_torch.migrate.journal import parse_journal
        p = Pod(pod)
        key = (p.namespace, p.name)
        prev = self._pods.get(key)
        if prev is not None:
            prev_node = Pod(prev).node_name
            if prev_node and prev_node != p.node_name:
                bucket = self._pool_by_node.get(prev_node)
                if bucket is not None:
                    bucket.pop(key, None)
                    if not bucket:
                        del self._pool_by_node[prev_node]
        self._pods[key] = pod
        if p.namespace == self.cfg.worker_namespace and \
                match_label_selector(p.labels, self.cfg.worker_label_selector):
            self._workers[key] = pod
        else:
            self._workers.pop(key, None)
        try:
            intent = Intent.from_annotations(p.annotations)
        except IntentError as exc:
            logger.warning("skipping malformed intent on %s/%s: %s", p.namespace, p.name, exc)
            intent = None
        if intent is not None:
            self._intents[key] = intent
        else:
            self._intents.pop(key, None)
        journal = parse_journal(p.annotations)
        if journal is not None:
            self._journals[key] = journal
        else:
            self._journals.pop(key, None)
        if p.namespace == self.cfg.pool_namespace and p.node_name:
            self._pool_by_node.setdefault(p.node_name, {})[key] = pod
        elif p.node_name:
            bucket = self._pool_by_node.get(p.node_name)
            if bucket is not None:
                bucket.pop(key, None)

    def _deindex(self, key: tuple[str, str]) -> None:
        pod = self._pods.pop(key, None)
        self._workers.pop(key, None)
        self._intents.pop(key, None)
        self._journals.pop(key, None)
        if pod is not None:
            node = Pod(pod).node_name
            bucket = self._pool_by_node.get(node)
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del self._pool_by_node[node]

    def _apply_own_write(self, namespace: str, pod_name: str,
                         annotations: dict[str, str | None]) -> None:
        """After one of our annotation writes landed: the index now, and an
        overlay that holds it against older events until its own arrives."""
        key = (namespace, pod_name)
        with self._mu:
            if not self._synced.is_set():
                return  # reads before the sync go through anyway
            fetch_needed = key not in self._pods
        if fetch_needed:
            # a pod made after our LIST: read it outside the lock (a slow GET
            # must not stall the events)
            try:
                fetched = self.kube.get_pod(namespace, pod_name)
            except Exception as exc:  # noqa: BLE001 — the write landed; the stream brings it
                logger.debug("own-write backfill get failed: %s", classify_exception(exc))
                return
            with self._mu:
                if self._synced.is_set() and key not in self._pods:
                    self._index(fetched)
            return
        with self._mu:
            pod = self._pods.get(key)
            if not self._synced.is_set() or pod is None:
                return  # deleted in between: the event wins
            meta = pod.setdefault("metadata", {})
            annots = dict(meta.get("annotations") or {})
            for k, v in annotations.items():
                if v is None:
                    annots.pop(k, None)
                else:
                    annots[k] = v
            meta["annotations"] = annots
            self._index(pod)
            self._overlays.setdefault(key, {}).update(annotations)

    # --- synchronization ---

    def _ready(self) -> bool:
        if self._synced.is_set():
            return True
        # the first LIST is usually in flight: give it a moment
        self._synced.wait(float(self.cfg.store_watch_sync_timeout_s))
        if self._synced.is_set():
            return True
        WATCH_FALLBACK_READS.inc()
        return False

    def wait_synced(self, timeout_s: float = 30.0) -> bool:
        return self._synced.wait(timeout_s)

    def quiesce(self, timeout_s: float = 5.0) -> bool:
        """Wait until the stream is drained: no event applied in two polls in
        a row and no overlay left."""
        deadline = time.monotonic() + timeout_s
        last, settled = -1, 0
        while time.monotonic() < deadline:
            with self._mu:
                n = self.events_applied
                overlays = bool(self._overlays)
            if n == last:
                settled += 1
                if settled >= 2 and not overlays:
                    return True
            else:
                settled = 0
            last = n
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        self._stop.set()
        self._synced.set()  # release the readers that wait
        WATCH_SYNCED.set(0)
        with self._mu:
            self._end_worker_streams_locked()
        if self._thread is not None:
            # the informer may sit in an idle stream up to its timeout; it is
            # a daemon thread: wait one window, then let it end on its own
            self._thread.join(timeout=float(self.cfg.store_watch_timeout_s) + 1.0)
            self._thread = None

    # --- reads from the indexes ---

    def list_worker_pods(self) -> list[dict]:
        if not self._ready():
            return self.inner.list_worker_pods()
        with self._mu:
            return [deepcopy(p) for p in self._workers.values()]

    def watch_worker_pods(self, timeout_s: float = 60.0) -> Iterator[tuple[str, dict]]:
        """The worker pods' events from this store's own stream, until
        timeout_s or the next relist; before the first sync, the live
        watch of the list-backed store."""
        if not self._ready():
            return self.inner.watch_worker_pods(timeout_s=timeout_s)
        stream: queue.SimpleQueue = queue.SimpleQueue()
        with self._mu:
            self._worker_streams.append(stream)
        return self._drain(stream, timeout_s)

    def list_intents(self) -> list[tuple[str, str, object]]:
        if not self._ready():
            return self.inner.list_intents()
        with self._mu:
            return [(ns, name, intent) for (ns, name), intent in self._intents.items()]

    def get_intent(self, namespace: str, pod_name: str):
        from gpumounter_tpu_torch.elastic.intents import Intent
        if self._ready():
            with self._mu:
                pod = self._pods.get((namespace, pod_name))
                if pod is not None:
                    # parsed again: a malformed intent raises as the list-backed read's
                    return Intent.from_annotations(Pod(pod).annotations)
        # a pod the informer has not seen: the live API answers (NotFoundError)
        return self.inner.get_intent(namespace, pod_name)

    def put_intent(self, namespace: str, pod_name: str, intent) -> None:
        self.inner.put_intent(namespace, pod_name, intent)
        self._apply_own_write(namespace, pod_name, dict(intent.to_annotations()))

    def delete_intent(self, namespace: str, pod_name: str) -> bool:
        from gpumounter_tpu_torch.elastic.intents import (
            ANNOT_DESIRED,
            ANNOT_MIN,
            ANNOT_PRIORITY,
            ANNOT_REPLACED,
        )
        clear: dict[str, str | None] = {ANNOT_DESIRED: None, ANNOT_MIN: None,
                                        ANNOT_PRIORITY: None, ANNOT_REPLACED: None}
        if self._synced.is_set():
            with self._mu:
                pod = self._pods.get((namespace, pod_name))
                had = pod is not None and ANNOT_DESIRED in (
                    pod.get("metadata", {}).get("annotations") or {})
            if pod is not None:
                # `had` from the index, without the list-backed store's GET
                self.kube.patch_pod(namespace, pod_name, {"metadata": {"annotations": dict(clear)}})
                self._apply_own_write(namespace, pod_name, clear)
                return had
        had = self.inner.delete_intent(namespace, pod_name)
        self._apply_own_write(namespace, pod_name, clear)
        return had

    def scan_journals(self) -> list[dict]:
        if not self._ready():
            return self.inner.scan_journals()
        with self._mu:
            return [deepcopy(j) for j in self._journals.values()]

    def save_journal(self, journal: dict) -> None:
        from gpumounter_tpu_torch.migrate.journal import ANNOT_JOURNAL, dump
        self.inner.save_journal(journal)
        src = journal["source"]
        self._apply_own_write(src["namespace"], src["pod"], {ANNOT_JOURNAL: dump(journal)})

    def get_node(self, node_name: str) -> dict | None:
        return self.inner.get_node(node_name)  # always live

    def list_pool_pods(self, node_name: str) -> list[dict]:
        if not self._ready():
            return self.inner.list_pool_pods(node_name)
        with self._mu:
            return [deepcopy(p) for p in (self._pool_by_node.get(node_name) or {}).values()]

    def load_health_state(self) -> dict | None:
        return self.inner.load_health_state()

    def save_health_state(self, state: dict) -> None:
        self.inner.save_health_state(state)

    def stamp_annotation(self, namespace: str, pod_name: str, annotation: str,
                         payload: str | None) -> None:
        self.inner.stamp_annotation(namespace, pod_name, annotation, payload)
        self._apply_own_write(namespace, pod_name, {annotation: payload})

    def close(self) -> None:
        self.stop()

    # --- for /apihealth ---

    def payload(self) -> dict:
        with self._mu:
            return {"synced": self._synced.is_set(), "resource_version": self._rv,
                    "relists": self.relists, "events_applied": self.events_applied,
                    "overlays": len(self._overlays),
                    "indexes": {"pods": len(self._pods), "workers": len(self._workers),
                                "intents": len(self._intents),
                                "journals": len(self._journals),
                                "pool_nodes": len(self._pool_by_node)}}
