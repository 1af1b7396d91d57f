"""In-memory fake Kubernetes client.

The counterpart of ``FakeKubeClient`` in ``gpumounter_tpu/k8s/fake.py``: the
``KubeClient`` surface over a dict of pods, with watch streams and a
scheduler hook, so that the allocator and the worker's flows run in one
process. The original GPUMounter has no such substrate: its tests need a
live cluster.
"""

from __future__ import annotations

import copy
import heapq
import itertools
import threading
import time
import uuid as uuidlib
from collections.abc import Callable, Iterator

from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.k8s.errors import ConflictError, NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod, match_label_selector
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("k8s.fake")

#: events trimmed out of the watch backlog while an open watcher had not
#: read them yet: each is a future end of that watcher's stream (its 410).
WATCH_BACKLOG_EVICTIONS = REGISTRY.counter(
    "tpumounter_watch_backlog_evictions_total",
    "watch events evicted past an open watcher's resume cursor")

SchedulerHook = Callable[[dict], None]
"""Called with the stored pod dict (mutable) after create_pod, on the
fake's scheduler thread, to play the scheduler: set spec.nodeName,
status.phase, or an Unschedulable condition."""

#: events kept for open watches; a watcher that falls further behind has
#: its stream ended, as an API server's 410 Gone would.
MAX_EVENTS = 8192


def _match_field_selector(pod: dict, selector: str) -> bool:
    if not selector:
        return True
    p = Pod(pod)
    for clause in selector.split(","):
        k, _, v = clause.partition("=")
        k, v = k.strip(), v.strip()
        if k == "metadata.name" and p.name != v:
            return False
        if k == "metadata.namespace" and p.namespace != v:
            return False
        if k == "spec.nodeName" and p.node_name != v:
            return False
        if k == "status.phase" and p.phase != v:
            return False
    return True


def _merge_patch(target: dict, patch: dict) -> None:
    """RFC 7386 merge-patch: None deletes, dicts recurse, the rest replaces."""
    for key, value in patch.items():
        if value is None:
            target.pop(key, None)
        elif isinstance(value, dict) and isinstance(target.get(key), dict):
            _merge_patch(target[key], value)
        else:
            target[key] = value


class FakeKubeClient(KubeClient):
    def __init__(self, scheduler_hook: SchedulerHook | None = None,
                 scheduler_delay_s: float = 0.0,
                 delete_hook: SchedulerHook | None = None):
        self._pods: dict[tuple[str, str], dict] = {}
        # Condition over an RLock: the scheduler thread emits while it
        # holds the store lock.
        self._lock = threading.Condition(threading.RLock())
        self._events: list[tuple[int, str, dict]] = []  # (seq, type, pod)
        self._seq = itertools.count(1)
        # open watcher id -> the last seq it read, for the eviction count
        self._watch_cursors: dict[int, int] = {}
        self._watch_ids = itertools.count(1)
        self.scheduler_hook = scheduler_hook
        self.delete_hook = delete_hook
        self.scheduler_delay_s = scheduler_delay_s
        self.create_calls = 0
        self.delete_calls = 0
        # One scheduler thread drains a heap of due times (started on the
        # first create, retired when idle).
        self._sched_cv = threading.Condition()
        self._sched_q: list[tuple[float, int, str, str]] = []
        self._sched_seq = itertools.count(1)
        self._sched_thread: threading.Thread | None = None

    # --- events ---

    def _emit(self, etype: str, pod: dict) -> None:
        with self._lock:
            seq = next(self._seq)
            pod.setdefault("metadata", {})["resourceVersion"] = str(seq)
            # One copy at emit: watchers read the payload outside the lock.
            self._events.append((seq, etype, copy.deepcopy(pod)))
            overflow = len(self._events) - MAX_EVENTS
            if overflow > 0:
                # count only what the slowest open watcher has not read
                horizon = self._events[overflow - 1][0]
                evicted = max([min(overflow, horizon - cursor)
                               for cursor in self._watch_cursors.values()], default=0)
                if evicted > 0:
                    WATCH_BACKLOG_EVICTIONS.inc(evicted)
                del self._events[:overflow]
            self._lock.notify_all()

    # --- KubeClient surface ---

    def get_pod(self, namespace: str, name: str) -> dict:
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name} not found")
            return copy.deepcopy(pod)

    def create_pod(self, namespace: str, manifest: dict) -> dict:
        pod = copy.deepcopy(manifest)
        meta = pod.setdefault("metadata", {})
        meta.setdefault("namespace", namespace)
        name = meta.get("name")
        if not name:
            raise ValueError("pod manifest missing metadata.name")
        meta.setdefault("uid", str(uuidlib.uuid4()))
        pod.setdefault("status", {}).setdefault("phase", "Pending")
        with self._lock:
            if (namespace, name) in self._pods:
                raise ConflictError(f"pod {namespace}/{name} already exists")
            self._pods[(namespace, name)] = pod
            self.create_calls += 1
            self._emit("ADDED", pod)
            out = copy.deepcopy(pod)
        if self.scheduler_hook is not None:
            self._enqueue_schedule(namespace, name)
        return out

    def delete_pod(self, namespace: str, name: str, grace_period_seconds: int = 0) -> None:
        with self._lock:
            pod = self._pods.pop((namespace, name), None)
            self.delete_calls += 1
        if pod is not None:  # delete of a missing pod is a no-op
            if self.delete_hook is not None:
                self.delete_hook(pod)
            self._emit("DELETED", pod)

    def list_pods(self, namespace: str | None = None, label_selector: str = "",
                  field_selector: str = "") -> list[dict]:
        with self._lock:
            return [copy.deepcopy(pod) for (ns, _), pod in self._pods.items()
                    if (not namespace or ns == namespace)
                    and match_label_selector(Pod(pod).labels, label_selector)
                    and _match_field_selector(pod, field_selector)]

    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name} not found")
            _merge_patch(pod, patch)
            self._emit("MODIFIED", pod)
            return copy.deepcopy(pod)

    def watch_pods(self, namespace: str, *, label_selector: str = "",
                   field_selector: str = "", timeout_s: float = 60.0,
                   ) -> Iterator[tuple[str, dict]]:
        # The cursor is taken now, not at the first next(): wait_for_pod
        # opens the watch, then re-reads, and relies on this.
        deadline = time.monotonic() + timeout_s
        with self._lock:
            cursor = self._events[-1][0] if self._events else 0
        return self._watch_iter(namespace, label_selector, field_selector,
                                deadline, cursor)

    def _pending_locked(self, cursor: int) -> list | None:
        """Events after `cursor`; None when the backlog was trimmed past it."""
        if not self._events:
            return []
        first = self._events[0][0]
        if cursor < first - 1:
            return None
        return self._events[cursor - (first - 1):]  # seqs are consecutive

    def _watch_iter(self, namespace, label_selector, field_selector,
                    deadline, cursor) -> Iterator[tuple[str, dict]]:
        watch_id = next(self._watch_ids)
        try:
            while True:
                with self._lock:
                    self._watch_cursors[watch_id] = cursor
                    pending = self._pending_locked(cursor)
                    if pending == []:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return
                        self._lock.wait(timeout=min(remaining, 0.25))
                        pending = self._pending_locked(cursor)
                if pending is None:
                    logger.warning("watch backlog trimmed past cursor %d; ending "
                                   "the stream", cursor)
                    return
                for seq, etype, pod in pending:
                    cursor = max(cursor, seq)
                    p = Pod(pod)
                    if namespace and p.namespace != namespace:
                        continue
                    if not match_label_selector(p.labels, label_selector):
                        continue
                    if not _match_field_selector(pod, field_selector):
                        continue
                    yield etype, copy.deepcopy(pod)
                if time.monotonic() >= deadline:
                    return
        finally:
            with self._lock:
                self._watch_cursors.pop(watch_id, None)

    # --- the scheduler thread ---

    def _enqueue_schedule(self, namespace: str, name: str) -> None:
        due = time.monotonic() + self.scheduler_delay_s
        with self._sched_cv:
            heapq.heappush(self._sched_q, (due, next(self._sched_seq), namespace, name))
            if self._sched_thread is None:
                self._sched_thread = threading.Thread(
                    target=self._sched_loop, name="fake-scheduler", daemon=True)
                self._sched_thread.start()
            self._sched_cv.notify()

    def _sched_loop(self) -> None:
        while True:
            with self._sched_cv:
                if not self._sched_q:
                    self._sched_cv.wait(timeout=0.05)
                    if not self._sched_q:
                        self._sched_thread = None
                        return
                due, _, namespace, name = self._sched_q[0]
                now = time.monotonic()
                if due > now:
                    self._sched_cv.wait(timeout=due - now)
                    continue
                heapq.heappop(self._sched_q)
            # Under the store lock: readers never see a half-written status.
            try:
                with self._lock:
                    stored = self._pods.get((namespace, name))
                    if stored is None:
                        continue
                    self.scheduler_hook(stored)
                    self._emit("MODIFIED", stored)
            except Exception:  # noqa: BLE001 — a bad hook must not take
                # the scheduler thread down for every later pod
                logger.exception("scheduler hook failed for %s/%s", namespace, name)

    # --- test helpers ---

    def set_pod_status(self, namespace: str, name: str, **status) -> None:
        """Merge fields into a pod's status."""
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name} not found")
            pod.setdefault("status", {}).update(status)
            self._emit("MODIFIED", pod)
