"""In-memory fake Kubernetes client.

The counterpart of ``FakeKubeClient`` in ``gpumounter_tpu/k8s/fake.py``: the
``KubeClient`` surface over a dict of pods, with watch streams and a
scheduler hook, so that the allocator and the worker's flows run in one
process. Its writes pass the REST client's failpoint hook
(``inject_write_fault``), and ``events_posted`` keeps every Event. The original GPUMounter has no such substrate: its tests need a
live cluster.

As the reference's: ``set_partitioned(True, mode=...)`` makes the calls of
a plane raise ``PartitionError`` (typed 503) until it is cleared: "full"
every call, "reads" get, list and the opening of a watch, "writes" create,
delete, patch and the lease writes; a watch already open runs on.
``list_pods_with_rv`` answers the last event's sequence number as the
collection's resourceVersion, and a watch given one resumes after it (one
trimmed out of the backlog raises GoneError at the open). Leases keep a
resourceVersion of their own, and ``update_lease`` is a CAS on it. Nodes
are Node objects with a Ready condition: ``create_node``, ``set_node_ready``
(a kubelet whose heartbeats stopped) and ``delete_node`` are the tests'
helpers, ``get_node`` and ``list_nodes`` reads of the read plane.
"""

from __future__ import annotations

import copy
import heapq
import itertools
import threading
import time
import uuid as uuidlib
from collections.abc import Callable, Iterator

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient, inject_write_fault
from gpumounter_tpu_torch.k8s.errors import (
    ConflictError,
    GoneError,
    NotFoundError,
    PartitionError,
)
from gpumounter_tpu_torch.k8s.types import Pod, match_label_selector
from gpumounter_tpu_torch.utils.locks import OrderedCondition
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
                 delete_hook: SchedulerHook | None = None, cfg=None):
        # events kept for open watches (TPUMOUNTER_WATCH_BACKLOG); a watcher
        # that falls further behind has its stream ended, as an API
        # server's 410 Gone would
        self._max_events = max(64, int((cfg or Config()).watch_backlog_events))
        self._pods: dict[tuple[str, str], dict] = {}
        self._leases: dict[tuple[str, str], dict] = {}
        self._nodes: dict[str, dict] = {}
        self._lease_rv = itertools.count(1)
        # the API partition: off, or failing one plane ("full", "reads",
        # "writes")
        self._partitioned = False
        self._partition_mode = "full"
        # the last event's sequence number: a LIST's resourceVersion
        self._last_seq = 0
        # a condition over an RLock (the scheduler thread emits while it
        # holds the store lock), in the lock-order graph
        self._lock = OrderedCondition("k8s.fake.state")
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
        #: (namespace, manifest) of every Event posted (k8s/events.py)
        self.events_posted: list[tuple[str, dict]] = []
        # One scheduler thread drains a heap of due times (started on the
        # first create, retired when idle).
        self._sched_cv = OrderedCondition("k8s.fake.sched")
        self._sched_q: list[tuple[float, int, str, str]] = []
        self._sched_seq = itertools.count(1)
        self._sched_thread: threading.Thread | None = None

    # --- events ---

    def _emit(self, etype: str, pod: dict) -> None:
        with self._lock:
            seq = next(self._seq)
            self._last_seq = seq
            pod.setdefault("metadata", {})["resourceVersion"] = str(seq)
            # One copy at emit: watchers read the payload outside the lock.
            self._events.append((seq, etype, copy.deepcopy(pod)))
            overflow = len(self._events) - self._max_events
            if overflow > 0:
                # count only what the slowest open watcher has not read
                horizon = self._events[overflow - 1][0]
                evicted = max([min(overflow, horizon - cursor)
                               for cursor in self._watch_cursors.values()], default=0)
                if evicted > 0:
                    WATCH_BACKLOG_EVICTIONS.inc(evicted)
                del self._events[:overflow]
            self._lock.notify_all()

    # --- the API partition ---

    def set_partitioned(self, partitioned: bool, mode: str = "full") -> None:
        """Fail the calls of a plane with PartitionError until cleared:
        "full" every call, "reads" only get/list/watch, "writes" only
        create/delete/patch/update."""
        if mode not in ("full", "reads", "writes"):
            raise ValueError(f"unknown partition mode {mode!r}")
        self._partitioned = bool(partitioned)
        self._partition_mode = mode

    def _check_partition(self, kind: str = "read") -> None:
        if not self._partitioned:
            return
        mode = self._partition_mode
        if mode == "full" or (mode == "reads" and kind == "read") \
                or (mode == "writes" and kind == "write"):
            raise PartitionError(f"fake apiserver partitioned (set_partitioned, mode={mode}, "
                                 f"op={kind})")

    # --- KubeClient surface ---

    def get_pod(self, namespace: str, name: str) -> dict:
        self._check_partition("read")
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name} not found")
            return copy.deepcopy(pod)

    def create_pod(self, namespace: str, manifest: dict) -> dict:
        self._check_partition("write")
        # the REST client's injection surface, so that a chaos schedule hits
        # the fake as it would an API server
        inject_write_fault("create_pod", namespace, manifest.get("metadata", {}).get("name", ""))
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
        self._check_partition("write")
        try:
            inject_write_fault("delete_pod", namespace, name)
        except NotFoundError:
            return  # as the REST client: the delete of a missing pod is a no-op
        with self._lock:
            pod = self._pods.pop((namespace, name), None)
            self.delete_calls += 1
        if pod is not None:  # delete of a missing pod is a no-op
            if self.delete_hook is not None:
                self.delete_hook(pod)
            self._emit("DELETED", pod)

    def list_pods(self, namespace: str | None = None, label_selector: str = "",
                  field_selector: str = "") -> list[dict]:
        return self.list_pods_with_rv(namespace, label_selector, field_selector)[0]

    def list_pods_with_rv(self, namespace: str | None = None, label_selector: str = "",
                          field_selector: str = "") -> tuple[list[dict], str]:
        self._check_partition("read")
        with self._lock:
            return [copy.deepcopy(pod) for (ns, _), pod in self._pods.items()
                    if (not namespace or ns == namespace)
                    and match_label_selector(Pod(pod).labels, label_selector)
                    and _match_field_selector(pod, field_selector)], str(self._last_seq)

    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        self._check_partition("write")
        inject_write_fault("patch_pod", namespace, name)
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name} not found")
            _merge_patch(pod, patch)
            self._emit("MODIFIED", pod)
            return copy.deepcopy(pod)

    def create_event(self, namespace: str, manifest: dict) -> dict:
        with self._lock:
            self.events_posted.append((namespace, copy.deepcopy(manifest)))
        return manifest

    def watch_pods(self, namespace: str, *, label_selector: str = "",
                   field_selector: str = "", timeout_s: float = 60.0,
                   resource_version: str = "") -> Iterator[tuple[str, dict]]:
        self._check_partition("read")
        # The cursor is taken now, not at the first next(): wait_for_pod
        # opens the watch, then re-reads, and relies on this.
        deadline = time.monotonic() + timeout_s
        with self._lock:
            cursor = self._events[-1][0] if self._events else 0
            if resource_version:
                try:
                    cursor = int(resource_version)
                except ValueError:
                    pass  # not a version of this server: from now
                else:
                    if self._events and cursor < self._events[0][0] - 1:
                        raise GoneError(f"resourceVersion {resource_version} is too old "
                                        f"(backlog starts at {self._events[0][0]})")
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

    # --- leases (coordination.k8s.io/v1), CAS on resourceVersion ---

    def get_lease(self, namespace: str, name: str) -> dict:
        self._check_partition("read")
        with self._lock:
            lease = self._leases.get((namespace, name))
            if lease is None:
                raise NotFoundError(f"lease {namespace}/{name} not found")
            return copy.deepcopy(lease)

    def create_lease(self, namespace: str, manifest: dict) -> dict:
        self._check_partition("write")
        inject_write_fault("create_lease", namespace, manifest.get("metadata", {}).get("name", ""))
        lease = copy.deepcopy(manifest)
        meta = lease.setdefault("metadata", {})
        meta.setdefault("namespace", namespace)
        name = meta.get("name")
        if not name:
            raise ValueError("lease manifest missing metadata.name")
        with self._lock:
            if (namespace, name) in self._leases:
                raise ConflictError(f"lease {namespace}/{name} already exists")
            meta["resourceVersion"] = str(next(self._lease_rv))
            self._leases[(namespace, name)] = lease
            return copy.deepcopy(lease)

    def update_lease(self, namespace: str, name: str, manifest: dict) -> dict:
        self._check_partition("write")
        inject_write_fault("update_lease", namespace, name)
        with self._lock:
            current = self._leases.get((namespace, name))
            if current is None:
                raise NotFoundError(f"lease {namespace}/{name} not found")
            sent = manifest.get("metadata", {}).get("resourceVersion")
            have = current["metadata"].get("resourceVersion")
            if sent != have:
                raise ConflictError(f"lease {namespace}/{name}: resourceVersion conflict "
                                    f"(sent {sent}, have {have})")
            lease = copy.deepcopy(manifest)
            meta = lease.setdefault("metadata", {})
            meta["resourceVersion"] = str(next(self._lease_rv))
            meta.setdefault("namespace", namespace)
            meta.setdefault("name", name)
            self._leases[(namespace, name)] = lease
            return copy.deepcopy(lease)

    # --- core/v1 Nodes (the recovery controller's readiness signal) ---

    def get_node(self, name: str) -> dict:
        self._check_partition("read")
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise NotFoundError(f"node {name} not found")
            return copy.deepcopy(node)

    def list_nodes(self) -> list[dict]:
        self._check_partition("read")
        with self._lock:
            return [copy.deepcopy(n) for n in self._nodes.values()]

    def create_node(self, name: str, ready: bool = True) -> dict:
        """A Node object with its Ready condition (a test's helper)."""
        node = {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "uid": str(uuidlib.uuid4())},
            "status": {"conditions": [{"type": "Ready",
                                       "status": "True" if ready else "False"}]},
        }
        with self._lock:
            self._nodes[name] = node
            return copy.deepcopy(node)

    def set_node_ready(self, name: str, ready: bool, reason: str = "") -> None:
        """Flip the node's Ready condition: a kubelet that stopped its
        heartbeats, as the API server shows it."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise NotFoundError(f"node {name} not found")
            node["status"]["conditions"] = [{
                "type": "Ready", "status": "True" if ready else "False",
                **({"reason": reason} if reason else {})}]

    def delete_node(self, name: str) -> None:
        with self._lock:
            self._nodes.pop(name, None)

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
