"""The elastic reconciler: converge a pod's GPUs on its declared intent.

The counterpart of ``gpumounter_tpu/elastic/reconciler.py``: the master's
control loop, the declarative counterpart of /addgpu.

    the intent (the pod's annotations)    the actual (the worker's ProbeGPU)
                         \\                         /
                  diff -> plan -> AddGPU / RemoveGPU through the worker
                                   |
                 the work queue: a key a pod, a backoff with jitter on
                 failure, a global rate floor (``workqueue.py``)

The heal: the probe reports a GPU dead (its host node vanished or changed,
or its node vanished from the target's /dev) -> the reconciler
force-removes it, mounts a healthy one through the slice coordinator's
all-or-nothing path, posts ``GPUChipReplaced`` on the pod (the reference's
``TPUChipReplaced``) and stamps ``tpumounter.io/chip-replaced``, which the
tenant's ``torchside.watch_chip_replacements`` watches to pack and restore.

A pass is a ``elastic.reconcile`` span under ``trace.deferred``: its spans
are published only when it changed something or failed. It is parked (read
only) while the API is unhealthy, paused while a migration holds the pod,
and parked for a node another master replica owns; its worker calls carry
the node's fencing epoch (``master/shard.epoch_kwargs``). A heal split
across passes (the removal landed, the grow failed) is kept in
``_pending_heal`` until its replacement lands, so that it is recorded. The
failpoints ``elastic.reconcile`` (top of a pass) and ``elastic.before_grow``
(between the removal and the grow) are the chaos harness's crash sites.

The capacity plane's verdict on a grow refused for capacity
(``capacity_obs.record_rejection``, ``reconciler.py:476-495``) comes with
that plane; here it is the named no-op ``record_rejection``, which is what
the reference's does when no plane is registered.
"""

from __future__ import annotations

import json
import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.elastic.intents import ANNOT_REPLACED, Intent, IntentError, IntentStore
from gpumounter_tpu_torch.elastic.workqueue import BackoffPolicy, RateLimitedQueue
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError, patch_pod_with_retry
from gpumounter_tpu_torch.k8s.events import post_pod_event
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.shard import epoch_kwargs
from gpumounter_tpu_torch.migrate.journal import migration_active
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("elastic.reconciler")

RECONCILE_DURATION = REGISTRY.histogram(
    "tpumounter_reconcile_duration_seconds",
    "Wall time of one reconcile pass")
RECONCILE_QUEUE_DEPTH = REGISTRY.gauge(
    "tpumounter_reconcile_queue_depth",
    "Pods waiting in the elastic reconcile workqueue")
CHIPS_HEALED = REGISTRY.counter(
    "tpumounter_chips_healed_total",
    "Dead chips replaced with healthy ones by the reconciler")
CHIPS_HEAL_FAILURES = REGISTRY.counter(
    "tpumounter_chips_heal_failures_total",
    "Heal passes that found dead chips but failed before recording the "
    "heal (workqueue backoff re-drives them). With chips_healed_total "
    "this is the SLO engine's heal-success ratio (obs/slo.py)")
INTENTS_REGISTERED = REGISTRY.gauge(
    "tpumounter_intents_registered",
    "Pods with a declared elastic intent")

#: the Event on a healed pod (the reference's TPUChipReplaced)
REPLACED_REASON = "GPUChipReplaced"

#: the phases of a pass that changed nothing: their spans are dropped
_QUIET_PHASES = ("converged", "unmanaged", "gone", "not-owned", "degraded-api")


class ReconcileError(RuntimeError):
    """One pass failed; its key enters the queue again with backoff."""


def record_rejection(node: str, namespace: str, pod: str, gpus: int) -> None:
    """The capacity plane's seam: a grow refused for capacity stamps the
    plane's feasibility verdict into the audit trail. The port has no
    capacity plane yet (ROADMAP 7l), so this does nothing, as the
    reference's ``obs.capacity.record_rejection`` does when no plane is
    registered."""


class ElasticReconciler:
    def __init__(self, kube: KubeClient, registry, client_factory, cfg=None,
                 store: IntentStore | None = None, backoff: BackoffPolicy | None = None,
                 shards=None, apihealth=None):
        """registry, client_factory: the master's ``WorkerRegistry`` and its
        worker clients (the reconciler drives the RPCs the routes do).
        shards: a ``ShardManager``; while active, an intent on a node another
        replica owns is parked (its owner converges it). apihealth: the
        ``ApiHealth`` verdict; while it is not healthy every pass is read
        only (probe and report): the intent and the pod may be stale, and a
        shrink driven from a stale read cannot be undone."""
        self.cfg = cfg or Config()
        self.kube = kube
        self.registry = registry
        self.client_factory = client_factory
        self.store = store or IntentStore(kube, self.cfg)
        self.shards = shards
        self.apihealth = apihealth
        self.queue = RateLimitedQueue(
            backoff=backoff or BackoffPolicy(base_s=self.cfg.elastic_backoff_base_s,
                                             cap_s=self.cfg.elastic_backoff_cap_s),
            min_interval_s=self.cfg.elastic_min_reconcile_interval_s,
            depth_gauge=RECONCILE_QUEUE_DEPTH)
        self.resync_interval_s = self.cfg.elastic_resync_interval_s
        #: key -> the last outcome (GET /intents shows it)
        self.status: dict[str, dict] = {}
        #: key -> the monotonic stamps of its recent passes (the last 50)
        self.attempts: dict[str, list[float]] = {}
        #: key -> the dead GPUs removed by passes whose replacement has not
        #: landed yet: a heal split across passes is still recorded, or the
        #: tenant would never learn it has to repack
        self._pending_heal: dict[str, list[str]] = {}
        self._status_lock = OrderedLock("elastic.status")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle ---

    def start(self) -> "ElasticReconciler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="elastic-reconciler",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def enqueue(self, namespace: str, pod_name: str, priority: int = 0) -> None:
        self.queue.add(f"{namespace}/{pod_name}", priority=priority)

    def status_for(self, namespace: str, pod_name: str) -> dict | None:
        with self._status_lock:
            entry = self.status.get(f"{namespace}/{pod_name}")
            return dict(entry) if entry else None

    # --- the loop ---

    def _loop(self) -> None:
        next_resync = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_resync:
                self._resync()
                next_resync = now + self.resync_interval_s
            key = self.queue.get(timeout_s=min(0.2, max(0.01, next_resync - now)))
            if key is not None:
                self._process(key)

    def _resync(self) -> None:
        try:
            intents = self.store.list()
        except Exception as exc:  # noqa: BLE001 — the loop stays up
            logger.warning("intent resync LIST failed: %s", exc)
            return
        INTENTS_REGISTERED.set(float(len(intents)))
        for namespace, pod_name, intent in intents:
            self.enqueue(namespace, pod_name, priority=intent.priority)

    def _process(self, key: str) -> None:
        namespace, _, pod_name = key.partition("/")
        started = time.monotonic()
        with self._status_lock:
            self.attempts.setdefault(key, []).append(started)
            del self.attempts[key][:-50]
        try:
            outcome = self.reconcile_once(namespace, pod_name)
        except Exception as exc:  # noqa: BLE001 — backoff, not death
            if not isinstance(exc, ReconcileError):
                logger.exception("unexpected reconcile failure for %s", key)
            delay = self.queue.retry(key)
            outcome = {"phase": "backoff", "error": str(exc), "retry_in_s": round(delay, 3),
                       "failures": self.queue.failures(key)}
            logger.warning("reconcile %s failed (%s); retry in %.2fs", key, exc, delay)
        else:
            if outcome.get("phase") in ("degraded", "migrating", "degraded-api"):
                # degraded: at or above min_chips but below desired, so keep
                # trying for desired; migrating: paused for a migration;
                # degraded-api: parked read-only until the API heals. All
                # check back on the backoff schedule
                self.queue.retry(key)
            else:
                self.queue.forget(key)
        finally:
            RECONCILE_DURATION.observe(time.monotonic() - started)
        with self._status_lock:
            if outcome.get("phase") == "gone":
                self.status.pop(key, None)
                self.attempts.pop(key, None)
            else:
                outcome["at"] = time.time()
                self.status[key] = outcome

    # --- one pass (public: tests and the chaos harness drive it) ---

    def reconcile_once(self, namespace: str, pod_name: str) -> dict:
        """One traced pass. The loop has no inbound request, so the span
        starts a trace of its own, which the worker's spans of its probes,
        removes and mounts join (and the heal's audit record carries). Its
        spans are published only when the pass changed something or failed:
        a converged resync of every pod every ELASTIC_RESYNC_INTERVAL_S
        would rotate the operations' traces out of the ring."""
        with trace.deferred() as pending:
            try:
                with trace.span("elastic.reconcile", pod=f"{namespace}/{pod_name}"):
                    outcome = self._reconcile_traced(namespace, pod_name)
            except BaseException:
                pending.publish()
                raise
            if outcome.get("phase") not in _QUIET_PHASES or outcome.get("healed") \
                    or outcome.get("added") or outcome.get("removed_excess"):
                pending.publish()
        return outcome

    def _reconcile_traced(self, namespace: str, pod_name: str) -> dict:
        key = f"{namespace}/{pod_name}"
        # a crash here is the reconciler's death at the top of a pass:
        # _process turns it into the queue's backoff, as a restart would
        failpoints.fire("elastic.reconcile", key=key)
        try:
            pod = Pod(self.kube.get_pod(namespace, pod_name))
        except NotFoundError:
            self.queue.forget(key)
            self._pending_heal.pop(key, None)
            return {"phase": "gone"}
        try:
            intent = Intent.from_annotations(pod.annotations)
        except IntentError as exc:
            # a hand-edited annotation: retrying cannot fix it, so the key is
            # parked until the resync brings it back
            self.queue.forget(key)
            logger.warning("invalid intent on %s: %s", key, exc)
            return {"phase": "invalid", "error": str(exc)}
        if intent is None:
            self.queue.forget(key)
            return {"phase": "unmanaged"}
        mid = migration_active(pod.annotations, kube=self.kube)
        if mid is not None:
            # a migration owns the pod's GPUs (source or destination):
            # converging now would fight its drain and remount. _process
            # checks back on the backoff schedule until it is terminal
            logger.info("reconcile of %s paused: migration %s in flight", key, mid)
            return {"phase": "migrating", "migration": mid}
        if not pod.node_name:
            raise ReconcileError(f"pod {pod_name} is not scheduled yet")
        if self.shards is not None and self.shards.active() \
                and not self.shards.owns_node(pod.node_name):
            # the node's owner converges it: two replicas on one pod would
            # race their probes and mounts. Parked; the resync brings it back
            # and a takeover flips this branch
            self.queue.forget(key)
            return {"phase": "not-owned", "shard": self.shards.owner_shard(pod.node_name)}
        address = self.registry.worker_address(pod.node_name)
        if address is None:
            raise ReconcileError(f"no gpu-mounter worker on node {pod.node_name}")

        if self.apihealth is not None and not self.apihealth.ok():
            # read only: the probe is a worker call (no API), so the status
            # still shows the live count, but no mount and above all no
            # shrink lands from an intent that may be a stale cache entry
            chips = self._probe(address, pod)
            healthy_now = [c for c in chips if c.healthy]
            logger.info("reconcile of %s parked read-only: api %s (actual=%d desired=%d)", key,
                        self.apihealth.state(), len(healthy_now), intent.desired_chips)
            return {"phase": "degraded-api", "api": self.apihealth.state(),
                    "desired": intent.desired_chips, "actual": len(healthy_now)}

        chips = self._probe(address, pod)
        dead = [c for c in chips if not c.healthy]
        healthy = [c for c in chips if c.healthy]
        if dead or self._pending_heal.get(key):
            return self._heal_counted(key, namespace, pod_name, pod, intent, address, dead,
                                      healthy)
        return self._converge(key, namespace, pod_name, pod, intent, address, dead, healthy)

    def _heal_counted(self, key, namespace, pod_name, pod, intent, address, dead,
                      healthy) -> dict:
        """A pass with dead GPUs (or a heal journaled half done) is a heal:
        a failure before _record_heal counts against the heal SLO (the queue
        still drives it again)."""
        try:
            return self._converge(key, namespace, pod_name, pod, intent, address, dead, healthy)
        except BaseException:
            CHIPS_HEAL_FAILURES.inc()
            raise

    def _converge(self, key, namespace, pod_name, pod, intent, address, dead, healthy) -> dict:
        removed_now = self._remove_gpus(address, pod, [c.uuid for c in dead])
        # journaled BEFORE the replacement's mount: if this pass dies in
        # _grow, the next sees no dead GPU, and without the journal the heal
        # would never be recorded (no marker, no repack)
        pending = self._pending_heal.setdefault(key, [])
        pending.extend(u for u in removed_now if u not in pending)
        removed_dead = list(pending)

        actual = len(healthy)
        desired = intent.desired_chips
        degraded = False
        if actual < desired:
            # the crash site between the journaled removal and the mount
            failpoints.fire("elastic.before_grow", key=key, gap=desired - actual)
            degraded = not self._grow(pod, intent, desired - actual, actual)
        removed_excess: list[str] = []
        if actual > desired:
            # a declarative shrink is forced: a CUDA process holds its GPUs
            # for its life, so a polite remove would answer busy
            removed_excess = self._remove_gpus(address, pod,
                                               [c.uuid for c in healthy[desired:]])

        after = self._probe(address, pod)
        healthy_after = [c for c in after if c.healthy]
        added = sorted({c.uuid for c in healthy_after} - {c.uuid for c in healthy})
        if removed_dead:
            self._record_heal(pod, removed_dead, added)
            self._pending_heal.pop(key, None)

        outcome = {
            "phase": "degraded" if degraded else "converged",
            "desired": desired,
            "actual": len(healthy_after),
            "healed": len(removed_dead),
            "removed_dead": removed_dead,
            "removed_excess": removed_excess,
            "added": added,
        }
        if not degraded and len(healthy_after) != desired:
            # the cluster moved between the probes: say so, and let the
            # backoff drive it again
            raise ReconcileError(f"post-reconcile count {len(healthy_after)} != desired "
                                 f"{desired} for {namespace}/{pod_name}")
        logger.info("reconciled %s/%s: %s", namespace, pod_name, outcome)
        return outcome

    # --- the steps ---

    def _probe(self, address: str, pod: Pod) -> list[api.ChipHealth]:
        try:
            with self.client_factory(address) as client:
                result, chips = client.probe_gpu(pod.name, pod.namespace)
        except Exception as exc:  # noqa: BLE001 — the worker call's boundary
            raise ReconcileError(f"probe RPC failed: {exc}")
        if result != api.ProbeGPUResult.Success:
            raise ReconcileError(f"probe returned {result.name}")
        return chips

    def _remove_gpus(self, address: str, pod: Pod, uuids: list[str]) -> list[str]:
        """Force-remove each of `uuids` (one call a GPU, as the reference's),
        at the node's fencing epoch."""
        removed: list[str] = []
        epoch = epoch_kwargs(self.shards, pod.node_name)
        for uuid in uuids:
            try:
                with self.client_factory(address) as client:
                    result = client.remove_gpu(pod.name, pod.namespace, [uuid], force=True,
                                               **epoch).remove_gpu_result
            except Exception as exc:  # noqa: BLE001 — the worker call's boundary
                raise ReconcileError(f"remove of {uuid} failed: {exc}")
            if result not in (api.RemoveGPUResult.Success, api.RemoveGPUResult.GPUNotFound):
                raise ReconcileError(f"remove of {uuid} returned "
                                     f"{api.RemoveGPUResult(result).name}")
            removed.append(uuid)
        return removed

    def _grow(self, pod: Pod, intent: Intent, gap: int, actual: int) -> bool:
        """Mount `gap` GPUs through the slice coordinator's all-or-nothing
        path. True when desired was reached, False when only the min_chips
        floor was."""
        from gpumounter_tpu_torch.master.slice_ops import (
            SliceCoordinator,
            SliceError,
            SliceTarget,
        )

        coordinator = SliceCoordinator(self.kube, self.registry, self.client_factory, self.cfg,
                                       shards=self.shards)
        target = SliceTarget(namespace=pod.namespace, pod=pod.name)
        try:
            coordinator.mount_slice([target], gap, entire=False)
            return True
        except SliceError as exc:
            # a degraded worker (its breaker open: retry_after_s) is 503 too,
            # but no shortage: back off, do not shrink toward the floor
            if exc.status != 503 or exc.retry_after_s is not None:
                raise ReconcileError(f"mount of {gap} chip(s) failed: {exc}")
        # capacity exhausted. At or above the floor this is "degraded, not
        # failed": keep trying for desired, and record no rejection on every
        # backoff pass (N such intents would flood the audit ring)
        floor_gap = intent.min_chips - actual
        if floor_gap <= 0:
            logger.warning("capacity-limited: %s/%s holds %d >= min_chips %d (desired %d); "
                           "will keep retrying", pod.namespace, pod.name, actual,
                           intent.min_chips, intent.desired_chips)
            return False
        # below the floor a smaller mount may still reach it; a true failure
        # is recorded (the capacity plane's seam)
        if floor_gap < gap:
            try:
                coordinator.mount_slice([target], floor_gap, entire=False)
                logger.warning("capacity-limited: %s/%s at min_chips floor %d (desired %d); "
                               "will keep retrying", pod.namespace, pod.name,
                               intent.min_chips, intent.desired_chips)
                return False
            except SliceError as exc:
                record_rejection(pod.node_name, pod.namespace, pod.name, floor_gap)
                raise ReconcileError(f"floor mount of {floor_gap} chip(s) failed: {exc}")
        record_rejection(pod.node_name, pod.namespace, pod.name, gap)
        raise ReconcileError(f"insufficient capacity for {gap} chip(s) "
                             f"(actual={actual}, min={intent.min_chips})")

    def _record_heal(self, pod: Pod, removed: list[str], added: list[str]) -> None:
        CHIPS_HEALED.inc(len(removed))
        AUDIT.record("elastic.heal", actor="reconciler", namespace=pod.namespace,
                     pod=pod.name, chips=added, outcome="success", removed=sorted(removed))
        previous = {}
        try:
            previous = json.loads(pod.annotations.get(ANNOT_REPLACED, "{}"))
        except ValueError:
            pass
        marker = {
            "generation": int(previous.get("generation", 0)) + 1,
            "removed": removed,
            "added": added,
            # the pass's trace: the tenant's telemetry stamps it on the heal's
            # disruption window, so its repack and restore join this heal
            "trace_id": trace.current_trace_id(),
            "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        try:
            patch_pod_with_retry(self.kube, pod.namespace, pod.name,
                                 {"metadata": {"annotations": {ANNOT_REPLACED: json.dumps(marker)}}},
                                 attempts=self.cfg.k8s_write_attempts,
                                 base_s=self.cfg.k8s_write_retry_base_s)
        except Exception as exc:  # noqa: BLE001 — the marker is advisory
            logger.warning("chip-replaced annotation patch failed: %s", exc)
        post_pod_event(self.kube, pod, REPLACED_REASON,
                       f"replaced {len(removed)} dead chip(s) {', '.join(removed)} with "
                       f"{', '.join(added) or '(pending)'}", event_type="Warning",
                       component="tpumounter-elastic")
        logger.info("healed %s/%s: removed %s added %s", pod.namespace, pod.name, removed, added)
