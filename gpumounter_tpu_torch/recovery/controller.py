"""The recovery controller: find dead nodes, confirm them, evacuate them.

The counterpart of ``gpumounter_tpu/recovery/controller.py``. The original
GPUMounter leaves a node's death to its operators: the slave pods keep their
bookings, and every call to the node's worker fails. This controller closes
the loop, one replica of the master at a time:

  detect    every pass, each tracked node gets a liveness verdict from three
            signals: the worker registry (is a worker pod registered for
            it?), the registry's breaker (is its transport open?), and a
            CollectTelemetry call with a short deadline (any answer, an
            application error too, proves the process alive); the probes fan
            out on the shared core (``utils/fanout.py``), by owner shard when
            the shards are active;
  confirm   a node is dead only after RECOVERY_CONFIRM_FAILURES failed passes
            in a row AND RECOVERY_GRACE_S of failure AND the cluster's word:
            its Node NotReady, or its worker pod gone from the registry. A
            worker that crashed on a Ready node is left to its restart's
            ledger replay (``worker/resync.py``); no Node object and a
            worker still registered is not enough either. While ApiHealth is
            not healthy the automatic evacuation is suspended: the evidence
            is stale, and the node stays suspect;
  evacuate  in a ``recovery.evacuate`` span, with its audit record and the
            flight recorder's marker: the node's pool pods are deleted (slave
            pods and warm holders: their GPUs are on dead hardware), every
            elastic intent whose pod sat on the node is enqueued again, with
            a ``GPUNodeEvacuated`` Event (the reference's ``TPUNodeEvacuated``)
            and the ``tpumounter.io/disruption`` marker on the pod carrying
            the evacuation's trace id, and the interrupted migrations are
            re-driven. ``evacuate`` is also the manual path
            (POST /recovery/evacuate/<node>), which no suspension gates.

With the shards active a replica recovers only the nodes it owns. State is
in memory, as the reference's: a fresh replica confirms a death again within
one grace window, and every action of an evacuation is idempotent. The
health plane (``health/plane.py``) is told of an evacuation, which
supersedes its quarantine; its verdict is never evidence of death here.

``MasterApp`` hands it its elastic reconciler and its migration machine
(``elastic``, ``migrations``), as the reference's does; without them (None)
an evacuation re-drives nothing.
"""

from __future__ import annotations

import json
import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.errors import NotFoundError, classify_exception
from gpumounter_tpu_torch.k8s.events import post_pod_event
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.rpc.resilience import (
    BreakerOpenError,
    DeadlineExceededError,
    WorkerUnavailableError,
)
from gpumounter_tpu_torch.utils.fanout import get_core
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("recovery")

NODES_TRACKED = REGISTRY.gauge(
    "tpumounter_recovery_nodes_tracked",
    "Nodes the recovery controller is watching")
NODES_SUSPECT = REGISTRY.gauge(
    "tpumounter_recovery_nodes_suspect",
    "Nodes currently failing liveness but not yet confirmed dead")
NODES_EVACUATED = REGISTRY.counter(
    "tpumounter_nodes_evacuated_total",
    "Nodes evacuated after confirmed death")
EVACUATED_BOOKINGS = REGISTRY.counter(
    "tpumounter_evacuated_bookings_total",
    "Slave/warm pool pods released by evacuations")
EVACUATED_INTENTS = REGISTRY.counter(
    "tpumounter_evacuated_intents_total",
    "Elastic intents re-driven off dead nodes by evacuations")

#: the tenant's disruption marker (the tenant side, ``torchside``, reads it;
#: the two sides import nothing of each other)
ANNOT_DISRUPTION = "tpumounter.io/disruption"
#: the Event on each affected pod (the reference's is TPUNodeEvacuated)
EVACUATED_REASON = "GPUNodeEvacuated"


class RecoveryController:
    """One master replica's recovery loop. ``MasterApp`` builds it; the
    thread runs only after ``start()`` (``master/main.py``), and tests drive
    ``check_once`` and ``evacuate`` by hand."""

    #: how long an evacuated node whose worker never registered again stays
    #: in the /recovery table (the bounded history keeps the evacuation)
    EVACUATED_RETENTION_S = 600.0

    def __init__(self, kube, registry, client_factory, cfg=None, store=None, shards=None,
                 elastic=None, migrations=None, apihealth=None):
        self.cfg = cfg or Config()
        self.kube = kube
        #: ApiHealth: while it is not healthy, no automatic evacuation
        self.apihealth = apihealth
        self.registry = registry
        self.client_factory = client_factory
        self.store = store
        self.shards = shards
        self.elastic = elastic
        self.migrations = migrations
        #: the HealthPlane, set by MasterApp: told of each evacuation, and
        #: its quarantine flag shown in the payload; never death's evidence
        self.health = None
        self._lock = OrderedLock("recovery.state")
        #: node -> {"status": healthy | suspect | evacuated, "failures",
        #: "first_failure_at" (monotonic), "reason", "last_seen" (wall)}
        self._nodes: dict[str, dict] = {}
        #: the evacuations, newest last (at most 200)
        self._evacuations: list[dict] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle ---

    def start(self) -> "RecoveryController":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="recovery-controller",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.recovery_interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the loop must survive a pass
                logger.exception("recovery pass crashed")

    # --- detection ---

    def _sharded(self) -> bool:
        return self.shards is not None and self.shards.active()

    def check_once(self) -> dict:
        """One pass over every tracked node (the registry's and those already
        tracked); returns {"checked", "suspect", "evacuated": [...]}."""
        snapshot = self.registry.registry_snapshot()
        with self._lock:
            tracked = set(self._nodes) | set(snapshot)
        owned = []
        for node in sorted(tracked):
            if self._sharded() and not self.shards.owns_node(node):
                # the node's owner recovers it: state kept here would race
                # the owner's confirmation clock
                with self._lock:
                    self._nodes.pop(node, None)
                continue
            owned.append(node)
        verdicts: dict[str, tuple[bool, str]] = {}
        if owned:
            # getattr: a test's stub manager has active and owns_node only
            shard_of = getattr(self.shards, "owner_shard", None) if self._sharded() else None
            results = get_core(self.cfg).run(
                owned, lambda n: self._worker_alive(n, self._address(n, snapshot)),
                kind="recovery-probe", shard_of=shard_of)
            verdicts = dict(zip(owned, results))
        evacuated: list[str] = []
        suspect = 0
        for node in owned:
            state = self._check_node(node, snapshot, verdicts[node])
            if state == "suspect":
                suspect += 1
            elif state == "evacuate":
                self.evacuate(node, reason=self._reason(node))
                evacuated.append(node)
        self._prune_departed(snapshot)
        with self._lock:
            NODES_TRACKED.set(float(len(self._nodes)))
        NODES_SUSPECT.set(float(suspect))
        return {"checked": len(owned), "suspect": suspect, "evacuated": evacuated}

    def _address(self, node: str, snapshot: dict[str, str]) -> str | None:
        return f"{snapshot[node]}:{self.cfg.worker_port}" if node in snapshot else None

    def _prune_departed(self, snapshot: dict[str, str]) -> None:
        """Drop evacuated nodes whose worker has not registered again within
        EVACUATED_RETENTION_S; one that comes back re-enters as healthy."""
        now = time.monotonic()
        with self._lock:
            departed = [node for node, entry in self._nodes.items()
                        if entry.get("status") == "evacuated" and node not in snapshot
                        and now - entry.get("evacuated_at", now) > self.EVACUATED_RETENTION_S]
            for node in departed:
                del self._nodes[node]
        for node in departed:
            logger.info("evacuated node %s left the registry; tracking dropped (the history "
                        "keeps the evacuation)", node)

    def _reason(self, node: str) -> str:
        with self._lock:
            return self._nodes.get(node, {}).get("reason", "")

    def _check_node(self, node: str, snapshot: dict[str, str],
                    verdict: tuple[bool, str]) -> str:
        address = self._address(node, snapshot)
        alive, why = verdict
        now = time.monotonic()
        with self._lock:
            entry = self._nodes.setdefault(node, {"status": "healthy", "failures": 0,
                                                  "first_failure_at": None, "reason": ""})
            if entry["status"] == "evacuated":
                if alive:
                    # new hardware, or a network that flapped: watched again
                    logger.warning("evacuated node %s is alive again; tracking as healthy",
                                   node)
                    entry.update(status="healthy", failures=0, first_failure_at=None,
                                 reason="")
                entry["last_seen"] = time.time()
                return entry["status"]
            if alive:
                entry.update(status="healthy", failures=0, first_failure_at=None, reason="",
                             last_seen=time.time())
                return "healthy"
            entry["failures"] += 1
            if entry["first_failure_at"] is None:
                entry["first_failure_at"] = now
            entry["status"] = "suspect"
            entry["reason"] = why
            confirmed = (entry["failures"] >= self.cfg.recovery_confirm_failures
                         and now - entry["first_failure_at"] >= self.cfg.recovery_grace_s)
        if not confirmed:
            return "suspect"
        if self.apihealth is not None and not self.apihealth.ok():
            # never evacuate on stale evidence: the node may look dead only
            # because this master is cut off from the API
            with self._lock:
                self._nodes[node]["reason"] = (f"{why}; api {self.apihealth.state()} — "
                                               f"evacuation suspended until the API heals")
            logger.warning("node %s confirmed unresponsive but api is %s; evacuation "
                           "suspended (stale evidence)", node, self.apihealth.state())
            return "suspect"
        # the cluster's word before the point of no return: a Ready node, or
        # no Node view with the worker still registered, stays suspect
        ready = self._node_ready(node)
        worker_gone = address is None
        if ready is True:
            logger.info("node %s: worker unresponsive but Node is Ready; left to the worker's "
                        "restart and its ledger replay", node)
            return "suspect"
        if ready is None and not worker_gone:
            logger.info("node %s: worker unresponsive, no Node readiness and the worker still "
                        "registered; not enough evidence to evacuate", node)
            return "suspect"
        with self._lock:
            self._nodes[node]["reason"] = (f"{why}; node_ready={ready}, "
                                           f"worker_registered={not worker_gone}")
        return "evacuate"

    def _worker_alive(self, node: str, address: str | None) -> tuple[bool, str]:
        if address is None:
            return False, "no worker registered for node"
        breaker = getattr(self.registry, "breaker", None)
        if breaker is not None and breaker.state(address) == "open":
            return False, "worker circuit breaker open"
        try:
            with self.client_factory(address) as client:
                client.collect_telemetry(timeout_s=self.cfg.recovery_probe_timeout_s)
            return True, ""
        except (DeadlineExceededError, WorkerUnavailableError, BreakerOpenError) as exc:
            return False, f"liveness probe failed: {exc}"
        except Exception:  # noqa: BLE001 — any answer proves the process alive
            # UNIMPLEMENTED (a worker without the service), a refused token,
            # an application error: the process answered
            return True, ""

    def _node_ready(self, node: str) -> bool | None:
        """The Node's Ready condition; None when there is no Node to read
        (confirmation then rests on the worker being gone)."""
        node_obj = self.store.get_node(node) if self.store is not None else None
        if node_obj is None:
            return None
        for cond in node_obj.get("status", {}).get("conditions", []):
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        return None

    # --- evacuation ---

    def evacuate(self, node: str, reason: str = "manual") -> dict:
        """Evacuate one node (idempotent; also the manual route's). Returns
        the evacuation's record."""
        started = time.monotonic()
        with trace.span("recovery.evacuate", node=node):
            released = self._release_bookings(node)
            intents = self._redrive_intents(node)
            journals = self._redrive_migrations()
            # inside the span: the record carries the evacuation's trace id
            AUDIT.record("recovery.evacuate", actor="recovery-controller", namespace="", pod="",
                         outcome="evacuated", node=node, reason=reason,
                         released=len(released), intents=[f"{ns}/{p}" for ns, p in intents],
                         migrations=journals)
            FLIGHT.record("recovery",
                          f"node {node} evacuated ({reason}): {len(released)} booking(s) "
                          f"released, {len(intents)} intent(s) + {len(journals)} journal(s) "
                          f"re-driven", node=node, reason=reason)
        record = {
            "node": node,
            "reason": reason or "manual",
            "at": time.time(),
            "released_bookings": released,
            "redriven_intents": intents,
            "redriven_migrations": journals,
            "duration_s": round(time.monotonic() - started, 3),
        }
        with self._lock:
            entry = self._nodes.setdefault(node, {"failures": 0, "first_failure_at": None})
            entry["status"] = "evacuated"
            entry["reason"] = reason
            entry["evacuated_at"] = time.monotonic()
            self._evacuations.append(record)
            del self._evacuations[:-200]
        NODES_EVACUATED.inc()
        EVACUATED_BOOKINGS.inc(float(len(released)))
        EVACUATED_INTENTS.inc(float(len(intents)))
        if self.health is not None:
            # the hard verdict supersedes the quarantine: the plane retires
            # its record, and its release refuses the node
            try:
                self.health.note_evacuated(node)
            except Exception:  # noqa: BLE001 — advisory, across planes
                logger.exception("health note_evacuated failed")
        logger.warning("node %s EVACUATED (%s): released %d booking(s), re-drove %d intent(s) "
                       "+ %d migration journal(s)", node, reason, len(released), len(intents),
                       len(journals))
        return record

    def _release_bookings(self, node: str) -> list[str]:
        """Delete every pool pod on the dead node, slave pods and warm
        holders; a pod already gone is no error, so a replay frees nothing
        twice. A list that fails even from the store's cache defers the
        bookings (the next evacuation or the reaper releases them)."""
        try:
            pods = self.store.list_pool_pods(node) if self.store is not None else []
        except Exception as exc:  # noqa: BLE001 — never fail the record over the books
            logger.warning("pool pod list for %s failed during evacuation; bookings "
                           "deferred: %s", node, exc)
            pods = []
        released = []
        for pod_json in pods:
            name = Pod(pod_json).name
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, name, grace_period_seconds=0)
                released.append(name)
            except NotFoundError:
                pass
            except Exception as exc:  # noqa: BLE001 — keep releasing the rest
                logger.warning("evacuation delete of %s failed: %s", name,
                               classify_exception(exc))
        return released

    def _redrive_intents(self, node: str) -> list[tuple[str, str]]:
        """Every elastic intent whose pod sat on the dead node is enqueued
        again, with an Event and the disruption marker on the pod."""
        if self.elastic is None:
            return []
        try:
            intents = self.elastic.store.list()
        except Exception as exc:  # noqa: BLE001
            logger.warning("evacuation intent list failed: %s", exc)
            return []
        affected: list[tuple[str, str]] = []
        for namespace, pod_name, intent in intents:
            try:
                pod = Pod(self.kube.get_pod(namespace, pod_name))
            except Exception as exc:  # noqa: BLE001 — gone or unreadable: the next
                # pass, or the reconciler, takes it up
                logger.debug("evacuation intent read of %s/%s failed: %s", namespace, pod_name,
                             classify_exception(exc))
                continue
            if pod.node_name != node:
                continue
            affected.append((namespace, pod_name))
            self.elastic.enqueue(namespace, pod_name, priority=intent.priority)
            self._stamp_disruption(pod, node)
            post_pod_event(
                self.kube, pod, EVACUATED_REASON,
                f"node {node} confirmed dead and evacuated; this pod's chip intent "
                f"(desired={intent.desired_chips}) will re-converge once the pod is "
                f"rescheduled on a healthy node", event_type="Warning",
                component="tpumounter-recovery")
        return affected

    def _stamp_disruption(self, pod: Pod, node: str) -> None:
        """The seq-advancing disruption marker, with the evacuation's trace
        id, which the tenant's telemetry turns into an attributed downtime
        window; a failed stamp degrades that to an unattributed stall."""
        previous = {}
        try:
            previous = json.loads(pod.annotations.get(ANNOT_DISRUPTION, "{}"))
        except ValueError:
            pass
        marker = {
            "seq": int(previous.get("seq", 0)) + 1 if isinstance(previous, dict) else 1,
            "cause": "evacuation",
            "trace_id": trace.current_trace_id(),
            "node": node,
            "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        try:
            self.kube.patch_pod(pod.namespace, pod.name, {
                "metadata": {"annotations": {ANNOT_DISRUPTION: json.dumps(marker)}}})
        except Exception as exc:  # noqa: BLE001 — the marker is advisory
            logger.warning("disruption marker stamp on %s/%s failed: %s", pod.namespace,
                           pod.name, classify_exception(exc))

    def _redrive_migrations(self) -> list[str]:
        if self.migrations is None:
            return []
        try:
            return self.migrations.resume_interrupted()
        except Exception as exc:  # noqa: BLE001
            logger.warning("evacuation migration re-drive failed: %s", exc)
            return []

    # --- the /recovery payload ---

    def is_evacuated(self, node: str) -> bool:
        """Whether this controller evacuated `node` (and it has not come
        back alive since): the health plane's release refuses it."""
        with self._lock:
            entry = self._nodes.get(node)
            return bool(entry and entry.get("status") == "evacuated")

    def payload(self) -> dict:
        quarantined = self.health.excluded_hosts() if self.health is not None else frozenset()
        with self._lock:
            nodes = {node: {"status": entry.get("status", "healthy"),
                            "consecutiveFailures": entry.get("failures", 0),
                            "reason": entry.get("reason", ""),
                            # advisory: quarantined is not dead
                            "quarantined": node in quarantined}
                     for node, entry in sorted(self._nodes.items())}
            evacuations = list(self._evacuations)
        return {"nodes": nodes, "evacuations": evacuations,
                "config": {"intervalS": self.cfg.recovery_interval_s,
                           "confirmFailures": self.cfg.recovery_confirm_failures,
                           "graceS": self.cfg.recovery_grace_s}}
