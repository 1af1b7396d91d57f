"""The warm pool: pre-scheduled holder pods, adopted on mount.

The counterpart of ``gpumounter_tpu/allocator/pool.py``. A cold mount
creates its slave pods and waits for the scheduler to place them (the
original's allocator.go:40-96): on a quiet cluster that wait is most of the
mount. The pool pays for a little idle capacity to keep the scheduler off
the critical path: it keeps ``warm_pool_size`` single-GPU holder pods
Running a node (labels ``app=gpu-pool, tpumounter.io/warm=true``, no owner).
Adoption is a merge-patch that stamps the owner's labels and annotations and
drops the warm marker: a pod cannot be renamed, so ownership moves by label,
as the allocator's queries read it (``slave_pods_for``). Refills run on ONE
background thread, off the critical path; a drained pool falls back to the
cold create-and-wait.

  * adoption pops holders under the pool lock, so two mounts never adopt
    the same one;
  * a refill that never reaches Running is deleted before the node backs
    off: no holder is stranded. One the scheduler calls Unschedulable is
    deleted at once, where the reference waits out SLAVE_POD_TIMEOUT_S
    first; so the backoff (``warm_pool_retry_s``) doubles with each failed
    pass in a row, up to SLAVE_POD_TIMEOUT_S + ``warm_pool_retry_s``, the
    reference's period on a full node; a refill that lands resets it, and
    so does the worker's own release of slave pods (``capacity_freed``);
  * ``ensure_node`` re-adopts the Running holders a previous worker process
    left, and deletes the strays that never ran;
  * while ApiHealth is not ok a refill pass backs off without creating or
    deleting a pod: a create is doomed, and a holder it merely could not
    watch to Running is capacity the resync re-adopts after the outage;
  * warm holders carry no owner labels, so the slave reaper leaves them be.

``set_drained`` (a node quarantined by the master's health plane) releases a
node's holders and pauses its refills; its caller is the worker's
CollectTelemetry, whose request carries the master's verdict
(``worker/server.py``). The pool lists and patches pods through the
worker's kube client.

Failpoint ``pool.refill``: fired before each refill's pod create (ctx: node),
to show that a failing refill stays off the mount path.
"""

from __future__ import annotations

import secrets
import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.k8s.errors import NotFoundError, classify_exception
from gpumounter_tpu_torch.k8s.health import api_health
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("allocator.pool")

WARM_LABEL = "tpumounter.io/warm"
WARM_SELECTOR = f"app=gpu-pool,{WARM_LABEL}=true"

WARM_POOL_HITS = REGISTRY.counter(
    "tpumounter_warm_pool_hits_total",
    "Chips served by adopting a pre-scheduled warm holder pod")
WARM_POOL_MISSES = REGISTRY.counter(
    "tpumounter_warm_pool_misses_total",
    "Chips that fell back to the cold create-and-wait slave-pod path")
WARM_POOL_READY = REGISTRY.gauge(
    "tpumounter_warm_pool_ready",
    "Warm holder pods Running and adoptable, by node")
WARM_POOL_REFILLS = REGISTRY.counter(
    "tpumounter_warm_pool_refills_total",
    "Warm holder pods successfully refilled into the pool")
WARM_POOL_REFILL_FAILURES = REGISTRY.counter(
    "tpumounter_warm_pool_refill_failures_total",
    "Refill attempts that failed (pod deleted, node backed off)")
WARM_POOL_DRAINED = REGISTRY.counter(
    "tpumounter_warm_pool_drained_total",
    "Warm holder pods released because the master's health plane "
    "quarantined the node (CollectTelemetry carries the verdict)")


def _running_or_unschedulable(pod_json) -> bool:
    """The refill's wait ends at Running, or at the scheduler's Unschedulable
    verdict: a full node's holder is deleted and the node backed off at once,
    as the allocator's cold wait fails fast, where the reference waits out
    the whole SLAVE_POD_TIMEOUT_S (120 s by default) on the refill thread."""
    if pod_json is None:
        return False
    pod = Pod(pod_json)
    return pod.phase == "Running" or pod.unschedulable_reason() is not None


class WarmPodPool:
    def __init__(self, kube: KubeClient, cfg=None,
                 refill_async: bool = True, apihealth=None):
        """refill_async=False disables the background refiller entirely:
        nothing refills unless the caller invokes refill_once() —
        deterministic mode for tests that must not race a thread. The
        daemons use the default background refiller, which keeps refills
        off the mount critical path.

        apihealth: the ApiHealth verdict (k8s/health.py; defaults to
        the process-global endpoint machine). While the API is
        degraded/down, refill passes back off WITHOUT creating or
        deleting pods: a refill create is doomed, and deleting a
        holder we merely could not watch to Running would throw away
        capacity the resync would have re-adopted after the outage."""
        self.kube = kube
        self.cfg = cfg or Config()
        self.apihealth = apihealth if apihealth is not None else api_health(cfg=self.cfg)
        self.size = max(0, int(self.cfg.warm_pool_size))
        self.refill_async = refill_async
        self._lock = OrderedLock("pool.ready")
        self._ready: dict[str, list[str]] = {}     # node -> holder names
        self._pending: dict[str, int] = {}         # node -> creates in flight
        self._backoff_until: dict[str, float] = {}  # node -> monotonic stamp
        self._failures: dict[str, int] = {}        # node -> failed passes in a row
        self._drained: set[str] = set()            # health-plane quarantine
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.enabled and self.cfg.node_name:
            self.ensure_node(self.cfg.node_name)

    @property
    def enabled(self) -> bool:
        return self.size > 0

    # --- lifecycle ---

    def stop(self) -> None:
        """Stop the refiller. Warm pods are left Running on purpose: a
        restarted worker re-adopts them via ensure_node's resync."""
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)

    def _kick(self) -> None:
        if not self.enabled or self._stop.is_set():
            return
        if not self.refill_async:
            return  # deterministic mode: tests call refill_once()
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._refill_loop, name="warm-pool-refill",
                    daemon=True)
                self._thread.start()
        self._wake.set()

    # --- registration / resync ---

    def ensure_node(self, node_name: str) -> None:
        """Register a node with the pool (idempotent). First sight of a
        node resyncs from the API server: Running warm pods from a
        previous worker process are re-adopted into the ready list,
        non-Running strays (a refill that died mid-wait) are deleted."""
        if not self.enabled or not node_name:
            return
        with self._lock:
            if node_name in self._ready:
                return
            self._ready[node_name] = []
            self._pending.setdefault(node_name, 0)
        # The per-node ready gauge exists from registration on, not
        # from the first refill: an empty pool and an unregistered node
        # must be distinguishable on /metrics.
        WARM_POOL_READY.set(0.0, node=node_name)
        self._resync(node_name)
        self._kick()

    def _resync(self, node_name: str) -> None:
        try:
            pods = self.kube.list_pods(self.cfg.pool_namespace,
                                       label_selector=WARM_SELECTOR)
        except Exception as exc:  # noqa: BLE001 — resync is best-effort
            logger.warning("warm-pool resync list failed: %s", exc)
            return
        readopted, strays = [], []
        for pod_json in pods:
            p = Pod(pod_json)
            # Membership is by placement AND by target: an unscheduled
            # holder belongs to the node its manifest pins (another
            # worker's refill mid-wait must not be reaped as a stray
            # just because its nodeName is still empty).
            selector = (pod_json.get("spec", {}).get("nodeSelector")
                        or {}).get("kubernetes.io/hostname", "")
            if p.node_name:
                if p.node_name != node_name:
                    continue
            elif selector != node_name:
                continue
            if p.phase == "Running":
                readopted.append(p.name)
            else:
                strays.append(p.name)
        for name in strays:
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, name,
                                     grace_period_seconds=0)
                logger.info("warm-pool: deleted stray holder %s "
                            "(phase never reached Running)", name)
            except Exception as exc:  # noqa: BLE001
                logger.warning("warm-pool stray delete %s failed: %s",
                               name, exc)
        if readopted:
            with self._lock:
                bucket = self._ready.setdefault(node_name, [])
                bucket.extend(n for n in readopted if n not in bucket)
                WARM_POOL_READY.set(float(len(bucket)), node=node_name)
            logger.info("warm-pool: re-adopted %d Running holder(s) on %s",
                        len(readopted), node_name)

    # --- adoption (the mount critical path) ---

    def set_drained(self, node_name: str, flag: bool) -> int:
        """Health-plane quarantine drain (the verdict rides the
        master's CollectTelemetry pull — worker/server.py). While
        drained a node's refill is paused and its Running holders are
        deleted: a quarantined node must not bank standby capacity, and
        pre-scheduled holders there would defeat the whole point of the
        placement exclusion. Reversible — un-draining just lets the
        next refill pass restock. Returns holders released this call."""
        if not self.enabled or not node_name:
            return 0
        with self._lock:
            if flag:
                self._drained.add(node_name)
                names = list(self._ready.get(node_name, []))
            else:
                self._drained.discard(node_name)
                names = []
        gone: list[str] = []
        for name in names:
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, name,
                                     grace_period_seconds=0)
                gone.append(name)
            except NotFoundError:
                gone.append(name)  # already gone: drained is drained
            except Exception as exc:  # noqa: BLE001 — retried next pull
                logger.warning("warm-pool drain delete %s failed: %s",
                               name, classify_exception(exc))
        released = len(gone)
        if names:
            with self._lock:
                bucket = self._ready.get(node_name, [])
                self._ready[node_name] = [n for n in bucket
                                          if n not in gone]
                WARM_POOL_READY.set(
                    float(len(self._ready[node_name])), node=node_name)
            if released:
                WARM_POOL_DRAINED.inc(released)
                logger.warning(
                    "warm-pool: drained %d holder(s) on quarantined "
                    "node %s", released, node_name)
        if not flag:
            self._kick()  # restock promptly after release
        return released

    def capacity_freed(self) -> None:
        """The worker deleted slave pods of its node, so a GPU is free there:
        the backoff a full node earned ends, and a refill pass runs. (GPUs
        that other pods free are found when the backoff runs out.)"""
        if not self.enabled:
            return
        with self._lock:
            self._failures.clear()
            self._backoff_until.clear()
        self._kick()

    def drained(self, node_name: str) -> bool:
        with self._lock:
            return node_name in self._drained

    def ready_count(self, node_name: str) -> int:
        with self._lock:
            return len(self._ready.get(node_name, []))

    def ready_names(self, node_name: str) -> list[str]:
        """The adoptable holder pods on a node (their booked GPUs are warm,
        reclaimable, not held)."""
        with self._lock:
            return list(self._ready.get(node_name, []))

    def wait_ready(self, node_name: str, count: int | None = None,
                   timeout_s: float = 10.0) -> bool:
        """Block until `count` (default: pool size) holders are ready on
        the node. Test/bench helper — production callers never wait on
        the pool; they fall through to the cold path."""
        want = self.size if count is None else count
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready_count(node_name) >= want:
                return True
            self._wake.set()
            time.sleep(0.02)
        return self.ready_count(node_name) >= want

    def acquire(self, owner: Pod, count: int) -> list[str]:
        """Adopt up to `count` warm holders on the owner's node; returns
        the adopted (now owner-labeled) slave-pod names. Never blocks on
        the scheduler: whatever is not ready is the caller's cold-path
        remainder (recorded as misses)."""
        if not self.enabled or count <= 0:
            return []
        node = owner.node_name
        self.ensure_node(node)
        adopted: list[str] = []
        while len(adopted) < count:
            # One adopt pass per node: the whole remaining want is popped
            # under a single lock hold, so a storm of concurrent mounts
            # on one node serializes on the lock once per batch instead
            # of once per holder (the bulk-mount path's common case).
            with self._lock:
                bucket = self._ready.get(node, [])
                batch = bucket[:count - len(adopted)]
                del bucket[:len(batch)]
                if batch:
                    WARM_POOL_READY.set(float(len(bucket)), node=node)
            if not batch:
                break
            for name in batch:
                if self._adopt(name, owner):
                    adopted.append(name)
        if adopted:
            WARM_POOL_HITS.inc(float(len(adopted)))
            logger.info("warm-pool: adopted %d holder(s) for %s/%s: %s",
                        len(adopted), owner.namespace, owner.name, adopted)
        missed = count - len(adopted)
        if missed:
            WARM_POOL_MISSES.inc(float(missed))
        self._kick()  # replace what we consumed, off the critical path
        return adopted

    def _adopt(self, name: str, owner: Pod) -> bool:
        """Stamp ownership on one pooled holder. The pod was popped from
        the ready list under the lock, so no concurrent mount can reach
        it; the patch is the durable half of the handoff."""
        patch = {"metadata": {
            "labels": {WARM_LABEL: None,
                       "tpumounter.io/owner-uid": owner.uid,
                       "tpumounter.io/owner": owner.name[:63],
                       "tpumounter.io/owner-namespace": owner.namespace[:63]},
            "annotations": {"tpumounter.io/owner": owner.name,
                            "tpumounter.io/owner-namespace": owner.namespace},
        }}
        try:
            patched = Pod(self.kube.patch_pod(self.cfg.pool_namespace,
                                              name, patch))
        except NotFoundError:
            logger.warning("warm holder %s vanished before adoption", name)
            return False
        except Exception as exc:  # noqa: BLE001 — adoption is best-effort
            # The holder is already popped from the ready list; leaving
            # it Running-but-untracked would book a GPU forever (the
            # reaper skips ownerless pods). Delete it — the refiller
            # replaces it — and fall through to the cold path.
            logger.warning("warm holder %s adoption patch failed (%s); "
                           "deleting it to free its GPU", name, exc)
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, name,
                                     grace_period_seconds=0)
            except Exception as del_exc:  # noqa: BLE001
                logger.error("stranded warm holder %s could not be "
                             "deleted (%s); it books a GPU until the "
                             "next resync", name, del_exc)
            return False
        if patched.phase != "Running":
            # Died while pooled: delete so its booking frees; the refill
            # replaces it.
            logger.warning("warm holder %s no longer Running (%s); "
                           "discarding", name, patched.phase)
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, name,
                                     grace_period_seconds=0)
            except Exception:  # noqa: BLE001
                pass
            return False
        return True

    # --- refill (background; never on the mount path) ---

    def _warm_manifest(self, node_name: str) -> dict:
        from gpumounter_tpu_torch.allocator.allocator import base_slave_manifest
        return base_slave_manifest(
            self.cfg, f"warm-slave-{secrets.token_hex(4)}", node_name,
            gpu_num=1, labels={"app": "gpu-pool", WARM_LABEL: "true"})

    def _refill_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.refill_once()
            except Exception as exc:  # noqa: BLE001 — keep the loop alive
                logger.warning("warm-pool refill pass failed: %s", exc)

    def refill_once(self) -> int:
        """One refill pass over every registered node; returns holders
        added. Public so tests and the sync mode can drive it."""
        if not self.apihealth.ok():
            # Degraded-mode policy: back off the whole pass. No
            # creates (doomed), and critically no failed-wait DELETES —
            # the pool must not shrink standing capacity because the
            # API went away.
            logger.info("warm-pool refill pass skipped: api %s",
                        self.apihealth.state())
            return 0
        added = 0
        with self._lock:
            nodes = list(self._ready)
        for node in nodes:
            with self._lock:
                if node in self._drained:
                    continue  # quarantined: no standby capacity here
                if time.monotonic() < self._backoff_until.get(node, 0.0):
                    continue
                gap = (self.size - len(self._ready.get(node, []))
                       - self._pending.get(node, 0))
                if gap <= 0:
                    continue
                self._pending[node] = self._pending.get(node, 0) + gap
            try:
                added += self._refill_node(node, gap)
            finally:
                with self._lock:
                    self._pending[node] = max(
                        0, self._pending.get(node, 0) - gap)
        return added

    def _refill_node(self, node: str, gap: int) -> int:
        """Create `gap` holders, then wait for Running concurrently (the
        creates already schedule concurrently). Any holder that fails to
        reach Running is deleted — never stranded — and the node backs
        off so a full node is not hammered with doomed creates."""
        created: list[str] = []
        failed = False
        for _ in range(gap):
            try:
                failpoints.fire("pool.refill", node=node)
                pod = self.kube.create_pod(self.cfg.pool_namespace,
                                           self._warm_manifest(node))
                created.append(Pod(pod).name)
            except Exception as exc:  # noqa: BLE001 — refill is best-effort
                logger.warning("warm-pool refill create on %s failed: %s",
                               node, exc)
                WARM_POOL_REFILL_FAILURES.inc()
                failed = True
                break
        if not created:
            self._backoff(node)
            return 0
        # Sequential waits under ONE shared deadline: the creates above
        # already schedule concurrently, so once the first holder is
        # Running the rest usually answer instantly — no thread-per-wait
        # churn (and no per-thread keep-alive TLS connection abandoned
        # at thread death).
        outcomes: dict[str, bool] = {}
        deadline = time.monotonic() + self.cfg.slave_pod_timeout_s
        for name in created:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                outcomes[name] = False
                continue
            try:
                result = self.kube.wait_for_pod(
                    self.cfg.pool_namespace, name, _running_or_unschedulable,
                    timeout_s=remaining)
                outcomes[name] = result is not None and Pod(result).phase == "Running"
            except Exception:  # noqa: BLE001
                outcomes[name] = False
        added = 0
        for name in created:
            if outcomes.get(name):
                with self._lock:
                    bucket = self._ready.setdefault(node, [])
                    bucket.append(name)
                    WARM_POOL_READY.set(float(len(bucket)), node=node)
                WARM_POOL_REFILLS.inc()
                added += 1
            elif not self.apihealth.ok():
                # The wait failed because the API died mid-refill, not
                # because the pod is doomed: leave it alone (the
                # post-outage resync re-adopts it if it reached
                # Running, and deletes it as a stray if it never did)
                # and back the node off.
                logger.info("warm-pool: leaving %s in place (api %s); "
                            "resync will adopt or reap it after the "
                            "outage", name, self.apihealth.state())
                WARM_POOL_REFILL_FAILURES.inc()
                failed = True
            else:
                WARM_POOL_REFILL_FAILURES.inc()
                try:
                    self.kube.delete_pod(self.cfg.pool_namespace, name,
                                         grace_period_seconds=0)
                except Exception as exc:  # noqa: BLE001
                    logger.warning("warm-pool cleanup of %s failed "
                                   "(reaper-invisible; retried next "
                                   "resync): %s", name, exc)
                failed = True
        if added:
            logger.info("warm-pool: refilled %d holder(s) on %s",
                        added, node)
            with self._lock:
                self._failures.pop(node, None)
        if failed:
            self._backoff(node)
        return added

    def _backoff(self, node: str) -> None:
        """Back the node off warm_pool_retry_s, doubled for each failed pass
        before it in a row, up to SLAVE_POD_TIMEOUT_S + warm_pool_retry_s:
        a full node's holder is refused at once, and without the growth the
        node would see a create every warm_pool_retry_s."""
        retry = self.cfg.warm_pool_retry_s
        with self._lock:
            failures = self._failures.get(node, 0)
            self._failures[node] = failures + 1
            delay = min(retry * 2.0 ** min(failures, 32),
                        max(retry, self.cfg.slave_pod_timeout_s + retry))
            self._backoff_until[node] = time.monotonic() + delay
