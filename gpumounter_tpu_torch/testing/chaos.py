"""Seeded chaos over the fake cluster: the port's base harness.

The counterpart of ``gpumounter_tpu/testing/chaos.py``'s ``ChaosHarness``
for the packages the port has. It runs the real control plane (``MasterApp``
with its slice coordinator, elastic reconciler and migration machine, over
real gRPC to one worker server a node on localhost) on a two-node
``testing/cluster.py`` fleet, under a failpoint schedule drawn from one
seed, then checks the global invariants:

  1. no GPU held by two pods (no node of one GPU in two pods' /dev),
  2. no ownerless grant (every injected node is backed by a booking of the
     scheduler: a node without one is a leaked mount),
  3. books against mounts (every GPU booked to a pod is mounted in it),
  4. every migration's journal is terminal: succeeded, rolled-back or
     aborted, with phase done (never stranded, never half rolled back),
  5. no open span: every span entered was exited, through injected
     failures too,
  6. every terminal migration has its ``migrate`` audit record (a machine
     adopted after a crash too), and every audit record an outcome and a
     trace id,
 7. the channel pool's books: every channel dialed is live or closed, and
     no more are live than there are workers,
  8. the fleet rollup counts no node twice: two fresh ``FleetCollector``s
     (the second a restarted collector) agree with the workers, node for
     node, and each one's total is its nodes' sum,
 10. ledger agreement (``run_worker_crash_scenario``): after a worker death
     at any seeded site of a mount batch, a restart and the ledger's replay
     (``worker/resync.py``), books == mounts == ledger on every node: no
     open txn, and each pod's net holdings equal its injected nodes and its
     bookings,
 11. a node's death (``run_node_kill_scenario``): a node tracked while
     alive and then killed (server gone, worker pod gone, Node NotReady) is
     confirmed and evacuated by the recovery controller within the
     deadline, none of its pool pods is left, and every intent stranded on
     it converges on a healthy node once its pod is rescheduled there,
 13. the tenants' disruption (armed by ``attach_tenant``): after a terminal
     migration, heal or evacuation no fake tenant's window is open, and
     every window of a signalled cause carries the control plane's trace
     id, which resolves in the ring,
 14. the API server's outage (``run_api_outage_scenario``, in the flavors
     mount, migrate, heal and recovery): in the partition no destructive
     mutation lands from stale reads and no booking leaks; after the heal
     every deferred write lands once (the newest wins) and books == mounts
     == ledger == intents; with the replay disabled (the negative control)
     the divergence is named,
 15. lock order: the nested ``OrderedLock`` / ``OrderedCondition``
     acquisitions the whole run observed form no cycle,
 16. trace assembly: every clean operation of the mount scenario (no fault
     armed, no exception), run under a ``chaos.<op>`` root span, assembles
     complete (``obs/assembly.py``: no orphan, no rpc span without its
     worker half) and its phases sum to its wall time within max(2 ms, 5%);
     ``drop_worker_spans`` is its negative control,
 17. the capacity plane's agreement: after every scenario the ``capacity``
     section of each live node's CollectTelemetry (invariant 8's first
     pass) equals the fake scheduler's ground truth: free GPUs, held and
     warm together, fenced (dead) ones, by index; ``withhold_unmount`` (a
     held GPU's kubelet claim erased, its booking kept, as a lost unmount
     leaves it) is its negative control,
 19. the shares' agreement (``run_share_scenario``): the master's share
     books == the policy entries (the userspace engine, the fake backends'
     kernel map) == the worker ledger's share records, GPU for GPU and
     value for value, and a metered share driven past its budget is
     throttled alike by the engine and by the interpreter running the real
     device program; ``disable_enforcement`` (the engine a bookkeeper) is
     its negative control,
 20. gray-failure attribution (``run_gray_scenario``): every automatic
     quarantine of the health plane is a flight record with at least one
     concrete signal, no node outside the degraded set is ever quarantined,
     and every degraded node ends quarantined; a disabled scorer
     (``disable_scorer=True``, the negative control) reads as a missed
     detection,
 22. watch-store parity (``run_watch_store_scenario``): after a severed
     watch with a storm past the backlog (a 410), a restart and steady
     churn, the ``WatchMasterStore``'s indexes equal a fresh list-backed
     view of the same cluster.

Two more run on their own, not on the harness: ``run_fencing_scenario``
(invariant 12, no stale-epoch write applied) and ``run_shard_scenario``
(invariant 9, one owner a shard). The reference's invariants 18 and 21 come
with their packages. A killed node (``kill_node``) is out of the books'
reach: invariants 1-3, 8, 10, 17 and 19 skip it and its pods.

The scenarios: ``run_mount_scenario`` (adds, removes and reconciles of pods
with declared intents), ``run_worker_crash_scenario`` (worker deaths in
mount batches), ``run_elastic_scenario`` (GPU deaths healed by the
reconciler under ``FAULTS_ELASTIC``), ``run_migrate_scenario`` (migrations
crashed at their phase boundaries, ``FAULTS_MIGRATE``, driven to their end by
``resume_interrupted``), ``run_node_kill_scenario``, ``run_gray_scenario``,
``run_watch_store_scenario``, ``run_api_outage_scenario`` and
``run_share_scenario`` (fractional mounts, re-grants, releases and worker
deaths of two complementary tenants). ``TenantSim``
is the reference's fake tenant on the port's ``torchside`` watchers and
telemetry.

Every node's worker keeps its ledger in a directory of the run; building a
second service over it is the worker's restart (``restart_worker``). Every
fault is a count-limited one-shot armed just before its operation and
disarmed right after it, so none leaks into the check. The pools are the
reference's ``FAULTS_COMMON``, ``FAULTS_ELASTIC`` and ``FAULTS_MIGRATE``.
``converge`` is the reference's: every migration driven to its end (the
interrupted ones adopted again, as a restarted master does), then every
intent reconciled until it converges (what a simulated death left, grants
or slave pods, a heal removes), then the slave pods' releases waited for.

All randomness comes from ``random.Random(seed)``; the schedule is logged
step by step and an ``InvariantViolation`` carries the seed and the
schedule, so a failing run replays from its seed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time

from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE, interpret_device_program
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.elastic.intents import Intent
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s import health as k8s_health
from gpumounter_tpu_torch.k8s.client import NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.app import MasterApp
from gpumounter_tpu_torch.master.slice_ops import SliceCoordinator, SliceTarget
from gpumounter_tpu_torch.nsutil.ns import device_node_path
from gpumounter_tpu_torch.obs import assembly, trace
from gpumounter_tpu_torch.obs.assembly import REMOTE_SPANS
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.obs.fleet import FleetCollector
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.rpc.api import AddGPUResult
from gpumounter_tpu_torch.rpc.client import ChannelPool, WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster, WorkerServers
from gpumounter_tpu_torch.utils import locks
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.vchip import Share
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget
from gpumounter_tpu_torch.worker.server import GpuMountService

logger = get_logger("testing.chaos")

NODE_A, NODE_B = "chaos-a", "chaos-b"

#: (failpoint, action) pairs the scenario draws from: the reference's
#: FAULTS_COMMON. All count-limited, so an armed fault that did not fire
#: cannot outlive its operation.
FAULTS_COMMON = [
    ("rpc.client.call", "1*unavailable(chaos drop)"),
    ("rpc.client.call", "1*delay(0.05)"),
    ("worker.rpc", "1*delay(0.05)"),
    ("worker.mount.mknod", "1*error(chaos mknod)"),
    ("worker.mount.mknod", "1*pass->1*error(chaos mknod 2nd)"),
    ("worker.mount.before_grant", "1*crash(chaos)"),
    ("worker.mount.after_grant", "1*crash(chaos)"),
    ("worker.unmount.before_revoke", "1*error(chaos revoke)"),
    ("k8s.patch_pod.status", "1*return(409)"),
    ("k8s.patch_pod.status", "1*return(500)"),
]


FAULTS_ELASTIC = FAULTS_COMMON + [
    ("elastic.reconcile", "1*crash(chaos)"),
    ("elastic.before_grow", "1*crash(chaos)"),
]
FAULTS_MIGRATE = FAULTS_COMMON + [
    ("migrate.phase.quiesce", "1*crash(chaos)"),
    ("migrate.phase.checkpoint", "1*crash(chaos)"),
    ("migrate.phase.drain", "1*crash(chaos)"),
    ("migrate.phase.remount", "1*crash(chaos)"),
    ("migrate.phase.resume", "1*crash(chaos)"),
    ("migrate.phase.verify", "1*crash(chaos)"),
    ("migrate.persist", "1*error(chaos persist)"),
]


class InvariantViolation(AssertionError):
    """A global invariant did not hold after the scenario."""


class TenantSim:
    """A fake tenant over the fake cluster (the reference's ``TenantSim``):
    a paced step loop and the port's real watchers
    (``torchside.watch_migration``, ``watch_chip_replacements``,
    ``watch_disruptions``) driving its real ``TenantTelemetry``, so the
    harness measures the code a tenant runs.

    The loop pauses on the quiesce signal (its state packed) and resumes on
    the resume signal (restored), so a migration's downtime is a gap it
    measured. `extra_pods` are watched too: a tenant spans both ends of a
    move."""

    def __init__(self, kube, namespace: str, pod: str, extra_pods: tuple = (),
                 step_s: float = 0.004, publish_url: str | None = None,
                 token: str | None = None):
        from gpumounter_tpu_torch.torchside.heal import watch_chip_replacements
        from gpumounter_tpu_torch.torchside.migrate import watch_migration
        from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry, watch_disruptions
        self.kube = kube
        self.namespace = namespace
        self.pod = pod
        # stalls seen at half a second, the minute's books rolled every 2 s,
        # so that short runs count them
        self.telemetry = TenantTelemetry(tenant=f"{namespace}/{pod}", namespace=namespace,
                                         pod=pod, publish_url=publish_url, token=token,
                                         stall_min_s=0.5, minute_s=2.0)
        self._step_s = step_s
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._threads: list[threading.Thread] = []

        def _stepper() -> None:
            while not self._stop.is_set():
                if self._pause.is_set():
                    self._stop.wait(0.002)
                    continue
                with self.telemetry.step(tokens=256.0, queue_depth=1.0):
                    self._stop.wait(self._step_s)

        def _on_quiesce(signal: dict) -> None:
            self._pause.set()      # HotResumable.pack's stand-in
            time.sleep(0.005)

        def _on_checkpoint(signal: dict) -> None:
            time.sleep(0.002)      # the host-side save's stand-in

        def _on_resume(signal: dict) -> None:
            # warm: copy the packed host buffers; cold: rebuild the state
            time.sleep(0.005 if signal.get("checkpointed") else 0.08)
            self._pause.clear()

        def _on_heal(marker: dict) -> None:
            self._pause.set()      # the repack and restore block the loop
            time.sleep(0.005)
            self._pause.clear()

        def _spawn(target, *args, **kwargs) -> None:
            thread = threading.Thread(target=target, args=args, kwargs=kwargs, daemon=True)
            self._threads.append(thread)
            thread.start()

        _spawn(_stepper)
        for ns, name in [(namespace, pod)] + [tuple(p) for p in extra_pods]:
            _spawn(watch_migration, kube, ns, name,
                   self.telemetry.migration_quiesce(_on_quiesce),
                   on_resume=self.telemetry.migration_resume(_on_resume), stop=self._stop,
                   watch_timeout_s=1.0, on_checkpoint=_on_checkpoint)
            _spawn(watch_chip_replacements, kube, ns, name, self.telemetry.heal(_on_heal),
                   stop=self._stop, watch_timeout_s=1.0)
            _spawn(watch_disruptions, kube, ns, name, self.telemetry.external_disruption,
                   stop=self._stop, watch_timeout_s=1.0)

    def settle(self, timeout_s: float = 5.0) -> None:
        """Until no disruption window is open (the step loop closes them),
        or the deadline."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.telemetry.snapshot()["disruption"]["open"]:
                return
            time.sleep(0.02)

    def stop(self) -> None:
        self._stop.set()
        self._pause.clear()
        for thread in self._threads:
            thread.join(timeout=3.0)


class _PodDirMounter(GpuMounter):
    """A mounter whose target pod is a directory of its own under `root`."""

    def __init__(self, backend, root: str, cfg=None, kube=None):
        super().__init__(backend, cfg=cfg, kube=kube)
        self.root = root

    def resolve_target(self, pod: Pod) -> MountTarget:
        dev_dir = os.path.join(self.root, f"{pod.namespace}-{pod.name}")
        os.makedirs(dev_dir, exist_ok=True)
        return MountTarget(dev_dir=dev_dir, description=f"{pod.namespace}/{pod.name}", pod=pod)


class ChaosHarness:
    """One fake two-node cluster and a live control plane, per run."""

    def __init__(self, root: str, seed: int, nodes: dict[str, int] | None = None):
        self.root = root
        self.seed = seed
        self.rng = random.Random(seed)
        self.schedule: list[str] = []
        self.cluster = FakeCluster.with_fake_gpus(os.path.join(root, "cluster"),
                                                  nodes=nodes or {NODE_A: 6, NODE_B: 6})
        # quick retries; a high breaker threshold, since chaos drops calls on
        # purpose and the breaker has tests of its own; a recovery that
        # confirms a death in two passes with no grace; the health plane off
        # (every node runs in this one process, whose registry folds all
        # the nodes' mounts together: run_gray_scenario turns it on over
        # entries it measures itself)
        # the migration's acks and the reconciler's backoff at test speed; an
        # ApiHealth that is degraded after 2 outage-shaped failures and down
        # after 50 ms of them, its deferred writes in a queue under the run's
        # root (invariant 14 reads it across the heal)
        self.cfg = dataclasses.replace(
            self.cluster.cfg, rpc_retry_base_s=0.02, rpc_retry_cap_s=0.1,
            breaker_failure_threshold=50, recovery_confirm_failures=2, recovery_grace_s=0.0,
            recovery_probe_timeout_s=2.0, health_enabled=False,
            migrate_quiesce_timeout_s=0.3, migrate_checkpoint_timeout_s=0.3,
            migrate_resume_timeout_s=0.3, migrate_poll_interval_s=0.02,
            elastic_resync_interval_s=30.0, elastic_backoff_base_s=0.05,
            elastic_backoff_cap_s=0.2, elastic_min_reconcile_interval_s=0.0,
            rpc_probe_timeout_s=5.0, rpc_quiesce_timeout_s=5.0, k8s_write_retry_base_s=0.02,
            api_health_degraded_failures=2, api_health_down_after_s=0.05,
            api_health_recovery_successes=2, writebehind_dir=os.path.join(root, "writebehind"))
        self.workers = WorkerServers(self._build_node_service, host="localhost")
        self.services: dict[str, GpuMountService] = self.workers.services
        self.channel_pool = ChannelPool(cfg=self.cfg)
        #: (namespace, pod) -> node, for every target pod made
        self.pods: dict[tuple[str, str], str] = {}
        self.app: MasterApp | None = None
        #: run_worker_crash_scenario sets it: check_invariants then holds
        #: invariant 10 too
        self.check_ledgers = False
        #: nodes killed by kill_node (the books' checks skip them)
        self.dead_nodes: set[str] = set()
        #: (namespace, pod) -> TenantSim: fake tenants on the port's real
        #: telemetry; any arms invariant 13
        self.tenant_sims: dict[tuple[str, str], TenantSim] = {}
        #: run_gray_scenario sets them: check_invariants then holds invariant
        #: 20 over the nodes it degraded
        self.gray_armed = False
        self.gray_nodes: set[str] = set()
        #: the clean operations run under a chaos.<op> root span, each
        #: {"trace", "span", "op"}: invariant 16 assembles every one
        self.traced_ops: list[dict] = []
        #: run_share_scenario sets it: check_invariants then holds invariant
        #: 19 too
        self.vchip_armed = False
        #: run_watch_store_scenario sets it: check_invariants then holds
        #: invariant 22 too
        self.watchstore_armed = False
        self.watch_store = None
        self._watch_cfg = None
        self._ws_serial = 0
        self._ws_default: list[str] = []
        self._ws_pool: dict[str, str] = {}

    # --- lifecycle ---

    def _dev_root(self, node: str) -> str:
        return os.path.join(self.root, f"container-dev-{node}")

    def _build_node_service(self, name: str) -> GpuMountService:
        """A node's worker: collector, mounter and a ledger in a directory of
        the run (a second service over it is the worker's restart)."""
        node = self.cluster.node(name)
        cfg = dataclasses.replace(self.cfg,
                                  ledger_dir=os.path.join(self.root, f"ledger-{name}"))
        collector = GpuCollector(node.backend, node.kubelet, cfg=cfg)
        mounter = _PodDirMounter(node.backend, self._dev_root(name), cfg=cfg,
                                 kube=self.cluster.kube)
        return GpuMountService(self.cluster.kube, collector, mounter=mounter, cfg=cfg)

    def start(self) -> "ChaosHarness":
        # this run's spans, records, timeline, policies and API verdicts only
        k8s_health.reset_all()
        trace.TRACER.reset()
        REMOTE_SPANS.reset()
        AUDIT.reset()
        FLIGHT.reset()
        # an empty engine that enforces: a negative control's bookkeeper
        # (disable_enforcement) must not outlive its run
        POLICY_ENGINE.reset()
        POLICY_ENGINE.enforce = True
        for i, name in enumerate(self.cluster.node_names):
            self.workers.start(name, f"10.9.0.{i + 1}")
            self.cluster.register_worker(self.workers.ip_by_node[name], node=name)

        def client_factory(address: str) -> WorkerClient:
            return WorkerClient(self.workers.local_address(address), cfg=self.cfg,
                                channel_pool=self.channel_pool)

        self.app = MasterApp(self.cluster.kube, cfg=self.cfg,
                             worker_client_factory=client_factory)
        return self

    def restart_worker(self, name: str) -> dict:
        """A worker's death and restart on one node: its policy scopes
        dropped (a new process starts with an empty engine), then
        ``WorkerServers.restart``. Returns the replay's summary."""
        for (namespace, pod_name), node in self.pods.items():
            if node == name:
                POLICY_ENGINE.drop_scope(f"{namespace}/{pod_name}")
        summary, _ = self.workers.restart(name, self.channel_pool)
        self.record(f"restart worker {name}: replay {summary}")
        return summary

    def kill_node(self, name: str) -> None:
        """A node's death as the control plane sees it
        (``WorkerServers.kill``), kept out of the invariants' live nodes."""
        self.workers.kill(name, self.cluster.kube, self.cfg, [self.channel_pool])
        self.dead_nodes.add(name)
        self.record(f"kill node {name}")

    def attach_tenant(self, namespace: str, pod: str, extra_pods: tuple = (),
                      publish_url: str | None = None, token: str | None = None) -> TenantSim:
        """A fake tenant (its step loop and the real watchers) for a target
        pod that exists; arms invariant 13."""
        sim = TenantSim(self.cluster.kube, namespace, pod, extra_pods=extra_pods,
                        publish_url=publish_url, token=token)
        self.tenant_sims[(namespace, pod)] = sim
        return sim

    def stop_tenants(self) -> None:
        for sim in self.tenant_sims.values():
            sim.stop()

    def stop(self) -> None:
        failpoints.disarm_all()
        POLICY_ENGINE.enforce = True
        self.stop_tenants()
        if self.watch_store is not None:
            self.watch_store.stop()
        if self.app is not None:
            self.app.close()
        self.channel_pool.close_all()
        self.workers.stop()
        self.cluster.stop()

    def __enter__(self) -> "ChaosHarness":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- plumbing ---

    def record(self, event: str) -> None:
        self.schedule.append(event)
        logger.info("chaos[seed=%d] %s", self.seed, event)

    def add_pod(self, name: str, node: str, namespace: str = "default") -> Pod:
        pod = self.cluster.add_target_pod(name, namespace=namespace, node=node)
        self.pods[(namespace, name)] = node
        return pod

    def coordinator(self) -> SliceCoordinator:
        return SliceCoordinator(self.cluster.kube, self.app.registry, self.app._client_factory,
                                self.cfg)

    def client_for_node(self, node: str) -> WorkerClient:
        return self.app._client_factory(self.app.registry.worker_address(node))

    def probe(self, namespace: str, pod: str):
        """The pod's GPUs as its worker's ProbeGPU reports them."""
        with self.client_for_node(self.pods[(namespace, pod)]) as client:
            _, chips = client.probe_gpu(pod, namespace)
        return chips

    def _arm_random(self, pool) -> None:
        name, action = self.rng.choice(pool)
        self.record(f"arm {name}={action}")
        failpoints.arm(name, action)

    def _op(self, description: str, fn, fault_p: float = 0.7,
            capture_trace: bool = False, pool=FAULTS_COMMON) -> None:
        """One operation: maybe arm a fault from `pool`, run, log the
        outcome, disarm whatever did not fire. With capture_trace an
        operation with no fault armed runs under a ``chaos.<description>``
        root span, and if it ends without an exception its trace goes into
        ``traced_ops`` for invariant 16 (a failed one may rightly have no
        worker half to join)."""
        armed = self.rng.random() < fault_p
        if armed:
            self._arm_random(pool)
        ctx = None
        try:
            if capture_trace and not armed:
                with trace.span(f"chaos.{description}") as ctx:
                    fn()
            else:
                fn()
        except Exception as exc:  # noqa: BLE001 — the failures are the test
            self.record(f"{description} -> {type(exc).__name__}: {exc}")
        else:
            self.record(f"{description} -> ok")
            if ctx is not None:
                self.traced_ops.append({"trace": ctx.trace_id, "span": ctx.span_id,
                                        "op": description})
        finally:
            failpoints.disarm_all()

    # --- the scenario ---

    def run_mount_scenario(self, n_ops: int = 8) -> None:
        """Adds (a slice of one pod, 1 or 2 single mounts), forced removes of
        one held GPU and reconcile passes, on three pods (two share NODE_A,
        so that invariant 1 has teeth) whose declared intents are the repair:
        whatever the faults leave, converging on the intents restores the
        invariants. Each operation under a fault drawn from the pool (a
        reconcile from FAULTS_ELASTIC)."""
        pods = [("default", "m-a", NODE_A), ("default", "m-b", NODE_B),
                ("default", "m-c", NODE_A)]
        for ns, name, node in pods:
            self.add_pod(name, node, namespace=ns)
            desired = self.rng.randint(1, 2)
            self.app.elastic.store.put(ns, name, Intent(desired_chips=desired, min_chips=1))
            self.record(f"intent {ns}/{name} desired={desired}")
        for _ in range(n_ops):
            ns, name, node = self.rng.choice(pods)
            kind = self.rng.choice(["add", "remove", "reconcile"])
            if kind == "add":
                n = self.rng.randint(1, 2)
                self._op(f"add {n} to {name}",
                         lambda t=SliceTarget(namespace=ns, pod=name), n=n:
                         self.coordinator().mount_slice([t], n, entire=False),
                         capture_trace=True)
                continue
            if kind == "reconcile":
                self._op(f"reconcile {name}",
                         lambda ns=ns, name=name: self.app.elastic.reconcile_once(ns, name),
                         pool=FAULTS_ELASTIC)
                continue
            held = [c.uuid for c in self.probe(ns, name)]
            if not held:
                continue
            uuid = self.rng.choice(held)

            def _remove(ns=ns, name=name, node=node, uuid=uuid):
                with self.client_for_node(node) as client:
                    client.remove_gpu(name, ns, [uuid], force=True)

            self._op(f"remove {uuid} from {name}", _remove, capture_trace=True)
        self.converge()

    #: the windows of a mount batch a real worker death can land in, each
    #: with the batch's ledger txn open (the reference's CRASH_SITES)
    CRASH_SITES = [
        ("worker.mount.before_grant", "1*crash(chaos worker death)"),
        ("worker.mount.after_grant", "1*crash(chaos worker death)"),
        ("worker.mount.mknod", "1*crash(chaos worker death)"),
        ("worker.mount.mknod", "1*pass->1*crash(chaos worker death 2nd)"),
    ]

    def run_worker_crash_scenario(self, n_ops: int = 8) -> None:
        """Seeded worker deaths inside mount batches, each followed by the
        worker's restart and the ledger's replay, between healthy adds and
        forced removes. check_invariants() then also holds invariant 10:
        books == mounts == ledger on every node."""
        self.check_ledgers = True
        pods = [("default", "wc-a", NODE_A), ("default", "wc-b", NODE_B),
                ("default", "wc-c", NODE_A)]
        for ns, name, node in pods:
            self.add_pod(name, node, namespace=ns)
            desired = self.rng.randint(1, 2)
            self.app.elastic.store.put(ns, name, Intent(desired_chips=desired, min_chips=1))
            self.record(f"intent {ns}/{name} desired={desired}")
        for _ in range(n_ops):
            ns, name, node = self.rng.choice(pods)
            roll = self.rng.random()
            if roll < 0.5:
                site, action = self.rng.choice(self.CRASH_SITES)
                self.record(f"arm {site}={action}")
                failpoints.arm(site, action)
                n = self.rng.randint(1, 2)
                try:
                    self.coordinator().mount_slice([SliceTarget(namespace=ns, pod=name)], n,
                                                   entire=False)
                except Exception as exc:  # noqa: BLE001 — the death is the test
                    self.record(f"crash-mount {n} to {name} -> {type(exc).__name__}")
                else:
                    self.record(f"crash-mount {n} to {name} -> ok (fault unfired)")
                finally:
                    failpoints.disarm_all()
                self.restart_worker(node)
            elif roll < 0.75:
                n = self.rng.randint(1, 2)
                self._op(f"add {n} to {name}",
                         lambda t=SliceTarget(namespace=ns, pod=name), n=n:
                         self.coordinator().mount_slice([t], n, entire=False), fault_p=0.0)
            else:
                self._op(f"reconcile {name}",
                         lambda ns=ns, name=name: self.app.elastic.reconcile_once(ns, name),
                         fault_p=0.0)
        self.converge()

    # --- invariant 19: fractional shares, books == policy == ledger ---

    #: the two complementary tenants: (namespace, pod, profile, weight,
    #: budget), fixed a tenant so that the books' resync is idempotent; the
    #: decode tenant is metered, so that the throttle check has a share
    SHARE_TENANTS = [
        ("default", "vc-prefill", "prefill", 60, 0),
        ("default", "vc-decode", "decode", 40, 64),
    ]

    #: the shares' fault pool: the reference's FAULTS_SHARE, no crash (the
    #: deaths are driven, with the restart and the replay)
    FAULTS_SHARE = [
        ("rpc.client.call", "1*unavailable(chaos drop)"),
        ("rpc.client.call", "1*delay(0.05)"),
        ("worker.rpc", "1*delay(0.05)"),
        ("worker.mount.mknod", "1*error(chaos mknod)"),
        ("worker.unmount.before_revoke", "1*error(chaos revoke)"),
        ("k8s.patch_pod.status", "1*return(409)"),
    ]

    def run_share_scenario(self, n_ops: int = 10) -> None:
        """Fractional traffic under faults, as the reference's: the two
        tenants' policy-carrying mounts on NODE_A over gRPC (share_weight and
        share_rate_budget on the wire, the mounter's policy, the ledger's
        share records and the engine's entries), worker deaths mid-mount
        with the restart and the replay, forced releases and re-grants in
        place; the master's books resynced from ProbeGPU after each
        operation, then one clean restart (the replay re-arms the engine).
        check_invariants() then holds invariant 19 (and 10)."""
        self.vchip_armed = True
        self.check_ledgers = True
        for ns, name, _profile, _weight, _budget in self.SHARE_TENANTS:
            self.add_pod(name, NODE_A, namespace=ns)
        for _ in range(n_ops):
            ns, name, profile, weight, budget = self.rng.choice(self.SHARE_TENANTS)
            roll = self.rng.random()
            if roll < 0.25:
                site, action = self.rng.choice(self.CRASH_SITES)
                self.record(f"arm {site}={action}")
                failpoints.arm(site, action)
                try:
                    self._share_mount(ns, name, weight, budget)
                except Exception as exc:  # noqa: BLE001 — the death is the test
                    self.record(f"crash share-mount {name} -> {type(exc).__name__}")
                else:
                    self.record(f"crash share-mount {name} -> ok (fault unfired)")
                finally:
                    failpoints.disarm_all()
                self.restart_worker(NODE_A)
            elif roll < 0.55:
                self._op(f"share-mount {name}",
                         lambda ns=ns, name=name, weight=weight, budget=budget:
                         self._share_mount(ns, name, weight, budget), pool=self.FAULTS_SHARE)
            elif roll < 0.8:
                held = [c.uuid for c in self.probe(ns, name)]
                if held:
                    uuid = self.rng.choice(held)

                    def _release(ns=ns, name=name, uuid=uuid):
                        with self.client_for_node(NODE_A) as client:
                            client.remove_gpu(name, ns, [uuid], force=True)

                    self._op(f"share-release {uuid} from {name}", _release,
                             pool=self.FAULTS_SHARE)
            else:
                # a re-grant in place: the books take no new slot
                held = [c.uuid for c in self.probe(ns, name)]
                if held:
                    uuid = self.rng.choice(held)
                    self.app.shares.add(Share(namespace=ns, pod=name, chip_uuid=uuid,
                                              node=NODE_A, weight=weight, rate_budget=budget,
                                              profile=profile))
                    self.record(f"re-grant {ns}/{name}/{uuid}")
            self._sync_share_books(ns, name, profile, weight, budget)
        # the throttle check needs a metered share: the decode tenant ends
        # holding a GPU (a prefill GPU freed first when the node is full)
        ns, name, profile, weight, budget = self.SHARE_TENANTS[1]
        if not self.probe(ns, name):
            result, _ = self._share_mount(ns, name, weight, budget)
            if result != AddGPUResult.Success:
                p_ns, p_name = self.SHARE_TENANTS[0][:2]
                p_held = [c.uuid for c in self.probe(p_ns, p_name)]
                if p_held:
                    with self.client_for_node(NODE_A) as client:
                        client.remove_gpu(p_name, p_ns, [p_held[0]], force=True)
                    self._sync_share_books(p_ns, p_name, *self.SHARE_TENANTS[0][2:])
                self._share_mount(ns, name, weight, budget)
            self._sync_share_books(ns, name, profile, weight, budget)
        # one clean restart: the share policies come back from the ledger
        summary = self.restart_worker(NODE_A)
        if not summary.get("share_policies_replayed"):
            self.record("WARNING: restart replayed no share policies")
        for ns, name, profile, weight, budget in self.SHARE_TENANTS:
            self._sync_share_books(ns, name, profile, weight, budget)
        self.converge()

    def _share_mount(self, ns: str, name: str, weight: int, budget: int, n: int = 1):
        """One fractional mount over gRPC; (result, uuids)."""
        with self.client_for_node(NODE_A) as client:
            response = client.add_gpu(name, ns, n, share_weight=weight,
                                      share_rate_budget=budget)
        result = AddGPUResult(response.add_gpu_result)
        self.record(f"share-mount {ns}/{name} w={weight} b={budget} -> {result.name} "
                    f"{list(response.uuids)}")
        return result, list(response.uuids)

    def _sync_share_books(self, ns: str, name: str, profile: str, weight: int,
                          budget: int) -> None:
        """The master's books for one tenant brought to the worker's truth
        (ProbeGPU), as a share controller resyncs after faults: the worker's
        ledger and engine say what is granted."""
        held = {c.uuid for c in self.probe(ns, name)}
        booked = {s.chip_uuid for s in self.app.shares.by_tenant(ns, name)}
        for uuid in sorted(held - booked):
            self.app.shares.add(Share(namespace=ns, pod=name, chip_uuid=uuid,
                                      node=self.pods[(ns, name)], weight=weight,
                                      rate_budget=budget, profile=profile))
        for uuid in sorted(booked - held):
            self.app.shares.remove(ns, name, uuid)

    def disable_enforcement(self) -> None:
        """The negative control of invariant 19: the userspace engine a
        bookkeeper that admits past an exhausted budget, as a broken
        enforcement would; check_invariants() must name the divergence from
        the device program."""
        POLICY_ENGINE.enforce = False
        self.record("negative control: policy enforcement disabled")

    def withhold_unmount(self, node_name: str = NODE_A) -> str | None:
        """The negative control of invariant 17: one held GPU's kubelet claim
        erased, with no unmount and its booking kept, the divergence a lost
        unmount leaves (the worker's snapshot reads it free while the
        scheduler still books it). Returns its UUID (None when the node
        holds nothing)."""
        node = self.cluster.node(node_name)
        index_of = {d.uuid: d.index for d in node.backend.list_devices()}
        with self.cluster._alloc_lock:
            victim = next((uuid for uuid, owner in sorted(node.assignment.items(),
                                                          key=lambda kv: index_of[kv[0]])
                           if owner is not None and uuid not in node.dead), None)
            if victim is None:
                return None
            trimmed = []
            for pod, ns, container, resource, ids in node.kubelet.claims:
                kept = [i for i in ids if i != victim]
                if kept or not ids:
                    trimmed.append((pod, ns, container, resource, kept))
            node.kubelet.claims = trimmed
        self.record(f"withhold unmount of chip {victim} on {node_name} "
                    f"(kubelet claim erased, booking kept)")
        return victim

    # --- the elastic and migrate scenarios ---

    def run_elastic_scenario(self, n_ops: int = 10) -> None:
        """Declarative convergence under GPU deaths and induced faults: two
        pods with intents of 2, at most two GPU deaths, intent edits, and
        reconcile passes under FAULTS_ELASTIC."""
        pods = [("default", "e-a", NODE_A), ("default", "e-b", NODE_B)]
        for ns, name, node in pods:
            self.add_pod(name, node, namespace=ns)
            self.app.elastic.store.put(ns, name, Intent(desired_chips=2, min_chips=1))
        kills = 0
        for _ in range(n_ops):
            ns, name, node = self.rng.choice(pods)
            roll = self.rng.random()
            if roll < 0.2 and kills < 2:
                # kill a GPU the pod holds: the heal must converge through it
                held = self.probe(ns, name)
                if held:
                    victim = self.rng.choice(held)
                    index = next((d.index for d in self.cluster.node(node).backend.list_devices()
                                  if d.uuid == victim.uuid), None)
                    if index is not None:
                        self.record(f"kill chip {victim.uuid} on {node}")
                        self.cluster.kill_gpu(index, node)
                        kills += 1
                        continue
            amount = self.rng.choice([1, 2, 3])
            if roll < 0.35:
                self.record(f"intent {name} desired={amount}")
                self.app.elastic.store.put(ns, name, Intent(desired_chips=amount, min_chips=1))
            self._op(f"reconcile {name}",
                     lambda ns=ns, name=name: self.app.elastic.reconcile_once(ns, name),
                     pool=FAULTS_ELASTIC)
        self.converge()

    def run_migrate_scenario(self, n_migrations: int = 2) -> None:
        """Live migrations of a pod's 2 GPUs between NODE_A and NODE_B, each
        under a crash at a journal phase's boundary (p 0.8, FAULTS_MIGRATE),
        half with the checkpoint phase (no tenant acks it: the machine must
        go on to the classic drain); every journal must end terminal through
        resume_interrupted."""
        self.add_pod("src", NODE_A)
        self.add_pod("dst", NODE_B)
        self.coordinator().mount_slice([SliceTarget(namespace="default", pod="src")], 2,
                                       entire=False)
        self.record("mounted 2 chips on default/src")
        source, dest = ("default", "src"), ("default", "dst")
        for _ in range(n_migrations):
            if self.rng.random() < 0.8:
                self._arm_random(FAULTS_MIGRATE)
            checkpoint = self.rng.random() < 0.5
            try:
                journal = self.app.migrations.begin(source[0], source[1], dest[0], dest[1],
                                                    checkpoint=checkpoint)
            except Exception as exc:  # noqa: BLE001 — a refusal is an outcome
                self.record(f"migrate begin -> {type(exc).__name__}: {exc}")
                failpoints.disarm_all()
                continue
            mid = journal["id"]
            self.record(f"migrate {mid}: {source[1]} -> {dest[1]}")
            self._drive_to_terminal(mid)
            failpoints.disarm_all()
            final = self.app.migrations.get(mid) or {}
            self.record(f"migrate {mid} -> {final.get('outcome')}")
            if final.get("outcome") == "succeeded":
                source, dest = dest, source  # and back
        self.converge()

    def _drive_to_terminal(self, mid: str, timeout_s: float = 60.0) -> None:
        """Wait out the machine; after a simulated master crash adopt it
        again (the failpoints cleared first: the restarted master is
        clean)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            journal = self.app.migrations.wait(mid, timeout_s=5.0)
            if journal is not None and journal.get("outcome"):
                return
            failpoints.disarm_all()
            adopted = self.app.migrations.resume_interrupted()
            if adopted:
                self.record(f"resumed interrupted: {adopted}")

    def converge(self, timeout_s: float = 30.0) -> None:
        """Disarm everything, drive every migration to its end (adopting the
        interrupted ones, as a restarted master does), reconcile every
        declared intent until it converges, and wait for the slave pods'
        releases to land. A pod on a killed node is left out: the node-kill
        scenario reschedules it."""
        failpoints.disarm_all()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            pending = [j for j in self.app.migrations.list_migrations() if not j.get("outcome")]
            if not pending:
                break
            self.app.migrations.resume_interrupted()
            for journal in pending:
                self.app.migrations.wait(journal["id"], timeout_s=5.0)
        try:
            intents = self.app.elastic.store.list()
        except Exception:  # noqa: BLE001 — the pods' books below still settle
            intents = []
        for namespace, pod_name, _intent in intents:
            if self.pods.get((namespace, pod_name)) in self.dead_nodes:
                continue
            while time.monotonic() < deadline:
                try:
                    outcome = self.app.elastic.reconcile_once(namespace, pod_name)
                except Exception as exc:  # noqa: BLE001 — driven again
                    self.record(f"converge {pod_name}: retrying ({exc})")
                    time.sleep(0.05)
                    continue
                if outcome.get("phase") in ("converged", "unmanaged", "gone", "invalid"):
                    break
                time.sleep(0.05)
        while time.monotonic() < deadline:
            held, booked = self.held_gpus(), self.booked_gpus()
            if all(held[key] == booked[key] for key in self._live_pods()):
                break
            time.sleep(0.02)

    def _live_pods(self) -> list[tuple[str, str]]:
        """The pods on nodes that were not killed."""
        return [key for key, node in self.pods.items() if node not in self.dead_nodes]

    # --- invariant 20: a gray failure, scored and quarantined ---

    #: degradation armed only around the limping nodes' operations, drawn
    #: from the seeded failpoint RNG: a gray failure is intermittent
    #: slowness, not an outage (the reference's GRAY_FAULTS)
    GRAY_FAULTS = [
        ("worker.mount.mknod", "pdelay([0.9, 0.2])"),
        ("worker.rpc", "pdelay([0.5, 0.06])"),
        ("rpc.client.call", "pdrop(0.2)"),
    ]
    #: the p95 floor of the scenario's outlier bar, max(3 x median, median +
    #: floor). The reference's 20 ms is crossed by a healthy node's stall on
    #: a loaded host (its healthy-fleet control failed under six xdist
    #: workers); a limping pass's p95 (the max of its few samples) sits
    #: >= 200 ms over the median, the mknod's injected delay. 150 ms is 7.5x
    #: the reference's floor and 50 ms under the limp
    GRAY_P95_FLOOR_MS = 150.0

    def run_gray_scenario(self, limping: tuple = (NODE_B,), n_rounds: int = 4,
                          mounts_per_round: int = 3, disable_scorer: bool = False) -> dict:
        """Real adds and removes of one GPU through the whole worker path on
        every node, GRAY_FAULTS armed only around the limping nodes', and a
        scoring pass of the app's real ``HealthPlane`` after each round over
        entries the harness measured itself (every node runs in this one
        process, whose registry folds their mounts together; a worker of its
        own reports its own). Needs at least 4 nodes: a healthy herd of 3
        keeps the fleet's median a healthy one.

        disable_scorer=False: the limping nodes must end quarantined, and
        check_invariants() holds invariant 20. disable_scorer=True is its
        negative control: the plane is off while the node limps, and
        invariant 20 must name the missed detection. Returns {"states": each
        node's final state, "passes": the scoring passes}."""
        if len(self.services) < 4:
            raise ValueError("run_gray_scenario needs a >=4-node cluster (a 3-node healthy herd "
                             "for the fleet median); build the harness with nodes={...4 "
                             "entries...}")
        failpoints.seed(self.seed)
        self.gray_armed = True
        self.gray_nodes.update(limping)
        self.app.health.cfg = dataclasses.replace(
            self.cfg, health_enabled=not disable_scorer, health_min_samples=3,
            health_p95_multiplier=3.0, health_p95_floor_ms=self.GRAY_P95_FLOOR_MS,
            health_suspect_strikes=2, health_quarantine_strikes=3, health_clear_passes=2)
        if disable_scorer:
            self.record("negative control: health scorer disabled")
        pods_by_node: dict[str, tuple[str, str]] = {}
        for i, node in enumerate(sorted(self.services)):
            name = f"gf-{i}"
            self.add_pod(name, node)
            pods_by_node[node] = ("default", name)
        passes = 0
        for _round in range(n_rounds):
            # each pass scores the round just run, where the reference's
            # scores every sample since the scenario began: a p95 of a few
            # samples is their max, so there one healthy node's stall stays
            # the p95 of every later pass (a strike each, quarantined after
            # three; a loaded host stalled one for 256 ms against a median
            # of 49, past the floor). A limping node's round carries the
            # injected delay in nearly every round (0.9 a mknod)
            samples: dict[str, list[float]] = {n: [] for n in pods_by_node}
            errors: dict[str, int] = {n: 0 for n in pods_by_node}
            for node, (ns, name) in sorted(pods_by_node.items()):
                for _ in range(mounts_per_round):
                    if node in limping:
                        for site, action in self.GRAY_FAULTS:
                            failpoints.arm(site, action)
                    started = time.monotonic()
                    ok = False
                    try:
                        with self.client_for_node(node) as client:
                            response = client.add_gpu(name, ns, 1)
                        ok = response.add_gpu_result == AddGPUResult.Success
                        if ok and response.uuids:
                            with self.client_for_node(node) as client:
                                client.remove_gpu(name, ns, list(response.uuids), force=True)
                    except Exception as exc:  # noqa: BLE001 — the limp
                        self.record(f"gray mount on {node} -> {type(exc).__name__}")
                    finally:
                        failpoints.disarm_all()
                    samples[node].append((time.monotonic() - started) * 1000.0)
                    if not ok:
                        errors[node] += 1
            entries = self._gray_entries(samples, errors)
            self.app.health.observe(entries)
            passes += 1
            pane = self.app.health.payload()
            states = {n: p["state"] for n, p in pane["nodes"].items()}
            # the pass's evidence, named by a missed detection: each node's
            # p95 and errors against the fleet's median
            p95s = {n: round(e["mount"]["p95_ms"], 1) for n, e in entries.items()}
            self.record(f"gray pass {passes}: {states} p95_ms={p95s} errors={errors} "
                        f"median_ms={pane['last_pass']['median_p95_ms']}")
        self.converge()
        return {"states": {n: p["state"] for n, p in
                           self.app.health.payload()["nodes"].items()},
                "passes": passes}

    def _gray_entries(self, samples: dict[str, list[float]],
                      errors: dict[str, int]) -> dict[str, dict]:
        """CollectTelemetry-shaped entries a node from the harness's own
        measurements (the reference's ``_gray_entries``)."""
        entries: dict[str, dict] = {}
        for node, vals in samples.items():
            if node in self.dead_nodes:
                continue
            ordered = sorted(vals)
            p95 = ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))] if ordered else None
            entries[node] = {"mount": {"count": len(vals), "p95_ms": p95,
                                       "success": len(vals) - errors[node],
                                       "error": errors[node]},
                             "breaker": "closed"}
        return entries

    def _gray_attribution(self) -> list[str]:
        """Invariant 20 over the app's health plane and the flight recorder."""
        out: list[str] = []
        panes = self.app.health.payload()["nodes"]
        quarantined_now = {n for n, p in panes.items()
                           if p["state"] == "quarantined" and not p["evacuated"]}
        for rec in FLIGHT.snapshot():
            if rec.get("kind") != "health":
                continue
            det = rec.get("details") or {}
            if det.get("to_state") != "quarantined" or det.get("from_state") == "quarantined":
                continue
            node = rec.get("node")
            if not det.get("signals"):
                out.append(f"quarantine of {node} carries no concrete signal in the flight "
                           f"record (unattributed quarantine): {rec.get('summary')}")
            if node not in self.gray_nodes:
                out.append(f"false quarantine: {node} was quarantined but no gray fault was "
                           f"armed on it (signals: {det.get('signals')})")
        if quarantined_now - self.gray_nodes:
            out.append(f"false quarantine set: {sorted(quarantined_now - self.gray_nodes)} "
                       f"quarantined without an armed gray fault")
        for node in sorted(self.gray_nodes):
            if node not in quarantined_now:
                out.append(f"gray failure NOT detected: {node} limped through the whole "
                           f"scenario but ended {panes.get(node, {}).get('state', 'untracked')!r}"
                           f" instead of quarantined; "
                           + "; ".join(line for line in self.schedule
                                       if line.startswith("gray pass")))
        return out

    # --- invariant 11: a node's death, its evacuation, the re-convergence ---

    def run_node_kill_scenario(self, n_pods: int = 2, deadline_s: float = 30.0) -> dict:
        """Kill NODE_A under `n_pods` live intents (1 or 2 GPUs each, drawn
        from the seed, converged before the kill; a survivor of 1 on NODE_B):
        the recovery controller must have tracked it alive, then confirm and
        evacuate it within `deadline_s`, none of its pool pods may be left,
        and every stranded intent must converge on NODE_B once its pod is
        rescheduled there. Returns {"detect_passes", "detect_ms" (host clock,
        the kill to the evacuation), "evacuation", "victims": {name: GPUs},
        "reconverged": {name: the converging pass's outcome}}."""
        victims: dict[str, int] = {}
        for i in range(n_pods):
            name = f"nk-{i}"
            self.add_pod(name, NODE_A)
            desired = self.rng.randint(1, 2)
            self.app.elastic.store.put("default", name, Intent(desired_chips=desired,
                                                               min_chips=1))
            victims[name] = desired
            outcome = self.app.elastic.reconcile_once("default", name)
            self.record(f"pre-kill {name}: {outcome.get('phase')} desired={desired}")
            if outcome.get("phase") != "converged":
                raise InvariantViolation(f"pre-kill convergence failed for {name}: {outcome}")
        self.add_pod("survivor", NODE_B)
        self.app.elastic.store.put("default", "survivor", Intent(desired_chips=1, min_chips=1))
        self.app.elastic.reconcile_once("default", "survivor")
        # the controller runs all the time: every node is tracked before it
        # can die (killed first, the registry's watch could drop the worker
        # before the node was ever tracked)
        primed = self.app.recovery.check_once()
        if NODE_A not in self.app.recovery.payload()["nodes"]:
            raise InvariantViolation(f"recovery never tracked {NODE_A} while alive: {primed}")
        t0 = time.perf_counter()
        self.kill_node(NODE_A)
        passes = 0
        evacuated = False
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not evacuated:
            passes += 1
            evacuated = NODE_A in self.app.recovery.check_once()["evacuated"]
            if not evacuated:
                time.sleep(0.05)
        detect_ms = (time.perf_counter() - t0) * 1e3
        if not evacuated:
            raise InvariantViolation(f"node {NODE_A} never evacuated (seed={self.seed}); "
                                     f"recovery state: {self.app.recovery.payload()}")
        self.record(f"evacuated {NODE_A} after {passes} pass(es)")
        leftover = [Pod(p).name for p in self.cluster.kube.list_pods(self.cfg.pool_namespace)
                    if Pod(p).node_name == NODE_A]
        if leftover:
            raise InvariantViolation(f"evacuation left bookings on {NODE_A}: {leftover}")
        # the workload's controller reschedules each victim on NODE_B (the
        # same name, a new pod), its intent declared again as a pod template
        # that carries the annotations would
        reconverged = {}
        for name, desired in victims.items():
            self.cluster.kube.delete_pod("default", name)
            self.add_pod(name, NODE_B)
            self.app.elastic.store.put("default", name, Intent(desired_chips=desired,
                                                               min_chips=1))
            outcome: dict = {}
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                try:
                    outcome = self.app.elastic.reconcile_once("default", name)
                except Exception as exc:  # noqa: BLE001 — driven again
                    self.record(f"re-drive {name}: retrying ({exc})")
                    time.sleep(0.05)
                    continue
                if outcome.get("phase") == "converged":
                    break
                time.sleep(0.05)
            if outcome.get("phase") != "converged" or outcome.get("actual") != desired:
                raise InvariantViolation(f"evacuated intent default/{name} never re-converged "
                                         f"(seed={self.seed}): {outcome}")
            reconverged[name] = outcome
            self.record(f"re-converged {name} on {NODE_B}: actual={outcome.get('actual')}")
        return {"detect_passes": passes, "detect_ms": detect_ms,
                "evacuation": self.app.recovery.payload()["evacuations"], "victims": victims,
                "reconverged": reconverged}

    # --- invariant 14: the API server's outage, the degraded mode, the heal ---

    #: the phases a migrate flavor's partition lands in, one drawn from the
    #: seed (the reference's lands wherever a race between the machine and
    #: the partition reaches)
    OUTAGE_MIGRATE_PHASES = ("drain", "remount", "resume", "verify")

    def _gate_phase(self, phase: str) -> tuple[threading.Event, threading.Event]:
        """Hold the migration machine inside `phase`, before its first call:
        (entered, release). The partition then lands while the machine is
        in the phase, and the machine's first call after the release meets
        it with ApiHealth's verdict still healthy, whatever a loaded host's
        stalls."""
        entered, release = threading.Event(), threading.Event()
        coordinator = self.app.migrations
        inner = getattr(coordinator, f"_phase_{phase}")

        def gated(journal: dict) -> str:
            if not release.is_set():
                entered.set()
                release.wait(60.0)
            return inner(journal)

        setattr(coordinator, f"_phase_{phase}", gated)
        return entered, release

    def _await(self, what: str, cond, timeout_s: float = 30.0) -> None:
        """Until cond() holds, polled every 5 ms: a wait on state, with a
        deadline well clear of a loaded host's stalls."""
        deadline = time.monotonic() + timeout_s
        while not cond():
            if time.monotonic() > deadline:
                raise InvariantViolation(f"{what} not reached within {timeout_s:.0f}s "
                                         f"(seed={self.seed})")
            time.sleep(0.005)

    def run_api_outage_scenario(self, flavor: str = "mount",
                                replay_enabled: bool = True) -> dict:
        """Partition the fake API server in the middle of a mount, a
        migration, a heal or a node's death (`flavor`) and hold invariant
        14: in the outage no destructive mutation lands from stale reads (the
        reconciler parks read only, the migration machine holds at a
        journaled phase boundary, the evacuation is suspended) and no booking
        leaks (a slave release defers into the ledger's queue); after the
        heal every deferred annotation write lands once (the newest value
        wins, a CAS loser is dropped) and books == mounts == ledger ==
        intents.

        The migrate flavor's machine is held inside a phase drawn from the
        seed (``OUTAGE_MIGRATE_PHASES``) while the partition lands, and
        released before ApiHealth's verdict leaves healthy: its own failing
        calls are the first of the streak, the race the reference's machine
        loses now and then by rolling back in the outage. Every wait is on
        state with a 30 s deadline (the reference's waits by sleeps).

        replay_enabled=False is the negative control: the write-behind
        queue's flush does nothing, and the scenario must name the
        divergence (writes that never landed) with an InvariantViolation."""
        assert flavor in ("mount", "migrate", "heal", "recovery"), flavor
        self.check_ledgers = True
        store = self.app.store
        kube_raw = self.cluster.kube
        tracked = self.app.kube  # the health-tracked client

        # the converged start: one pod with an intent a node
        intent_pods = [("default", "ao-a", NODE_A), ("default", "ao-b", NODE_B)]
        desired_by_pod: dict[str, int] = {}
        for ns, name, node in intent_pods:
            self.add_pod(name, node, namespace=ns)
            desired = self.rng.randint(1, 2)
            desired_by_pod[name] = desired
            self.app.elastic.store.put(ns, name, Intent(desired_chips=desired, min_chips=1))
            outcome = self.app.elastic.reconcile_once(ns, name)
            if outcome.get("phase") != "converged":
                raise InvariantViolation(f"pre-outage convergence failed for {name}: {outcome}")
            self.record(f"pre-outage {name} converged desired={desired}")

        mode = "writes" if flavor == "heal" else "full"
        mid = None
        dead_uuid = None
        release = None
        if flavor == "migrate":
            self.add_pod("ao-src", NODE_A)
            self.add_pod("ao-dst", NODE_B)
            self.coordinator().mount_slice([SliceTarget(namespace="default", pod="ao-src")], 2,
                                           entire=False)
            phase = self.rng.choice(self.OUTAGE_MIGRATE_PHASES)
            entered, release = self._gate_phase(phase)
            mid = self.app.migrations.begin("default", "ao-src", "default", "ao-dst")["id"]
            self._await(f"migration {mid} in phase {phase}", entered.is_set)
            self.record(f"migration {mid} held in phase {phase}")
        elif flavor == "heal":
            # a dead GPU the reconciler wants to heal, and must not touch
            # while the API is unhealthy (its intent may be stale)
            victim = self.probe("default", "ao-a")[0]
            index = next(d.index for d in self.cluster.node(NODE_A).backend.list_devices()
                         if d.uuid == victim.uuid)
            self.cluster.kill_gpu(index, NODE_A)
            dead_uuid = victim.uuid
            self.record(f"killed chip {dead_uuid} on {NODE_A}")
        elif flavor == "recovery":
            # a real node's death the partition swallows at once: every
            # reason to evacuate, all its evidence stale
            self.app.recovery.check_once()  # tracked while alive
            self.kill_node(NODE_B)

        if flavor == "mount":
            # the partition lands while the mount runs
            def _racing_mount():
                try:
                    self.coordinator().mount_slice([SliceTarget(namespace="default",
                                                                pod="ao-a")], 1, entire=False)
                except Exception as exc:  # noqa: BLE001 — the point
                    self.record(f"mid-outage mount -> {type(exc).__name__}")

            racer = threading.Thread(target=_racing_mount, daemon=True)
            racer.start()
            time.sleep(0.005)
            kube_raw.set_partitioned(True, mode=mode)
            self.record(f"partitioned mid-mount (mode={mode})")
            racer.join(timeout=30.0)
        else:
            kube_raw.set_partitioned(True, mode=mode)
            self.record(f"partitioned (mode={mode}, flavor={flavor})")
        held_at_partition = self.held_gpus()
        if release is not None:
            # the held phase meets the partition under a healthy verdict;
            # the machine's own failures flip it, and it pauses
            release.set()
            self._await(f"migration {mid} paused at a phase boundary",
                        lambda: (self.app.migrations.get(mid) or {}).get("paused_for_api")
                        or (self.app.migrations.get(mid) or {}).get("outcome"))

        # the health machine to its verdict, with real failing calls (the
        # daemons' loops would supply them)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and self.app.apihealth.ok():
            try:
                if mode == "writes":
                    tracked.patch_pod("default", "ao-a", {"metadata": {}})
                else:
                    tracked.get_pod("default", "ao-a")
            except Exception:  # noqa: BLE001 — the failures are the feed
                pass
            time.sleep(0.01)
        if self.app.apihealth.ok():
            raise InvariantViolation(f"api health never left healthy under partition "
                                     f"(seed={self.seed})")
        self.record(f"api health: {self.app.apihealth.state()}")

        # --- in the outage ---

        # 1. the annotation writes defer into the durable queue
        queued_annotations: dict[str, str] = {}
        for i in range(3):
            annot = f"tpumounter.io/outage-test-{i}"
            payload = json.dumps({"v": i, "flavor": flavor})
            store.stamp_annotation("default", "ao-a", annot, payload)
            queued_annotations[annot] = payload
        # a CAS-carrying write that must lose to a newer writer after the
        # heal (seq 1 against 5)
        store.stamp_annotation("default", "ao-a", "tpumounter.io/outage-cas",
                               json.dumps({"seq": 1, "from": "outage"}))
        if store.queue.pending_count() < len(queued_annotations) + 1:
            raise InvariantViolation(f"writes were not deferred during the outage: "
                                     f"{store.queue.stats()}")
        self.record(f"deferred {store.queue.pending_count()} write(s)")

        # 2. the reconcile passes stay read only
        for ns, name, node in intent_pods:
            if node in self.dead_nodes:
                continue
            try:
                outcome = self.app.elastic.reconcile_once(ns, name)
            except Exception as exc:  # noqa: BLE001 — a full partition fails
                # even the pod's GET, and a failed pass mutates nothing
                self.record(f"outage reconcile {name} -> {type(exc).__name__}")
                continue
            self.record(f"outage reconcile {name} -> {outcome.get('phase')}")
            if outcome.get("healed") or outcome.get("removed_excess") or outcome.get("added"):
                raise InvariantViolation(f"destructive reconcile during outage: {outcome}")
        if flavor == "heal":
            held_now = self.held_gpus()[("default", "ao-a")]
            if dead_uuid not in held_now:
                raise InvariantViolation(f"dead chip {dead_uuid} was removed during the outage "
                                         f"(heal must park): held={sorted(held_now)}")

        # 3. no evacuation in the outage
        for _ in range(4):
            out = self.app.recovery.check_once()
            if out["evacuated"]:
                raise InvariantViolation(f"evacuation during api outage (stale evidence): {out}")
            time.sleep(0.02)
        if self.app.recovery.payload()["evacuations"]:
            raise InvariantViolation("evacuation recorded during the outage")

        # 4. the machine holds at a boundary, journaled, never terminal
        if mid is not None:
            self._await(f"migration {mid} paused at a phase boundary",
                        lambda: (self.app.migrations.get(mid) or {}).get("paused_for_api")
                        or (self.app.migrations.get(mid) or {}).get("outcome"))
            j = self.app.migrations.get(mid) or {}
            if j.get("outcome"):
                raise InvariantViolation(f"migration went terminal during the outage: {j}")
            self.record(f"migration {mid} holding at phase {j.get('phase')} "
                        f"(paused_for_api={j.get('paused_for_api')})")

        # 5. nothing landed from stale reads
        if self.held_gpus() != held_at_partition:
            raise InvariantViolation(f"held chips changed during the outage: "
                                     f"{held_at_partition} -> {self.held_gpus()}")

        # 6. a slave release in the outage defers into the ledger's queue
        # (heal: writes partitioned, the unmount itself is the node's); an
        # operator's remove, after the stale-read check
        if flavor == "heal":
            removable = sorted(self.held_gpus()[("default", "ao-b")])
            with self.client_for_node(NODE_B) as client:
                client.remove_gpu("ao-b", "default", [removable[0]], force=True)
            pending_rel = self.services[NODE_B].ledger.pending_releases()
            if not pending_rel:
                raise InvariantViolation("slave release during outage neither completed nor "
                                         "deferred into the ledger queue")
            self.record(f"slave release deferred: {pending_rel[0].get('pods')}")

        # --- the heal ---
        kube_raw.set_partitioned(False)
        self.record("partition healed")
        if not replay_enabled:
            # the negative control: the replay does nothing
            store.flush_writes = lambda: {"applied": 0, "pending": store.queue.pending_count()}
        # a newer writer moves the CAS counter before the queued seq 1 replays
        kube_raw.patch_pod("default", "ao-a", {"metadata": {"annotations": {
            "tpumounter.io/outage-cas": json.dumps({"seq": 5, "from": "post-heal"})}}})
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not self.app.apihealth.ok():
            try:
                tracked.get_pod("default", "ao-a")
                tracked.patch_pod("default", "ao-a", {"metadata": {}})
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.01)
        if not self.app.apihealth.ok():
            raise InvariantViolation("api health never recovered after the partition healed")
        flush = store.flush_writes()
        self.record(f"post-heal flush: {flush}")

        if flavor == "recovery":
            # the evidence is fresh now: the node must be evacuated, and its
            # stranded intent converge once rescheduled
            deadline = time.monotonic() + 30.0
            evacuated = False
            while time.monotonic() < deadline and not evacuated:
                evacuated = NODE_B in self.app.recovery.check_once()["evacuated"]
                if not evacuated:
                    time.sleep(0.05)
            if not evacuated:
                raise InvariantViolation(f"{NODE_B} never evacuated after the api healed: "
                                         f"{self.app.recovery.payload()}")
            self.record(f"post-heal evacuation of {NODE_B}")
            self.cluster.kube.delete_pod("default", "ao-b")
            self.add_pod("ao-b", NODE_A)
            self.app.elastic.store.put("default", "ao-b",
                                       Intent(desired_chips=desired_by_pod["ao-b"], min_chips=1))
        if mid is not None:
            self._drive_to_terminal(mid)
            j = self.app.migrations.get(mid) or {}
            if not j.get("outcome"):
                raise InvariantViolation(f"migration {mid} never went terminal after the heal: "
                                         f"{j}")
            self.record(f"migration {mid} -> {j.get('outcome')}")
        for node, service in self.services.items():
            if node in self.dead_nodes or service.ledger is None:
                continue
            service.retry_pending_releases()
        self.converge()
        # a write queued while the first flush was mid-pass must not be left
        # pending at the check
        if replay_enabled:
            store.flush_writes()

        # --- invariant 14: the agreement after the heal ---
        violations: list[str] = []
        annotations_a = Pod(kube_raw.get_pod("default", "ao-a")).annotations
        if not replay_enabled:
            missing = [a for a in queued_annotations if a not in annotations_a]
            if missing or store.queue.pending_count():
                raise InvariantViolation(
                    f"write-behind divergence detected (replay disabled): {missing} never "
                    f"landed, {store.queue.pending_count()} write(s) stranded in the queue "
                    f"(seed={self.seed})")
            raise InvariantViolation("negative control failed: replay was disabled yet no "
                                     "divergence exists")
        if store.queue.pending_count():
            violations.append(f"write-behind queue not drained after heal: "
                              f"{store.queue.stats()}")
        for annot, payload in queued_annotations.items():
            if annotations_a.get(annot) != payload:
                violations.append(f"queued write {annot} did not land exactly once: "
                                  f"{annotations_a.get(annot)!r} != {payload!r}")
        cas_raw = annotations_a.get("tpumounter.io/outage-cas", "{}")
        if json.loads(cas_raw).get("seq") != 5:
            violations.append(f"CAS replay rolled a newer write backward: {cas_raw}")
        if self.app.apihealth.state() != "healthy":
            violations.append(f"api health stuck {self.app.apihealth.state()} after heal")
        for node, service in self.services.items():
            if node in self.dead_nodes or service.ledger is None:
                continue
            if service.ledger.pending_releases():
                violations.append(f"deferred slave release never completed on {node}: "
                                  f"{service.ledger.pending_releases()}")
        if violations:
            tail = "\n  ".join(self.schedule[-25:])
            raise InvariantViolation(f"invariant 14 violated (seed={self.seed}, flavor={flavor}):"
                                     f"\n- " + "\n- ".join(violations)
                                     + f"\nschedule tail:\n  {tail}")
        # books == mounts == ledger == intents: the shared checks
        self.check_invariants()
        return {"flavor": flavor, "flush": flush, "apihealth": self.app.apihealth.payload(),
                "migration": mid, "queue": store.queue.stats()}

    # --- invariant 22: watch-store index parity under stream chaos ---

    #: fictional hosts the churn schedules pool pods onto, apart from the
    #: worker nodes, so nothing else ever acts on the churned pods
    WS_POOL_NODES = ("wsnode-1", "wsnode-2", "wsnode-3")
    WS_ANCHORS = ("ws-anchor-a", "ws-anchor-b")

    def run_watch_store_scenario(self, churn_per_round: int = 40,
                                 storm_events: int = 120) -> dict:
        """The ``WatchMasterStore`` over the live cluster, through three
        rounds in seeded order: a severed watch and a storm of churn past a
        backlog of 64 events (the resume's resourceVersion has expired: a
        410), a restart (a fresh instance lists from scratch), and steady
        churn. check_invariants() then holds invariant 22 too. Returns the
        rounds' order, the store's payload and the relists of all its
        instances."""
        from gpumounter_tpu_torch.migrate.journal import ANNOT_JOURNAL
        from gpumounter_tpu_torch.store import WatchMasterStore
        failpoints.seed(self.seed)
        self.watchstore_armed = True
        kube = self.cluster.kube
        # a storm's churn must really expire the informer's version
        kube._max_events = 64
        self._watch_cfg = dataclasses.replace(self.cfg, store_watch_timeout_s=0.2,
                                              store_watch_relist_base_s=0.02,
                                              store_watch_relist_cap_s=0.2)
        for anchor in self.WS_ANCHORS:
            # the targets of intent and journal writes through the store,
            # never deleted by the churn
            kube.create_pod("default", {
                "metadata": {"name": anchor, "namespace": "default"},
                "spec": {"nodeName": self.WS_POOL_NODES[0], "containers": [{"name": "c"}]},
                "status": {"phase": "Running", "podIP": "10.99.0.1"},
            })
        self.watch_store = WatchMasterStore(kube, self._watch_cfg)
        if not self.watch_store.wait_synced(10.0):
            raise InvariantViolation(f"watch store never primed (seed={self.seed})")
        self.record("watch store primed (invariant 22 armed)")
        flavors = ["storm", "restart", "steady"]
        self.rng.shuffle(flavors)
        relists_total = 0  # across instances: the restart replaces one
        for n, flavor in enumerate(flavors):
            self.record(f"watch round {n}: {flavor}")
            if flavor == "storm":
                kube.set_partitioned(True, mode="reads")
                time.sleep(0.3)  # the 0.2 s stream ends, its re-open fails
                self._watch_churn(storm_events)
                kube.set_partitioned(False)
                self.record(f"healed after {storm_events}-event storm "
                            f"(backlog 64: the resume must 410)")
                # the 410 -> relist recovery ends here, before a restart
                # round could stop the instance in the middle of it
                self._watch_settle(10.0)
            elif flavor == "restart":
                relists_total += self.watch_store.relists
                self.watch_store.stop()
                self.watch_store = WatchMasterStore(kube, self._watch_cfg)
                if not self.watch_store.wait_synced(10.0):
                    raise InvariantViolation(
                        f"watch store never re-primed after restart (seed={self.seed})")
                self.record("watch store restarted (fresh relist)")
                self._watch_churn(churn_per_round)
            else:
                self._watch_churn(churn_per_round)
        # the churned journals are the harness's own: clear them through
        # the store, one last run of the clear path and the overlay
        for anchor in self.WS_ANCHORS:
            self.watch_store.stamp_annotation("default", anchor, ANNOT_JOURNAL, None)
        self._watch_settle(10.0)
        payload = self.watch_store.payload()
        relists_total += payload["relists"]
        self.record(f"watch store settled: relists={relists_total} "
                    f"events={payload['events_applied']} indexes={payload['indexes']}")
        return {"rounds": flavors, "payload": payload, "relists_total": relists_total}

    def _watch_settle(self, timeout_s: float) -> bool:
        """Until the store's pod index counts the live pods and its stream
        is quiet (which waits out a 410's relist too)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            want = len(self.cluster.kube.list_pods_with_rv()[0])
            if self.watch_store.payload()["indexes"]["pods"] == want \
                    and self.watch_store.quiesce(1.0):
                return True
        return False

    def _watch_churn(self, n_events: int) -> None:
        """Seeded churn of the population, every step a WRITE (creates,
        annotation patches, reschedules, deletes, intent and journal writes
        through the store), so a storm runs under a reads-only partition
        while the backlog overflows. The reference's draws, one for one."""
        from gpumounter_tpu_torch.elastic.intents import Intent
        from gpumounter_tpu_torch.migrate.journal import new_journal
        kube = self.cluster.kube
        pool_ns = self.cfg.pool_namespace
        emitted = 0
        while emitted < n_events:
            roll = self.rng.random()
            if roll < 0.30:  # a new tenant pod with an intent
                name = f"ws-{self._ws_serial}"
                self._ws_serial += 1
                kube.create_pod("default", {
                    "metadata": {"name": name, "namespace": "default",
                                 "annotations": {"tpumounter.io/desired-chips":
                                                 str(self.rng.randint(1, 4))}},
                    "spec": {"nodeName": self.rng.choice(self.WS_POOL_NODES),
                             "containers": [{"name": "c"}]},
                    "status": {"phase": "Running", "podIP": "10.99.0.2"},
                })
                self._ws_default.append(name)
            elif roll < 0.45 and self._ws_default:  # an intent flips
                name = self.rng.choice(self._ws_default)
                kube.patch_pod("default", name, {"metadata": {"annotations": {
                    "tpumounter.io/desired-chips": str(self.rng.randint(1, 4))}}})
            elif roll < 0.60:  # a new pool pod
                name = f"ws-pool-{self._ws_serial}"
                self._ws_serial += 1
                node = self.rng.choice(self.WS_POOL_NODES)
                kube.create_pod(pool_ns, {
                    "metadata": {"name": name, "namespace": pool_ns},
                    "spec": {"nodeName": node, "containers": [{"name": "c"}]},
                    "status": {"phase": "Running", "podIP": "10.99.0.3"},
                })
                self._ws_pool[name] = node
            elif roll < 0.72 and self._ws_pool:  # a pool pod moves
                name = self.rng.choice(sorted(self._ws_pool))
                node = self.rng.choice(self.WS_POOL_NODES)
                kube.patch_pod(pool_ns, name, {"spec": {"nodeName": node}})
                self._ws_pool[name] = node
            elif roll < 0.82 and len(self._ws_default) > 2:
                name = self._ws_default.pop(self.rng.randrange(len(self._ws_default)))
                kube.delete_pod("default", name)
            elif roll < 0.90 and len(self._ws_pool) > 1:
                name = sorted(self._ws_pool)[self.rng.randrange(len(self._ws_pool))]
                del self._ws_pool[name]
                kube.delete_pod(pool_ns, name)
            elif roll < 0.96:  # a write through the store (its overlay)
                anchor = self.rng.choice(self.WS_ANCHORS)
                self.watch_store.put_intent("default", anchor,
                                            Intent(desired_chips=self.rng.randint(1, 4),
                                                   min_chips=1))
            else:  # a journal saved through the store
                src, dst = self.WS_ANCHORS if self.rng.random() < 0.5 \
                    else tuple(reversed(self.WS_ANCHORS))
                journal = new_journal(f"ws-mig-{self._ws_serial}", "default", src,
                                      "default", dst)
                self._ws_serial += 1
                journal["phase"] = "drain"
                self.watch_store.save_journal(journal)
            emitted += 1

    def poison_watch_index(self) -> None:
        """The negative control of invariant 22: one indexed intent made
        stale in place, as a missed event would leave it. Nothing changed on
        the API server, so nothing repairs it; check_invariants() must flag
        it."""
        from gpumounter_tpu_torch.elastic.intents import Intent
        key = ("default", self.WS_ANCHORS[0])
        with self.watch_store._mu:
            self.watch_store._intents[key] = Intent(desired_chips=97, min_chips=1)
        self.record(f"negative control: poisoned watch-store intent index for "
                    f"{key[0]}/{key[1]} (stale entry)")

    def _watch_parity(self) -> list[str]:
        """Invariant 22: every index of the watch store against a fresh
        list-backed store reading the same cluster."""
        from gpumounter_tpu_torch.store import KubeMasterStore
        out: list[str] = []
        store = self.watch_store
        ref = KubeMasterStore(self.cluster.kube, self._watch_cfg)

        def _names(pods):
            return sorted((p["metadata"]["namespace"], p["metadata"]["name"]) for p in pods)

        got, want = _names(store.list_worker_pods()), _names(ref.list_worker_pods())
        if got != want:
            out.append(f"invariant 22: worker index diverges from a fresh LIST: "
                       f"indexed {got} != listed {want}")
        got_i = sorted(store.list_intents(), key=lambda t: (t[0], t[1]))
        want_i = sorted(ref.list_intents(), key=lambda t: (t[0], t[1]))
        if got_i != want_i:
            out.append(f"invariant 22: intent index diverges from a fresh LIST: "
                       f"indexed {got_i} != listed {want_i}")
        got_j = sorted(store.scan_journals(), key=lambda j: j["id"])
        want_j = sorted(ref.scan_journals(), key=lambda j: j["id"])
        if got_j != want_j:
            out.append(f"invariant 22: journal index diverges from a fresh LIST: indexed "
                       f"{[j['id'] for j in got_j]} != listed {[j['id'] for j in want_j]}")
        nodes = {Pod(p).node_name for p in self.cluster.kube.list_pods(self.cfg.pool_namespace)
                 if Pod(p).node_name}
        with store._mu:
            nodes |= set(store._pool_by_node)
        for node in sorted(nodes):
            got_p = sorted(p["metadata"]["name"] for p in store.list_pool_pods(node))
            want_p = sorted(p["metadata"]["name"] for p in ref.list_pool_pods(node))
            if got_p != want_p:
                out.append(f"invariant 22: pool bucket for {node} diverges from a fresh "
                           f"LIST: indexed {got_p} != listed {want_p}")
        return out

    # --- what the tenants see, what the books say ---

    def drop_worker_spans(self) -> int:
        """The negative control of invariant 16: both span stores (the ring,
        and the remote store that invariant 8's passes fill) rewritten
        without any worker.* span, as if a worker's export were lost
        everywhere; check_invariants() must then find every traced
        operation incomplete. Returns how many spans were dropped."""
        ring = trace.TRACER.ring
        spans = ring.snapshot()
        kept = [s for s in spans if not s.get("name", "").startswith("worker.")]
        ring.clear()
        for span in kept:
            ring.export(span)
        dropped = len(spans) - len(kept)
        remote = REMOTE_SPANS.snapshot()
        REMOTE_SPANS.reset()
        for span in remote:
            if span.get("name", "").startswith("worker."):
                dropped += 1
                continue
            REMOTE_SPANS.ingest(span.get("node", ""), [span])
        return dropped

    def held_gpus(self) -> dict[tuple[str, str], set[str]]:
        """(namespace, pod) -> the UUIDs whose node is in the pod's /dev."""
        held = {}
        for (namespace, name), node in self.pods.items():
            dev_dir = os.path.join(self._dev_root(node), f"{namespace}-{name}")
            held[(namespace, name)] = {
                dev.uuid for dev in self.cluster.node(node).backend.list_devices()
                if os.path.exists(device_node_path(dev_dir, dev))}
        return held

    def booked_gpus(self) -> dict[tuple[str, str], set[str]]:
        """(namespace, pod) -> the UUIDs the scheduler's books give the pod,
        its slave pods' included."""
        booked = {}
        for (namespace, name), node in self.pods.items():
            service = self.services[node]
            try:
                pod = Pod(self.cluster.kube.get_pod(namespace, name))
            except NotFoundError:
                booked[(namespace, name)] = set()
                continue
            service.collector.update_status()
            slaves = {s.name for s in service.allocator.slave_pods_for(pod)}
            booked[(namespace, name)] = {d.uuid for d in service.collector.get_pod_devices(
                name, namespace, slave_pod_names=slaves, refresh=False)}
        return booked

    def check_invariants(self) -> None:
        violations: list[str] = []
        held, booked = self.held_gpus(), self.booked_gpus()
        # 1. a GPU is (node, uuid): the fake nodes reuse UUIDs. A killed
        # node's pods are out of the books' reach (its evacuation released
        # their bookings on dead hardware)
        live = self._live_pods()
        owners: dict[tuple[str, str], list[tuple[str, str]]] = {}
        for key in live:
            for uuid in held[key]:
                owners.setdefault((self.pods[key], uuid), []).append(key)
        for (node, uuid), holders in owners.items():
            if len(holders) > 1:
                violations.append(f"double-hold: GPU {uuid} on {node} mounted in "
                                  f"{[f'{ns}/{p}' for ns, p in holders]}")
        for key in live:
            namespace, name = key
            leaked = held[key] - booked[key]
            if leaked:  # 2.
                violations.append(f"ownerless grant: {namespace}/{name} has injected node(s) "
                                  f"{sorted(leaked)} with no scheduler booking")
            phantom = booked[key] - held[key]
            if phantom:  # 3.
                violations.append(f"accounting mismatch: {namespace}/{name} books "
                                  f"{sorted(phantom)} but the node(s) are not mounted")
        # 4. every migration's journal is terminal and clean
        journals = self.app.migrations.list_migrations()
        for journal in journals:
            outcome = journal.get("outcome")
            if outcome not in ("succeeded", "rolled-back", "aborted") \
                    or journal.get("phase") != "done":
                violations.append(f"journal {journal.get('id')} not terminal/clean: "
                                  f"phase={journal.get('phase')} outcome={outcome} "
                                  f"error={journal.get('error')}")
        # 5.
        orphans = trace.TRACER.open_spans()
        if orphans:
            violations.append(f"orphan open span(s): {orphans}")
        # 6. every terminal journal has its record (a machine adopted after a
        # crash too), and every record an outcome and a trace id
        records = AUDIT.snapshot()
        migrate_ids = {r.get("details", {}).get("id") for r in records
                       if r["operation"] == "migrate"}
        for journal in journals:
            if journal.get("outcome") and journal["id"] not in migrate_ids:
                violations.append(f"migration {journal['id']} finished ({journal['outcome']}) "
                                  f"but left no terminal audit record")
        for rec in records:
            if not rec.get("outcome"):
                violations.append(f"audit record without outcome: seq={rec['seq']} "
                                  f"op={rec['operation']} pod={rec['pod']}")
            if not rec.get("trace_id"):
                violations.append(f"audit record without trace id: seq={rec['seq']} "
                                  f"op={rec['operation']} pod={rec['pod']}")
        # 8. two fresh collectors, the second a restarted one: the rollup is
        # keyed by node and the workers report absolute counters, so they
        # must agree
        rollups = [FleetCollector(self.app.registry, self.app._client_factory,
                                  cfg=self.cfg).collect_once() for _ in range(2)]
        expected_nodes = set(self.services) - self.dead_nodes
        for which, rollup in zip(("first", "second"), rollups):
            if set(rollup["nodes"]) - self.dead_nodes != expected_nodes:
                violations.append(f"fleet rollup ({which}) nodes {sorted(rollup['nodes'])} != "
                                  f"workers {sorted(expected_nodes)}")
            node_sum = sum(e.get("mount", {}).get("count", 0) for e in rollup["nodes"].values())
            if rollup["fleet"]["mount_count"] != node_sum:
                violations.append(f"fleet rollup ({which}) total "
                                  f"{rollup['fleet']['mount_count']} != per-node sum {node_sum} "
                                  f"(a node counted twice or dropped)")
        first, second = rollups
        for node in expected_nodes & set(first["nodes"]) & set(second["nodes"]):
            a = first["nodes"][node].get("mount", {}).get("count", 0)
            b = second["nodes"][node].get("mount", {}).get("count", 0)
            if a != b:
                violations.append(f"collector restart changed node {node} mount count {a} -> "
                                  f"{b} (rollup not restart-stable)")
        # 17. the capacity section of each live node's pull (the first
        # pass's) against the fake scheduler, by index: free, held and warm
        # together, fenced
        violations.extend(self._capacity_agreement(first, expected_nodes))
        # 13. after a terminal migration, heal or evacuation no tenant's
        # window is open, and every window of a signalled cause carries a
        # trace id that resolves in the ring
        if self.tenant_sims:
            from gpumounter_tpu_torch.torchside.telemetry import SIGNALLED_CAUSES
            for sim in self.tenant_sims.values():
                sim.settle()
                snap = sim.telemetry.snapshot()
                tenant = sim.telemetry.tenant
                for window in snap["disruption"]["open"]:
                    violations.append(f"tenant {tenant}: disruption window left open after "
                                      f"convergence: {window}")
                for window in snap["disruption"]["windows"]:
                    if window["cause"] not in SIGNALLED_CAUSES:
                        continue
                    if not window["trace_id"]:
                        violations.append(f"tenant {tenant}: {window['cause']} window without "
                                          f"a control-plane trace id (unattributed downtime): "
                                          f"{window}")
                    elif trace.trace_payload(window["trace_id"]) is None:
                        violations.append(f"tenant {tenant}: {window['cause']} window trace "
                                          f"{window['trace_id']} does not resolve in the trace "
                                          f"ring")
        # 16.
        for op in self.traced_ops:
            tree = assembly.assemble(op["trace"])
            if tree is None:
                violations.append(f"traced op {op['op']!r} (trace {op['trace']}) expired from "
                                  f"the span stores before assembly")
                continue
            if not tree["complete"]:
                violations.append(f"traced op {op['op']!r} (trace {op['trace']}) assembles "
                                  f"INCOMPLETE: {len(tree['orphans'])} orphan span(s) "
                                  f"{tree['orphans']}, {len(tree['missing_worker_halves'])} rpc "
                                  f"span(s) missing their worker half")
                continue
            phase_sum, wall = sum(tree["phases"].values()), tree["wall_ms"]
            if abs(phase_sum - wall) > max(2.0, 0.05 * wall):
                violations.append(f"traced op {op['op']!r} (trace {op['trace']}): critical-path "
                                  f"phase sum {phase_sum:.3f}ms != edge wall {wall:.3f}ms")
        # 10.
        if self.check_ledgers:
            for node, service in self.services.items():
                if node in self.dead_nodes:
                    continue
                open_txns = service.ledger.open_transactions()
                if open_txns:
                    violations.append(f"ledger on {node} left open txn(s) after convergence: "
                                      f"{[t['txn'] for t in open_txns]}")
                holdings = service.ledger.net_holdings()
                for key, node_of in self.pods.items():
                    if node_of != node:
                        continue
                    ledger_view = holdings.get(key, set())
                    if ledger_view != held[key]:
                        violations.append(f"ledger/mounts disagree for {key[0]}/{key[1]} on "
                                          f"{node}: ledger {sorted(ledger_view)} != mounted "
                                          f"{sorted(held[key])}")
                    if ledger_view != booked[key]:
                        violations.append(f"ledger/books disagree for {key[0]}/{key[1]} on "
                                          f"{node}: ledger {sorted(ledger_view)} != booked "
                                          f"{sorted(booked[key])}")
        # 19.
        if self.vchip_armed:
            violations.extend(self._share_agreement())
        # 20.
        if self.gray_armed:
            violations.extend(self._gray_attribution())
        # 22. the store's stream has settled once no index disagrees
        if self.watchstore_armed and self.watch_store is not None:
            deadline = time.monotonic() + 4.0
            while True:
                self.watch_store.quiesce(1.0)
                watch_diverged = self._watch_parity()
                if not watch_diverged or time.monotonic() > deadline:
                    break
            violations.extend(watch_diverged)
        # 7.
        stats = self.channel_pool.stats()
        if stats["dialed"] != stats["live"] + stats["closed"]:
            violations.append(f"channel-pool books off: dialed={stats['dialed']} != "
                              f"live={stats['live']} + closed={stats['closed']}")
        if stats["live"] > len(self.workers.ip_by_node):
            violations.append(f"channel leak: {stats['live']} live channel(s) for "
                              f"{len(self.workers.ip_by_node)} worker(s)")
        # 15.
        try:
            locks.RECORDER.assert_consistent()
        except locks.LockOrderViolation as exc:
            violations.append(f"lock-order: {exc}")
        if violations:
            raise InvariantViolation(
                f"chaos invariants violated (seed={self.seed}):\n- " + "\n- ".join(violations)
                + "\nschedule:\n  " + "\n  ".join(self.schedule))


    def _capacity_agreement(self, rollup: dict, nodes: set[str]) -> list[str]:
        """Invariant 17 over one collector pass's node entries."""
        out = []
        for node in sorted(nodes & set(rollup["nodes"])):
            cap = rollup["nodes"][node].get("capacity")
            if not isinstance(cap, dict):
                out.append(f"capacity divergence on {node}: node reported no capacity section")
                continue
            fake = self.cluster.node(node)
            index_of = {d.uuid: d.index for d in fake.backend.list_devices()}
            with self.cluster._alloc_lock:
                free_truth = sorted(index_of[u] for u in fake.free_ids())
                held_truth = sorted(index_of[u] for u, owner in fake.assignment.items()
                                    if owner is not None and u not in fake.dead)
                fenced_truth = sorted(index_of[u] for u in fake.dead)
            free = sorted(int(i) for i in cap.get("free") or [])
            booked = sorted([int(i) for i in cap.get("held") or {}]
                            + [int(i) for i in cap.get("warm") or []])
            fenced = sorted(int(i) for i in cap.get("fenced") or [])
            if free != free_truth:
                out.append(f"capacity divergence on {node}: reported free {free} != ground "
                           f"truth {free_truth}")
            if booked != held_truth:
                out.append(f"capacity divergence on {node}: reported held+warm {booked} != "
                           f"ground-truth bookings {held_truth}")
            if fenced != fenced_truth:
                out.append(f"capacity divergence on {node}: reported fenced {fenced} != "
                           f"ground-truth dead {fenced_truth}")
        return out

    def _share_agreement(self) -> list[str]:
        """Invariant 19: the master's books against each live tenant's ledger
        share records (value for value) and its policy entries (at the map's
        (major, minor) keys: the fake GPUs share device numbers, so distinct
        GPUs may land on one key, as in a kernel map; the weight equal, the
        metering alike, since the engine's tokens are spent), no engine
        scope without books; then the throttle's decisions."""
        out = []
        books = self.app.shares.books()
        for scope in POLICY_ENGINE.scopes():
            if scope not in books:
                out.append(f"policy engine scope {scope!r} has entries but no master share "
                           f"books (leaked policy)")
        for (ns, name), node in sorted(self.pods.items()):
            if node in self.dead_nodes:
                continue
            tenant = f"{ns}/{name}"
            want = books.get(tenant, {})
            service = self.services[node]
            ledger = (service.ledger.share_holdings().get((ns, name), {})
                      if service.ledger is not None else {})
            if set(want) != set(ledger):
                out.append(f"share books/ledger diverge for {tenant}: books {sorted(want)} != "
                           f"ledger {sorted(ledger)}")
            else:
                for uuid, value in sorted(want.items()):
                    if ledger[uuid] != value:
                        out.append(f"ledger share record diverges for {tenant} chip {uuid}: "
                                   f"{ledger[uuid]} != books {value}")
            devs = {d.uuid: d for d in self.cluster.node(node).backend.list_devices()}
            expected: dict[int, set[tuple[int, bool]]] = {}
            for uuid, (weight, budget) in want.items():
                dev = devs.get(uuid)
                if dev is None:
                    out.append(f"booked share chip {uuid} for {tenant} is not a device {node} "
                               f"has")
                    continue
                expected.setdefault(ebpf.telemetry_key(dev.major, dev.minor), set()).add(
                    (weight, budget > 0))
            entries = POLICY_ENGINE.entries(tenant)
            if set(entries) != set(expected):
                out.append(f"share policy keys diverge for {tenant}: books project to "
                           f"{sorted(hex(k) for k in expected)} != policy entries "
                           f"{sorted(hex(k) for k in entries)}")
                continue
            for key, value in sorted(entries.items()):
                got = (ebpf.policy_weight(value),
                       ebpf.policy_tokens(value) != ebpf.POLICY_UNMETERED)
                if got not in expected[key]:
                    out.append(f"share policy value diverges for {tenant} key {key:#x}: entry "
                               f"(weight, metered) {got} not among booked {expected[key]}")
        out.extend(self._throttle_agreement(books))
        return out

    def _throttle_agreement(self, books: dict) -> list[str]:
        """Invariant 19's decisions (``throttle_walk``) on the first metered
        share of the books: any access the engine and the device program
        decide apart, any access past the budget admitted, and any
        difference in the tokens left, are violations. The walk refills
        first, so a second check repeats it."""
        target = next(((tenant, uuid, weight) for tenant, held in sorted(books.items())
                       for uuid, (weight, budget) in sorted(held.items()) if budget > 0),
                      None)
        if target is None:
            return ["share scenario converged with no metered share left to probe throttling"]
        tenant, uuid, weight = target
        ns, name = tenant.split("/", 1)
        dev = next(d for d in self.cluster.node(self.pods[(ns, name)]).backend.list_devices()
                   if d.uuid == uuid)
        decisions, left_engine, left_kernel = throttle_walk(tenant, dev, weight, THROTTLE_TOKENS)
        out = []
        for step, (engine, kernel) in enumerate(decisions, start=1):
            if engine != kernel:
                out.append(f"throttle divergence for {tenant} chip {uuid} at access {step} of "
                           f"a {THROTTLE_TOKENS}-token budget: engine admits={engine} != "
                           f"in-kernel program admits={kernel}")
            if step > THROTTLE_TOKENS and kernel:
                out.append(f"tenant {tenant} chip {uuid} NOT throttled in-kernel past its "
                           f"{THROTTLE_TOKENS}-token budget (access {step} admitted)")
        if left_engine != left_kernel:
            out.append(f"throttle post-state diverges for {tenant} chip {uuid}: engine tokens "
                       f"left {left_engine} != map tokens left {left_kernel}")
        return out


#: the budget invariant 19's throttle walk refills a metered share to
THROTTLE_TOKENS = 3


def throttle_walk(tenant: str, dev, weight: int, tokens: int) -> tuple[list, int, int]:
    """A metered share refilled to `tokens` in the userspace engine and
    driven tokens + 2 times through the engine and through the interpreter
    running the real device program over dict maps: ([(engine admits,
    program admits)] an access, the engine's tokens left, the map's)."""
    key = ebpf.telemetry_key(dev.major, dev.minor)
    POLICY_ENGINE.refill(tenant, dev.major, dev.minor, tokens)
    tmap_fd, pmap_fd = 5, 7
    prog = ebpf.build_device_program((), telemetry_map_fd=tmap_fd, policy_map_fd=pmap_fd)
    maps = {tmap_fd: {key: 0}, pmap_fd: {key: ebpf.policy_value(weight, tokens)}}
    rw = ebpf.BPF_DEVCG_ACC_READ | ebpf.BPF_DEVCG_ACC_WRITE
    decisions = [(bool(POLICY_ENGINE.admit(tenant, dev.major, dev.minor)),
                  bool(interpret_device_program(prog, maps, ebpf.BPF_DEVCG_DEV_CHAR, rw,
                                                dev.major, dev.minor)))
                 for _ in range(tokens + 2)]
    return (decisions, ebpf.policy_tokens(POLICY_ENGINE.entries(tenant).get(key, 0)),
            ebpf.policy_tokens(maps[pmap_fd][key]))


# --- invariant 12: a stale shard owner, fenced (run on its own) ---

def run_fencing_scenario(seed: int, n_stale_ops: int = 6) -> list[str]:
    """A worker with its ledger on, over real gRPC; an old shard owner that
    goes on acting after it lost its lease; the new owner's traffic.
    Invariant: NO stale-epoch write is applied: every ghost mutation raises
    FencedError and changes nothing (the free GPUs and the pod's /dev are
    compared around each attempt), while the new owner's writes of the same
    shape land. The reference's draws, one for one. Raises
    InvariantViolation with the schedule on a breach; returns the schedule."""
    import tempfile

    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.master.shard import ShardManager
    from gpumounter_tpu_torch.rpc.resilience import FencedError
    from gpumounter_tpu_torch.worker.server import build_server

    rng = random.Random(seed)
    schedule: list[str] = []

    def record(event: str) -> None:
        schedule.append(event)
        logger.info("fencing-chaos[seed=%d] %s", seed, event)

    def fail(message: str) -> None:
        raise InvariantViolation(f"invariant 12 violated (seed={seed}): {message}\n"
                                 f"schedule:\n  " + "\n  ".join(schedule[-25:]))

    with tempfile.TemporaryDirectory() as root:
        cluster = FakeCluster.with_fake_gpus(os.path.join(root, "cluster"), 6)
        server = None
        try:
            cluster.cfg = dataclasses.replace(cluster.cfg,
                                              ledger_dir=os.path.join(root, "ledger"))
            dev_dir = os.path.join(root, "container-dev")
            os.makedirs(dev_dir, exist_ok=True)
            service = cluster.service(dev_dir)
            server = build_server(service, address="localhost:0")
            server.start()
            address = f"localhost:{server.bound_port}"
            cluster.add_target_pod("tenant")
            lease_cfg = dataclasses.replace(Config(), shard_count=1,
                                            shard_lease_duration_s=0.3, shard_preferred="")
            node = cluster.node_name
            old_owner = ShardManager(cluster.kube, cfg=lease_cfg, replica_id="ghost",
                                     advertise_url="http://ghost",
                                     preferred=None).start_without_loop()
            old_owner.acquire_once()
            stale_epoch = old_owner.node_epoch(node)
            if stale_epoch <= 0:
                fail("old owner acquired no epoch")
            with WorkerClient(address, cfg=cluster.cfg) as client:
                result = client.add_gpu("tenant", "default", 1, epoch=stale_epoch)
                record(f"old owner mounted 1 GPU at epoch {stale_epoch} -> "
                       f"{AddGPUResult(result.add_gpu_result).name}")
                # the partition: the ghost renews no more but goes on acting,
                # and a new replica takes the lease over after its expiry
                new_owner = ShardManager(cluster.kube, cfg=lease_cfg, replica_id="successor",
                                         advertise_url="http://successor",
                                         preferred=None).start_without_loop()
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and not new_owner.owned_shards():
                    new_owner.acquire_once()
                    time.sleep(0.05)
                fresh_epoch = new_owner.node_epoch(node)
                if fresh_epoch <= stale_epoch:
                    fail(f"takeover epoch {fresh_epoch} not newer than {stale_epoch}")
                record(f"takeover: successor owns at epoch {fresh_epoch}")
                # the new owner touches the node once: the worker keeps the
                # fresh epoch in its ledger from then on
                result = client.add_gpu("tenant", "default", 1, epoch=fresh_epoch)
                record(f"new owner mounted at epoch {fresh_epoch} -> "
                       f"{AddGPUResult(result.add_gpu_result).name}")

                def state() -> tuple[int, tuple[str, ...]]:
                    return cluster.free_gpu_count(), tuple(sorted(os.listdir(dev_dir)))

                for op_index in range(n_stale_ops):
                    before = state()
                    kind = rng.choice(["add", "remove"])
                    try:
                        if kind == "add":
                            client.add_gpu("tenant", "default", rng.randint(1, 2),
                                           epoch=stale_epoch)
                        else:
                            client.remove_gpu("tenant", "default", [], force=True,
                                              remove_all=True, epoch=stale_epoch)
                        fail(f"stale {kind} (epoch {stale_epoch}) was APPLIED at op {op_index}")
                    except FencedError:
                        record(f"stale {kind} -> FENCED (op {op_index})")
                    if state() != before:
                        fail(f"stale {kind} changed node state at op {op_index}: "
                             f"{before} -> {state()}")
                    if rng.random() < 0.5:
                        # the live owner's traffic: fencing is selective, not
                        # a lockdown of the node
                        result = client.add_gpu("tenant", "default", 1, epoch=fresh_epoch)
                        record(f"new owner add -> {AddGPUResult(result.add_gpu_result).name}")
                if service.ledger.epoch() != fresh_epoch:
                    fail(f"worker persisted epoch {service.ledger.epoch()} != {fresh_epoch}")
            record("fencing held: no stale-epoch write applied")
        finally:
            if server is not None:
                server.stop(None).wait()
            cluster.stop()
    return schedule


# --- invariant 9: one shard owner a node (master/shard.py) ---

def run_shard_scenario(seed: int, shard_count: int = 5, replicas: int = 3, n_ops: int = 40,
                       lease_duration_s: float = 0.35) -> list[str]:
    """Seeded lease chaos over the fake API server: master replicas claim and
    renew shard leases while the schedule crashes them (a ghost goes on
    BELIEVING it owns until its claim expires: the dangerous window),
    restarts them (same identity, a fresh process) and lets leases expire.
    After EVERY step, over every view, live and ghost:

      * no shard is claimed by two replicas at once (and since the ring maps
        each node to one shard, no node has two owners);
      * every manager maps nodes to shards alike.

    Then, with the crashes over, the live managers' passes must end with
    every shard held by one live replica. The reference's draws, one for
    one. Raises InvariantViolation with the schedule; returns the schedule."""
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.master.shard import ShardManager

    rng = random.Random(seed)
    schedule: list[str] = []
    cfg = dataclasses.replace(Config(), shard_count=shard_count,
                              shard_lease_duration_s=lease_duration_s, shard_preferred="")
    kube = FakeKubeClient()
    next_instance = iter(range(10_000))

    def new_manager(replica: str) -> ShardManager:
        return ShardManager(kube, cfg=cfg, replica_id=replica,
                            advertise_url=f"http://{replica}:8080",
                            preferred=None).start_without_loop()

    live: dict[str, ShardManager] = {f"rep-{i}": new_manager(f"rep-{i}")
                                     for i in range(replicas)}
    #: crashed but partitioned views: their last owned_shards() is what a
    #: paused master would still act on
    ghosts: dict[str, ShardManager] = {}
    nodes = [f"storm-node-{j}" for j in range(64)]

    def record(event: str) -> None:
        schedule.append(event)
        logger.info("shard-chaos[seed=%d] %s", seed, event)

    def check(context: str) -> None:
        by_shard: dict[int, list[str]] = {}
        views = list(live.values()) + list(ghosts.values())
        for view in views:
            for s in view.owned_shards():
                by_shard.setdefault(s, []).append(view.replica_id)
        violations = [f"shard {s} owned by {sorted(owners)} simultaneously"
                      for s, owners in by_shard.items() if len(set(owners)) > 1]
        if len({tuple(v.ring.owner_of(n) for n in nodes) for v in views}) > 1:
            violations.append("replicas disagree on node->shard mapping")
        if violations:
            raise InvariantViolation(
                f"invariant 9 violated at {context} (seed={seed}):\n- " + "\n- ".join(violations)
                + "\nschedule tail:\n  " + "\n  ".join(schedule[-25:]))

    for op_index in range(n_ops):
        roll = rng.random()
        if roll < 0.15 and len(live) > 1:
            victim = rng.choice(sorted(live))
            ghosts[f"{victim}#{next(next_instance)}"] = live.pop(victim)
            record(f"crash {victim} (ghost keeps its claim view)")
        elif roll < 0.30 and ghosts:
            # a restart: the old process is gone once its replacement runs
            # (one pod name runs once), so the ghost retires and a fresh
            # manager of the same identity comes back
            ghost = ghosts.pop(rng.choice(sorted(ghosts)))
            if ghost.replica_id not in live:
                live[ghost.replica_id] = new_manager(ghost.replica_id)
                record(f"restart {ghost.replica_id} (fresh process, same id)")
        elif roll < 0.45:
            time.sleep(rng.uniform(0.05, lease_duration_s * 1.2))
            record("sleep (leases age toward expiry)")
        else:
            replica = rng.choice(sorted(live))
            newly = live[replica].acquire_once()
            record(f"acquire pass on {replica} -> newly {sorted(newly)}")
        check(f"op {op_index}")

    deadline = time.monotonic() + 30.0
    owned: set[int] = set()
    while time.monotonic() < deadline:
        for manager in live.values():
            manager.acquire_once()
        check("convergence")
        owned = set()
        for manager in live.values():
            owned |= manager.owned_shards()
        if owned == set(range(shard_count)):
            break
        time.sleep(0.05)
    else:
        raise InvariantViolation(
            f"shards never fully re-owned after chaos (seed={seed}): missing "
            f"{set(range(shard_count)) - owned}\nschedule:\n  " + "\n  ".join(schedule[-25:]))
    check("final")
    record(f"converged: all {shard_count} shards owned by {sorted(live)}")
    return schedule
