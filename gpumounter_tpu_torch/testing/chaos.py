"""Seeded chaos over the fake cluster: the port's base harness.

The counterpart of ``gpumounter_tpu/testing/chaos.py``'s ``ChaosHarness``
for the packages the port has. It runs the real control plane (``MasterApp``
and its slice coordinator, over real gRPC to one worker server a node on
localhost) on a two-node ``testing/cluster.py`` fleet, under a failpoint
schedule drawn from one seed, then checks the global invariants:

  1. no GPU held by two pods (no node of one GPU in two pods' /dev),
  2. no ownerless grant (every injected node is backed by a booking of the
     scheduler: a node without one is a leaked mount),
  3. books against mounts (every GPU booked to a pod is mounted in it),
  5. no open span: every span entered was exited, through injected
     failures too,
  6. every audit record carries an outcome and a trace id. The reference's
     other half of 6 (each terminal migration has its record) waits for the
     migration machine.
 10. ledger agreement (``run_worker_crash_scenario``): after a worker death
     at any seeded site of a mount batch, a restart and the ledger's replay
     (``worker/resync.py``), books == mounts == ledger on every node: no
     open txn, and each pod's net holdings equal its injected nodes and its
     bookings.

The reference's invariants 4, 7-9 and 11-22 come with their packages.

Every node's worker keeps its ledger in a directory of the run; building a
second service over it is the worker's restart (``restart_worker``). Every
fault is a count-limited one-shot armed just before its operation and
disarmed right after it, so none leaks into the check. The pool is the
reference's ``FAULTS_COMMON``, its two ``crash`` terms
(``worker.mount.before_grant`` and ``after_grant``) among them: a simulated
death leaves grants or slave pods, which ``converge`` hands to the ledger's
replay, restarting every worker whose ledger holds an open txn (the
reference converges the mount scenario through its elastic intents, which
come with the reconciler). The crash scenario's intents and ``reconcile``
steps are left out for the same reason; a forced remove takes the
reconcile's share of its draws.

All randomness comes from ``random.Random(seed)``; the schedule is logged
step by step and an ``InvariantViolation`` carries the seed and the
schedule, so a failing run replays from its seed.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.client import NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.app import MasterApp
from gpumounter_tpu_torch.master.slice_ops import SliceCoordinator, SliceTarget
from gpumounter_tpu_torch.nsutil.ns import device_node_path
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.rpc.client import ChannelPool, WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster, WorkerServers
from gpumounter_tpu_torch.utils.log import get_logger
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


class InvariantViolation(AssertionError):
    """A global invariant did not hold after the scenario."""


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
        # purpose and the breaker has tests of its own
        self.cfg = dataclasses.replace(self.cluster.cfg, rpc_retry_base_s=0.02,
                                       rpc_retry_cap_s=0.1, breaker_failure_threshold=50)
        self.workers = WorkerServers(self._build_node_service, host="localhost")
        self.services: dict[str, GpuMountService] = self.workers.services
        self.channel_pool = ChannelPool(cfg=self.cfg)
        #: (namespace, pod) -> node, for every target pod made
        self.pods: dict[tuple[str, str], str] = {}
        self.app: MasterApp | None = None
        #: run_worker_crash_scenario sets it: check_invariants then holds
        #: invariant 10 too
        self.check_ledgers = False

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
        # this run's spans, records, timeline and policies only
        trace.TRACER.reset()
        AUDIT.reset()
        FLIGHT.reset()
        POLICY_ENGINE.reset()
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

    def stop(self) -> None:
        failpoints.disarm_all()
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

    def _op(self, description: str, fn, fault_p: float = 0.7) -> None:
        """One operation: maybe arm a fault from the pool, run, log the
        outcome, disarm whatever did not fire."""
        if self.rng.random() < fault_p:
            name, action = self.rng.choice(FAULTS_COMMON)
            self.record(f"arm {name}={action}")
            failpoints.arm(name, action)
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — the failures are the test
            self.record(f"{description} -> {type(exc).__name__}: {exc}")
        else:
            self.record(f"{description} -> ok")
        finally:
            failpoints.disarm_all()

    # --- the scenario ---

    def run_mount_scenario(self, n_ops: int = 8) -> None:
        """Adds (a slice of one pod, 1 or 2 single mounts) and forced removes
        of one held GPU, on three pods (two share NODE_A, so that invariant
        1 has teeth), each under a fault drawn from the pool."""
        pods = [("default", "m-a", NODE_A), ("default", "m-b", NODE_B),
                ("default", "m-c", NODE_A)]
        for ns, name, node in pods:
            self.add_pod(name, node, namespace=ns)
        for _ in range(n_ops):
            ns, name, node = self.rng.choice(pods)
            if self.rng.choice(["add", "remove"]) == "add":
                n = self.rng.randint(1, 2)
                self._op(f"add {n} to {name}",
                         lambda t=SliceTarget(namespace=ns, pod=name), n=n:
                         self.coordinator().mount_slice([t], n, entire=False))
                continue
            held = sorted(self.held_gpus()[(ns, name)])
            if not held:
                continue
            uuid = self.rng.choice(held)

            def _remove(ns=ns, name=name, node=node, uuid=uuid):
                with self.client_for_node(node) as client:
                    client.remove_gpu(name, ns, [uuid], force=True)

            self._op(f"remove {uuid} from {name}", _remove)
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
                held = sorted(self.held_gpus()[(ns, name)])
                if not held:
                    continue
                uuid = self.rng.choice(held)

                def _remove(ns=ns, name=name, node=node, uuid=uuid):
                    with self.client_for_node(node) as client:
                        client.remove_gpu(name, ns, [uuid], force=True)

                self._op(f"remove {uuid} from {name}", _remove, fault_p=0.0)
        self.converge()

    def converge(self, timeout_s: float = 10.0) -> None:
        """Disarm everything, restart every worker whose ledger holds an
        open txn (a simulated death's: its replay converges it), and wait
        for the slave pods' releases to land."""
        failpoints.disarm_all()
        for name, service in list(self.services.items()):
            if service.ledger is not None and service.ledger.open_transactions():
                self.restart_worker(name)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and self.held_gpus() != self.booked_gpus():
            time.sleep(0.02)

    # --- what the tenants see, what the books say ---

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
        # 1. a GPU is (node, uuid): the fake nodes reuse UUIDs
        owners: dict[tuple[str, str], list[tuple[str, str]]] = {}
        for key, uuids in held.items():
            for uuid in uuids:
                owners.setdefault((self.pods[key], uuid), []).append(key)
        for (node, uuid), holders in owners.items():
            if len(holders) > 1:
                violations.append(f"double-hold: GPU {uuid} on {node} mounted in "
                                  f"{[f'{ns}/{p}' for ns, p in holders]}")
        for key in self.pods:
            namespace, name = key
            leaked = held[key] - booked[key]
            if leaked:  # 2.
                violations.append(f"ownerless grant: {namespace}/{name} has injected node(s) "
                                  f"{sorted(leaked)} with no scheduler booking")
            phantom = booked[key] - held[key]
            if phantom:  # 3.
                violations.append(f"accounting mismatch: {namespace}/{name} books "
                                  f"{sorted(phantom)} but the node(s) are not mounted")
        # 5.
        orphans = trace.TRACER.open_spans()
        if orphans:
            violations.append(f"orphan open span(s): {orphans}")
        # 6.
        for rec in AUDIT.snapshot():
            if not rec.get("outcome"):
                violations.append(f"audit record without outcome: seq={rec['seq']} "
                                  f"op={rec['operation']} pod={rec['pod']}")
            if not rec.get("trace_id"):
                violations.append(f"audit record without trace id: seq={rec['seq']} "
                                  f"op={rec['operation']} pod={rec['pod']}")
        # 10.
        if self.check_ledgers:
            for node, service in self.services.items():
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
        if violations:
            raise InvariantViolation(
                f"chaos invariants violated (seed={self.seed}):\n- " + "\n- ".join(violations)
                + "\nschedule:\n  " + "\n  ".join(self.schedule))
