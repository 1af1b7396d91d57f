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

The reference's invariants 4 and 7-22 come with their packages.

Every fault is a count-limited one-shot armed just before its operation and
disarmed right after it, so none leaks into the check. The pool is the
reference's ``FAULTS_COMMON`` without its two ``crash`` terms
(``worker.mount.before_grant`` and ``after_grant``): a simulated death
leaves grants or slave pods that only a repair plane converges, the
worker's ledger replay or the elastic reconciler, which the port has not
yet. Without them every operation is all or nothing, and the check needs no
convergence beyond the slave pods' releases landing.

All randomness comes from ``random.Random(seed)``; the schedule is logged
step by step and an ``InvariantViolation`` carries the seed and the
schedule, so a failing run replays from its seed.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

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
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget
from gpumounter_tpu_torch.worker.server import GpuMountService, build_server

logger = get_logger("testing.chaos")

NODE_A, NODE_B = "chaos-a", "chaos-b"

#: (failpoint, action) pairs the scenario draws from: the reference's
#: FAULTS_COMMON without its crash terms (see the module's docstring). All
#: count-limited, so an armed fault that did not fire cannot outlive its
#: operation.
FAULTS_COMMON = [
    ("rpc.client.call", "1*unavailable(chaos drop)"),
    ("rpc.client.call", "1*delay(0.05)"),
    ("worker.rpc", "1*delay(0.05)"),
    ("worker.mount.mknod", "1*error(chaos mknod)"),
    ("worker.mount.mknod", "1*pass->1*error(chaos mknod 2nd)"),
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
        self.services: dict[str, GpuMountService] = {}
        self._servers: list = []
        self._port_by_ip: dict[str, int] = {}
        self.channel_pool = ChannelPool(cfg=self.cfg)
        #: (namespace, pod) -> node, for every target pod made
        self.pods: dict[tuple[str, str], str] = {}
        self.app: MasterApp | None = None

    # --- lifecycle ---

    def _dev_root(self, node: str) -> str:
        return os.path.join(self.root, f"container-dev-{node}")

    def start(self) -> "ChaosHarness":
        # this run's spans, records and timeline only
        trace.TRACER.reset()
        AUDIT.reset()
        FLIGHT.reset()
        for i, name in enumerate(self.cluster.node_names):
            node = self.cluster.node(name)
            collector = GpuCollector(node.backend, node.kubelet, cfg=self.cfg)
            mounter = _PodDirMounter(node.backend, self._dev_root(name), cfg=self.cfg,
                                     kube=self.cluster.kube)
            service = GpuMountService(self.cluster.kube, collector, mounter=mounter,
                                      cfg=self.cfg)
            server = build_server(service, address="localhost:0")
            server.start()
            self.services[name] = service
            self._servers.append(server)
            ip = f"10.9.0.{i + 1}"
            self._port_by_ip[ip] = server.bound_port
            self.cluster.register_worker(ip, node=name)

        def client_factory(address: str) -> WorkerClient:
            port = self._port_by_ip[address.rsplit(":", 1)[0]]
            return WorkerClient(f"localhost:{port}", cfg=self.cfg, channel_pool=self.channel_pool)

        self.app = MasterApp(self.cluster.kube, cfg=self.cfg,
                             worker_client_factory=client_factory)
        return self

    def stop(self) -> None:
        failpoints.disarm_all()
        if self.app is not None:
            self.app.registry.stop()
        self.channel_pool.close_all()
        for server in self._servers:
            server.stop(grace=None)
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

    def converge(self, timeout_s: float = 10.0) -> None:
        """Disarm everything and wait for the slave pods' releases to land.
        Every operation is all or nothing here; a repair plane comes with
        the worker's ledger and the elastic reconciler."""
        failpoints.disarm_all()
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
        if violations:
            raise InvariantViolation(
                f"chaos invariants violated (seed={self.seed}):\n- " + "\n- ".join(violations)
                + "\nschedule:\n  " + "\n  ".join(self.schedule))
