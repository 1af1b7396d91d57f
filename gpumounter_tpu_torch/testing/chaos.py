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
 7. the channel pool's books: every channel dialed is live or closed, and
     no more are live than there are workers,
 10. ledger agreement (``run_worker_crash_scenario``): after a worker death
     at any seeded site of a mount batch, a restart and the ledger's replay
     (``worker/resync.py``), books == mounts == ledger on every node: no
     open txn, and each pod's net holdings equal its injected nodes and its
     bookings,
 15. lock order: the nested ``OrderedLock`` / ``OrderedCondition``
     acquisitions the whole run observed form no cycle,
 22. watch-store parity (``run_watch_store_scenario``): after a severed
     watch with a storm past the backlog (a 410), a restart and steady
     churn, the ``WatchMasterStore``'s indexes equal a fresh list-backed
     view of the same cluster.

Two more run on their own, not on the harness: ``run_fencing_scenario``
(invariant 12, no stale-epoch write applied) and ``run_shard_scenario``
(invariant 9, one owner a shard). The reference's invariants 4, 8, 11, 13,
14 and 16-21 come with their packages.

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
from gpumounter_tpu_torch.rpc.api import AddGPUResult
from gpumounter_tpu_torch.rpc.client import ChannelPool, WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster, WorkerServers
from gpumounter_tpu_torch.utils import locks
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
