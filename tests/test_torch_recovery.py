"""The recovery controller (``gpumounter_tpu_torch/recovery/controller.py``)
against the reference's (``gpumounter_tpu/recovery/controller.py``).

Each case of ``tests/test_recovery.py`` is a function of a side, run on both
packages over each one's fake API, worker registry and store, with the
reference's stubs for the liveness probe, the elastic intents and the
migrations (the stubs drive the intent re-drive, the disruption stamp and
its Event). What each side returns must be equal, the reference's Event
reason read with the GPU name (``GPUNodeEvacuated``, ROADMAP §3), and the
reference test's expectations must hold on the port's. Every case runs again
with each side's real ``ElasticReconciler`` and ``MigrationCoordinator`` as
the controller's hooks, as ``MasterApp`` wires them: the evacuation enqueues
the real reconciler's key and drives the real machine's resume scan.
"""

from __future__ import annotations

import dataclasses
import json
import time
import types

import pytest
from conftest import AUTH_HEADER
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.allocator import pool as ref_pool
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.elastic import ElasticReconciler as RefReconciler
from gpumounter_tpu.elastic.intents import Intent as RefIntent
from gpumounter_tpu.health import HealthPlane as RefHealthPlane
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
from gpumounter_tpu.master.app import MasterApp as RefApp
from gpumounter_tpu.master.app import WorkerRegistry as RefRegistry
from gpumounter_tpu.migrate import MigrationCoordinator as RefMigrations
from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
from gpumounter_tpu.recovery import RecoveryController as RefController
from gpumounter_tpu.recovery import controller as ref_controller
from gpumounter_tpu.rpc.resilience import WorkerUnavailableError as RefUnavailable
from gpumounter_tpu.store import KubeMasterStore as RefStore
from gpumounter_tpu.worker.reaper import SlaveReaper as RefReaper
from gpumounter_tpu_torch.allocator import pool
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.elastic import ElasticReconciler
from gpumounter_tpu_torch.elastic.intents import Intent
from gpumounter_tpu_torch.health import HealthPlane
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.master.app import MasterApp, WorkerRegistry
from gpumounter_tpu_torch.migrate import MigrationCoordinator
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.recovery import RecoveryController
from gpumounter_tpu_torch.recovery import controller
from gpumounter_tpu_torch.rpc.resilience import WorkerUnavailableError
from gpumounter_tpu_torch.store import KubeMasterStore
from gpumounter_tpu_torch.worker.reaper import SlaveReaper

NODE = "recovery-node-a"
OTHER = "recovery-node-b"

SIDES = {
    "reference": types.SimpleNamespace(
        kind="reference", cfg=lambda **kw: RefConfig().replace(**kw), Fake=RefFake,
        Registry=RefRegistry, Controller=RefController, controller=ref_controller,
        Unavailable=RefUnavailable, Store=RefStore, Intent=RefIntent, Plane=RefHealthPlane,
        Reconciler=RefReconciler, Migrations=RefMigrations,
        App=RefApp, AUDIT=REF_AUDIT, Reaper=RefReaper, pool=ref_pool,
        worker_labels={"app": "tpu-mounter-worker"}, pool_app="tpu-pool"),
    "port": types.SimpleNamespace(
        kind="port", cfg=lambda **kw: dataclasses.replace(Config(), **kw), Fake=FakeKubeClient,
        Registry=WorkerRegistry, Controller=RecoveryController, controller=controller,
        Unavailable=WorkerUnavailableError, Store=KubeMasterStore, Intent=Intent,
        Plane=HealthPlane, App=MasterApp, AUDIT=AUDIT, Reaper=SlaveReaper, pool=pool,
        Reconciler=ElasticReconciler, Migrations=MigrationCoordinator,
        worker_labels={"app": "gpu-mounter-worker"}, pool_app="gpu-pool"),
}


class _StubClientFactory:
    """The liveness probe's stand-in: an address in `dead` refuses, the
    rest answer (any answer is alive)."""

    def __init__(self, unavailable):
        self.unavailable = unavailable
        self.dead: set[str] = set()
        self.probes: list[str] = []

    def __call__(self, address):
        factory = self

        class _Client:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def collect_telemetry(self, timeout_s=None):
                factory.probes.append(address)
                if address in factory.dead:
                    raise factory.unavailable("refused", address, "CollectTelemetry")
                return types.SimpleNamespace(telemetry="{}")

        return _Client()


class _ElasticStub:
    def __init__(self, intents):
        self._intents = intents
        self.enqueued: list[tuple[str, str]] = []
        self.store = self

    def list(self):
        return self._intents

    def enqueue(self, namespace, pod, priority=0):
        self.enqueued.append((namespace, pod))


class _MigrationsStub:
    def __init__(self):
        self.resumes = 0

    def resume_interrupted(self):
        self.resumes += 1
        return []


class _RealElastic:
    """The side's ``ElasticReconciler`` behind the stub's surface: the
    intents are declared on the pods, and `enqueued` drains its queue."""

    def __init__(self, rec):
        self.rec = rec

    @property
    def _intents(self):
        return self.rec.store.list()

    @_intents.setter
    def _intents(self, intents):
        for namespace, pod, intent in intents:
            self.rec.store.put(namespace, pod, intent)

    @property
    def enqueued(self) -> list[tuple[str, str]]:
        keys = []
        while self.rec.queue.depth():
            keys.append(tuple(self.rec.queue.get(1.0).split("/", 1)))
        return keys


class _RealMigrations:
    """The side's ``MigrationCoordinator``, its resume scans counted."""

    def __init__(self, coordinator):
        self.coordinator = coordinator
        self.resumes = 0

    def resume_interrupted(self):
        self.resumes += 1
        return self.coordinator.resume_interrupted()


class _Stack:
    """tests/test_recovery.py's fixture, for one side."""

    def __init__(self, side, real: bool = False):
        self.side = side
        self.cfg = side.cfg(recovery_confirm_failures=2, recovery_grace_s=0.0,
                            recovery_probe_timeout_s=1.0)
        self.kube = side.Fake()
        for node, ip in ((NODE, "10.0.0.1"), (OTHER, "10.0.0.2")):
            self.kube.create_node(node, ready=True)
            self.kube.create_pod(self.cfg.worker_namespace, {
                "metadata": {"name": f"w-{node}", "namespace": self.cfg.worker_namespace,
                             "labels": dict(side.worker_labels)},
                "spec": {"nodeName": node, "containers": [{"name": "w"}]},
                "status": {"phase": "Running", "podIP": ip}})
        self.registry = side.Registry(self.kube, self.cfg)
        self.factory = _StubClientFactory(side.Unavailable)
        if real:
            self.elastic = _RealElastic(side.Reconciler(self.kube, self.registry, self.factory,
                                                        cfg=self.cfg))
            self.migrations = _RealMigrations(side.Migrations(
                self.kube, self.registry, self.factory, cfg=self.cfg,
                store=side.Store(self.kube, self.cfg)))
            hooks = dict(elastic=self.elastic.rec, migrations=self.migrations)
        else:
            self.elastic = _ElasticStub([])
            self.migrations = _MigrationsStub()
            hooks = dict(elastic=self.elastic, migrations=self.migrations)
        self.controller = side.Controller(self.kube, self.registry, self.factory, cfg=self.cfg,
                                          store=side.Store(self.kube, self.cfg), **hooks)

    def addr(self, node):
        pod = self.kube.get_pod(self.cfg.worker_namespace, f"w-{node}")
        return f"{pod['status']['podIP']}:{self.cfg.worker_port}"

    def pool_pod(self, name, node, warm=False, owner=None):
        labels = {"app": self.side.pool_app}
        annotations = {}
        if warm:
            labels["tpumounter.io/warm"] = "true"
        if owner is not None:
            labels.update({"tpumounter.io/owner-uid": owner.get("uid", "u"),
                           "tpumounter.io/owner": owner["name"],
                           "tpumounter.io/owner-namespace": owner["ns"]})
            annotations = {"tpumounter.io/owner": owner["name"],
                           "tpumounter.io/owner-namespace": owner["ns"]}
        self.kube.create_pod(self.cfg.pool_namespace, {
            "metadata": {"name": name, "namespace": self.cfg.pool_namespace,
                         "labels": labels, "annotations": annotations},
            "spec": {"nodeName": node, "nodeSelector": {"kubernetes.io/hostname": node},
                     "containers": [{"name": "p"}]},
            "status": {"phase": "Running"}})

    def plane(self, store=None):
        plane = self.side.Plane(self.cfg.replace(health_enabled=True)
                                if self.side.kind == "reference" else
                                dataclasses.replace(self.cfg, health_enabled=True),
                                recovery=self.controller, store=store)
        self.controller.health = plane
        return plane

    def close(self):
        self.registry.stop()


def _status(stack, node):
    return stack.controller.payload()["nodes"].get(node, {}).get("status")


def _evacuations(stack):
    """The evacuation records without their clocks."""
    return [{k: v for k, v in e.items() if k not in ("at", "duration_s")}
            for e in stack.controller.payload()["evacuations"]]


# --- the cases ---

def healthy_nodes_stay_healthy(s):
    out = s.controller.check_once()
    return out, {n: e["status"] for n, e in s.controller.payload()["nodes"].items()}, \
        s.controller.payload()["evacuations"]


def ready_node_with_dead_worker_is_never_evacuated(s):
    s.factory.dead.add(s.addr(NODE))
    outs = [s.controller.check_once()["evacuated"] for _ in range(6)]
    return outs, s.controller.payload()["nodes"][NODE]


def confirmed_node_death_evacuates(s):
    for name in ("t1-slave-pod-aa", "t1-slave-pod-bb", "warm-slave-cc"):
        s.pool_pod(name, NODE)
    s.kube.create_pod("default", {"metadata": {"name": "tenant", "namespace": "default"},
                                  "spec": {"nodeName": NODE, "containers": [{"name": "m"}]},
                                  "status": {"phase": "Running"}})
    s.elastic._intents = [("default", "tenant", s.side.Intent(desired_chips=2, min_chips=1))]
    s.factory.dead.add(s.addr(NODE))
    s.kube.set_node_ready(NODE, False, reason="KubeletStopped")
    evacuated = [n for _ in range(3) for n in s.controller.check_once()["evacuated"]]
    marker = json.loads(s.kube.get_pod("default", "tenant")["metadata"]["annotations"][
        s.side.controller.ANNOT_DISRUPTION])
    events = [(m.get("reason").replace("TPU", "GPU"), m["involvedObject"]["name"], m["type"],
               m["message"]) for _, m in s.kube.events_posted]
    return (evacuated, s.kube.list_pods(s.cfg.pool_namespace), s.elastic.enqueued,
            s.migrations.resumes, _evacuations(s), _status(s, NODE), _status(s, OTHER),
            events, (marker["seq"], marker["cause"], marker["node"], bool(marker["trace_id"])),
            s.controller.check_once()["evacuated"])


def worker_gone_without_node_object_evacuates(s):
    s.kube.delete_node(NODE)
    s.registry.registry_snapshot()
    s.controller.check_once()
    s.kube.delete_pod(s.cfg.worker_namespace, f"w-{NODE}")
    deadline = time.monotonic() + 5.0
    evacuated = []
    while time.monotonic() < deadline and not evacuated:
        evacuated = s.controller.check_once()["evacuated"]
        time.sleep(0.05)
    return evacuated, _evacuations(s)[0]["reason"]


def evacuated_node_coming_back_is_tracked_again(s):
    address = s.addr(NODE)
    s.factory.dead.add(address)
    s.kube.set_node_ready(NODE, False)
    for _ in range(3):
        s.controller.check_once()
    before = _status(s, NODE)
    s.factory.dead.discard(address)
    s.kube.set_node_ready(NODE, True)
    s.controller.check_once()
    return before, _status(s, NODE)


def sharded_controller_skips_unowned_nodes(s):
    class _Shards:
        def active(self):
            return True

        def owns_node(self, node):
            return node == OTHER

    s.controller.shards = _Shards()
    s.factory.dead.add(s.addr(NODE))
    s.kube.set_node_ready(NODE, False)
    outs = [s.controller.check_once() for _ in range(4)]
    return outs, sorted(s.controller.payload()["nodes"]), sorted(set(s.factory.probes))


def api_partition_does_not_evacuate(s):
    s.registry.registry_snapshot()
    s.factory.dead.add(s.addr(NODE))
    s.kube.set_partitioned(True)
    try:
        outs = [s.controller.check_once()["evacuated"] for _ in range(5)]
        status = _status(s, NODE)
    finally:
        s.kube.set_partitioned(False)
    return outs, status


def evacuated_unregistered_node_is_pruned(s):
    s.kube.delete_pod(s.cfg.worker_namespace, f"w-{NODE}")
    s.kube.delete_node(NODE)
    s.registry.registry_snapshot()
    s.controller.evacuate(NODE, reason="test")
    s.controller.check_once()
    before = _status(s, NODE)
    with s.controller._lock:
        s.controller._nodes[NODE]["evacuated_at"] -= s.controller.EVACUATED_RETENTION_S + 1
    s.controller.check_once()
    return before, NODE in s.controller.payload()["nodes"], [e["node"] for e in _evacuations(s)]


def recovery_routes(s):
    s.side.AUDIT.reset()
    app = s.side.App(s.kube, cfg=s.cfg, worker_client_factory=s.factory, registry=s.registry)
    app.recovery = s.controller  # the stubs, wired before
    answers = []
    for method, path, headers in (("GET", "/recovery", AUTH_HEADER), ("GET", "/recovery", {}),
                                  ("POST", f"/recovery/evacuate/{NODE}", AUTH_HEADER),
                                  ("POST", f"/recovery/evacuate/{NODE}", {})):
        status, _, body, _ = app.handle(method, path, b"", dict(headers))
        try:
            doc = json.loads(body)
        except ValueError:
            doc = body.strip()
        if isinstance(doc, dict):
            doc = {k: v for k, v in doc.items() if k not in ("at", "duration_s", "evacuations")}
        answers.append((status, doc))
    ops = sorted({r["operation"] for r in s.side.AUDIT.snapshot()})
    if s.side.kind == "port":
        app.close()
    return answers, _status(s, NODE), ops


def reaper_after_evacuation_no_double_free(s):
    s.pool_pod("dead-slave", NODE, owner={"name": "gone-owner", "ns": "default", "uid": "u1"})
    s.controller.evacuate(NODE, reason="test")
    left = s.kube.list_pods(s.cfg.pool_namespace)
    deletes = s.kube.delete_calls
    reaped = s.side.Reaper(s.kube, cfg=s.cfg).reap_once()
    return left, reaped, s.kube.delete_calls - deletes


def warm_pool_does_not_readopt_evacuated_holders(s):
    s.pool_pod("warm-1", NODE, warm=True)
    s.pool_pod("warm-2", NODE, warm=True)
    s.controller.evacuate(NODE, reason="test")
    cfg = (s.cfg.replace(warm_pool_size=2) if s.side.kind == "reference"
           else dataclasses.replace(s.cfg, warm_pool_size=2))
    warm = s.side.pool.WarmPodPool(s.kube, cfg=cfg, refill_async=False)
    warm.ensure_node(NODE)
    ready = warm.ready_count(NODE)
    warm.stop()
    return ready


def quarantined_is_not_dead(s):
    plane = s.plane()
    plane.quarantine(NODE, reason="limping", actor="test")
    outs = [s.controller.check_once()["evacuated"] for _ in range(4)]
    return outs, s.controller.payload()["nodes"][NODE], \
        s.controller.payload()["nodes"][OTHER]["quarantined"]


def quarantined_node_that_then_dies_is_evacuated_normally(s):
    plane = s.plane()
    plane.quarantine(NODE, reason="limping", actor="test")
    s.factory.dead.add(s.addr(NODE))
    s.kube.set_node_ready(NODE, False, reason="KubeletStopped")
    evacuated = [n for _ in range(3) for n in s.controller.check_once()["evacuated"]]
    return (evacuated, _status(s, NODE), plane.payload()["nodes"][NODE]["evacuated"],
            sorted(plane.excluded_hosts()))


def release_cannot_resurrect_an_evacuated_node(s):
    plane = s.plane()
    plane.quarantine(NODE, reason="limping", actor="test")
    s.factory.dead.add(s.addr(NODE))
    s.kube.set_node_ready(NODE, False)
    for _ in range(3):
        s.controller.check_once()
    try:
        plane.release(NODE, actor="test")
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return s.controller.is_evacuated(NODE), refused


def quarantine_survives_shard_takeover_store_seam(s):
    store = s.side.Store(s.kube, s.cfg)
    s.plane(store=store).quarantine(NODE, reason="limping", actor="test")
    takeover = s.plane(store=store)
    return takeover.load(), takeover.is_quarantined(NODE), \
        takeover.payload()["nodes"][NODE]["manual"]


RECOVERY_CASES = [
    healthy_nodes_stay_healthy, ready_node_with_dead_worker_is_never_evacuated,
    confirmed_node_death_evacuates, worker_gone_without_node_object_evacuates,
    evacuated_node_coming_back_is_tracked_again, sharded_controller_skips_unowned_nodes,
    api_partition_does_not_evacuate, evacuated_unregistered_node_is_pruned, recovery_routes,
    reaper_after_evacuation_no_double_free, warm_pool_does_not_readopt_evacuated_holders,
    quarantined_is_not_dead, quarantined_node_that_then_dies_is_evacuated_normally,
    release_cannot_resurrect_an_evacuated_node, quarantine_survives_shard_takeover_store_seam,
]

EXPECTED = {
    "evacuated_node_coming_back_is_tracked_again": ("evacuated", "healthy"),
    "api_partition_does_not_evacuate": ([[]] * 5, "suspect"),
    "evacuated_unregistered_node_is_pruned": ("evacuated", False, [NODE]),
    "reaper_after_evacuation_no_double_free": ([], [], 0),
    "warm_pool_does_not_readopt_evacuated_holders": 0,
    "quarantine_survives_shard_takeover_store_seam": (1, True, True),
}


def _run_case(case, real: bool = False) -> dict:
    got = {}
    for name, side in SIDES.items():
        stack = _Stack(side, real=real)
        try:
            got[name] = case(stack)
        finally:
            stack.close()
    return got


@pytest.mark.parametrize("case", RECOVERY_CASES, ids=lambda c: c.__name__)
def test_a_recovery_case_runs_on_the_real_reconciler_and_machine(case):
    """The case with each side's real reconciler and machine as the hooks:
    the answers are both sides' equal, and equal to the stubs' run."""
    real = _run_case(case, real=True)
    assert real["port"] == real["reference"]
    if case in (confirmed_node_death_evacuates,):
        assert real["port"] == _run_case(case)["port"]


@pytest.mark.parametrize("case", RECOVERY_CASES, ids=lambda c: c.__name__)
def test_a_recovery_case_runs_as_the_references(case):
    got = _run_case(case)
    assert got["port"] == got["reference"]
    port = got["port"]
    if case.__name__ in EXPECTED:
        assert port == EXPECTED[case.__name__]
    if case is healthy_nodes_stay_healthy:
        assert port[0]["evacuated"] == [] and port[1][NODE] == "healthy" and port[2] == []
    elif case is ready_node_with_dead_worker_is_never_evacuated:
        assert port[0] == [[]] * 6 and port[1]["status"] == "suspect"
    elif case is confirmed_node_death_evacuates:
        (evacuated, left, enqueued, resumes, evacs, dead, alive, events, marker,
         again) = port
        assert evacuated == [NODE] and left == [] and enqueued == [("default", "tenant")]
        assert resumes >= 1 and evacs[0]["released_bookings"] and (dead, alive) == (
            "evacuated", "healthy")
        assert [e[0] for e in events] == ["GPUNodeEvacuated"]
        assert marker == (1, "evacuation", NODE, True) and again == []
    elif case is worker_gone_without_node_object_evacuates:
        assert port[0] == [NODE]
    elif case is sharded_controller_skips_unowned_nodes:
        assert all(out["evacuated"] == [] for out in port[0]) and NODE not in port[1]
    elif case is recovery_routes:
        statuses = [status for status, _ in port[0]]
        assert statuses == [200, 401, 200, 401] and port[0][2][1]["node"] == NODE
        assert port[1] == "evacuated"
        assert {"recovery.evacuate", "http.recovery_evacuate"} <= set(port[2])
    elif case is quarantined_is_not_dead:
        assert all(out == [] for out in port[0])
        assert port[1]["status"] == "healthy" and port[1]["quarantined"] is True
        assert port[2] is False
    elif case is quarantined_node_that_then_dies_is_evacuated_normally:
        assert port == ([NODE], "evacuated", True, [])
    elif case is release_cannot_resurrect_an_evacuated_node:
        assert port[0] is True and "evacuated" in port[1]


def test_the_evacuated_reason_takes_the_gpu_name():
    """The one difference on purpose: the Event's reason names the GPU, as
    the port's other Events do; its message, involved object and type are
    the reference's (``confirmed_node_death_evacuates`` compares them)."""
    assert controller.EVACUATED_REASON == "GPUNodeEvacuated"
    assert controller.ANNOT_DISRUPTION == ref_controller.ANNOT_DISRUPTION


def test_correlated_failure_detection_is_parallel():
    """Twelve wedged workers (each probe 0.3 s, then refused): one pass is
    bounded by the fan-out core's width, not their count, on both."""
    for side in SIDES.values():
        stack = _Stack(side)
        slow = set()

        class _SlowFactory:
            def __call__(self, address, unavailable=side.Unavailable):
                class _Client:
                    def __enter__(self):
                        return self

                    def __exit__(self, *exc):
                        return False

                    def collect_telemetry(self, timeout_s=None):
                        if address in slow:
                            time.sleep(0.3)
                            raise unavailable("wedged", address, "CollectTelemetry")
                        return object()

                return _Client()

        try:
            for i in range(12):
                stack.kube.create_node(f"rack-node-{i}", ready=True)
                ip = f"10.1.0.{i + 1}"
                slow.add(f"{ip}:{stack.cfg.worker_port}")
                stack.kube.create_pod(stack.cfg.worker_namespace, {
                    "metadata": {"name": f"w-rack-{i}", "namespace": stack.cfg.worker_namespace,
                                 "labels": dict(side.worker_labels)},
                    "spec": {"nodeName": f"rack-node-{i}", "containers": [{"name": "w"}]},
                    "status": {"phase": "Running", "podIP": ip}})
            stack.controller.client_factory = _SlowFactory()
            started = time.monotonic()
            out = stack.controller.check_once()
            elapsed = time.monotonic() - started
        finally:
            stack.close()
        assert out["suspect"] == 12 and out["evacuated"] == []
        # serial would be >= 12 x 0.3 s
        assert elapsed < 1.5, f"{side.kind}: a detection pass took {elapsed:.1f}s (serial?)"


def test_the_suspended_evacuation_while_the_api_is_unhealthy():
    """ApiHealth not healthy: a confirmed death stays suspect, its reason
    naming the suspension, and evacuates once the API heals; on both."""
    got = {}
    for name, side in SIDES.items():
        stack = _Stack(side)
        try:
            class _Health:
                healthy = False

                def ok(self):
                    return self.healthy

                def state(self):
                    return "healthy" if self.healthy else "down"

            health = _Health()
            stack.controller.apihealth = health
            stack.factory.dead.add(stack.addr(NODE))
            stack.kube.set_node_ready(NODE, False)
            outs = [stack.controller.check_once()["evacuated"] for _ in range(3)]
            reason = stack.controller.payload()["nodes"][NODE]["reason"]
            health.healthy = True
            outs.append(stack.controller.check_once()["evacuated"])
            got[name] = (outs, reason)
        finally:
            stack.close()
    assert got["port"] == got["reference"]
    assert got["port"][0] == [[], [], [], [NODE]]
    assert "evacuation suspended until the API heals" in got["port"][1]


def test_replay_release_after_evacuation_is_idempotent(tmp_path):
    """A worker's ledger replay that rolls back a mount whose booking the
    evacuation already deleted neither raises nor frees anything twice."""
    from gpumounter_tpu_torch.device.backend import FakeDeviceBackend
    from gpumounter_tpu_torch.worker.ledger import MountLedger
    from gpumounter_tpu_torch.worker.mounter import GpuMounter
    from gpumounter_tpu_torch.worker.resync import LedgerResync

    stack = _Stack(SIDES["port"])
    try:
        kube, cfg = stack.kube, stack.cfg
        stack.pool_pod("txn-slave", NODE, owner={"name": "tenant", "ns": "default", "uid": "u2"})
        ledger = MountLedger(str(tmp_path / "ledger"))

        class _Dev:
            uuid, basename, major, minor, pod_name = "GPU-0", "nvidia0", 195, 0, "txn-slave"

        target = types.SimpleNamespace(
            description="default/tenant", dev_dir=str(tmp_path / "dev"), ns_pid=None,
            cgroup_dirs=[], pod=types.SimpleNamespace(namespace="default", name="tenant",
                                                      uid="u2"))
        ledger.begin("mount", target=target, devices=[_Dev()])
        stack.controller.evacuate(NODE, reason="test")  # deletes txn-slave first

        class _Alloc:
            def delete_slave_pods(self, names, wait=True):
                for name in names:
                    kube.delete_pod(cfg.pool_namespace, name)

            def slave_pods_for(self, pod):
                return []

        service = types.SimpleNamespace(
            ledger=ledger, kube=kube, allocator=_Alloc(),
            mounter=GpuMounter(FakeDeviceBackend.create(str(tmp_path / "fakedev"), 1), cfg=cfg),
            collector=types.SimpleNamespace(update_status=lambda: None,
                                            get_pod_devices=lambda *a, **k: []))
        summary = LedgerResync(service).replay_once()
        assert summary["rolled_back"] and ledger.open_transactions() == []
        assert kube.list_pods(cfg.pool_namespace) == []
    finally:
        stack.close()


def test_the_series_are_the_references():
    for name in ("NODES_TRACKED", "NODES_SUSPECT", "NODES_EVACUATED", "EVACUATED_BOOKINGS",
                 "EVACUATED_INTENTS"):
        mine, ref = getattr(controller, name), getattr(ref_controller, name)
        assert (mine.name, mine.help, type(mine).__name__) == (ref.name, ref.help,
                                                                type(ref).__name__)
