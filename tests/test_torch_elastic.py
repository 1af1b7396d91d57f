"""The elastic reconciler and the intent routes, on the reference's and on the
port's.

The intent routes of ``tests/test_elastic_intents.py`` (CRUD, and the bad
input refused) run on both masters, and their statuses and bodies must be
equal. The cases of ``tests/test_elastic_reconcile.py`` run on both
packages over their own stacks (real HTTP, real gRPC and a fake host's
GPUs; or a scripted worker) and what each found must be equal: ProbeGPU's
verdicts, the convergence 2 -> 4 with the loop running, the heal of a
killed GPU (the marker, the series, the Event, whose reason takes the GPU
name), the shrink, the heal watchers (the port's ``torchside`` against the
reference's ``jaxside``), a heal split across passes, the degraded state
above the floor, a malformed intent parked, and the backoff's growth. Last,
``entry.elastic_migrate_check`` on the fake host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import pytest
from conftest import AUTH_HEADER
from torch_durability import short_root
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu import elastic as ref_elastic
from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.elastic import reconciler as ref_reconciler
from gpumounter_tpu.jaxside import heal as ref_heal
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.rpc.client import WorkerClient as RefClient
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.mounter import MountTarget, TpuMounter
from gpumounter_tpu.worker.server import TpuMountService
from gpumounter_tpu.worker.server import build_server as ref_build_server
from gpumounter_tpu_torch import elastic
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.elastic import reconciler
from gpumounter_tpu_torch.entry import _MasterStack
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.master import app as port_app
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.torchside import heal

LOOP = dict(elastic_resync_interval_s=0.3, elastic_backoff_base_s=0.2,
            elastic_min_reconcile_interval_s=0.01)


def _pod(name, namespace="default"):
    return {"metadata": {"name": name, "namespace": namespace},
            "spec": {"containers": [{"name": "main"}]}}


def _wait_for(predicate, timeout_s: float, message: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(message)


def http(base: str, method: str, path: str, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=dict(AUTH_HEADER))
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


# --- the intent routes (no worker needed) ---

APPS = {"reference": lambda kube: ref_app.MasterApp(kube, cfg=RefConfig()),
        "port": lambda kube: port_app.MasterApp(kube, cfg=Config())}
FAKES = {"reference": RefFake, "port": FakeKubeClient}


def _intent_routes(name, script):
    kube = FAKES[name]()
    kube.create_pod("default", _pod("trainer"))
    app = APPS[name](kube)
    try:
        out = []
        for method, path, body, auth in script:
            status, _, text, _ = app.handle(method, path, body, dict(AUTH_HEADER) if auth else {})
            try:
                text = json.loads(text)
            except ValueError:
                pass
            out.append((status, text))
        out.append(app.elastic.queue.depth())
        return out
    finally:
        app.registry.stop()


def test_intent_routes_crud():
    """PUT, GET, the list, DELETE, GET again; the PUT queues the pod."""
    body = json.dumps({"desiredChips": 4, "minChips": 2}).encode()
    script = [("PUT", "/intents/default/trainer", body, True),
              ("GET", "/intents/default/trainer", b"", True),
              ("GET", "/intents", b"", True),
              ("DELETE", "/intents/default/trainer", b"", True),
              ("GET", "/intents/default/trainer", b"", True)]
    got = {name: _intent_routes(name, script) for name in APPS}
    assert got["port"] == got["reference"]
    assert got["port"][0] == (200, {"namespace": "default", "pod": "trainer", "desiredChips": 4,
                                    "minChips": 2, "priority": 0})
    assert got["port"][3] == (200, {"deleted": True}) and got["port"][4][0] == 404
    assert got["port"][-1] == 1


def test_intent_routes_reject_bad_input():
    script = [("PUT", "/intents/default/trainer", b"not json", True),
              ("PUT", "/intents/default/trainer", json.dumps({"desiredChips": -2}).encode(), True),
              ("PUT", "/intents/default/ghost", json.dumps({"desiredChips": 1}).encode(), True),
              ("GET", "/intents/default/ghost", b"", True),
              ("PUT", "/intents/default/trainer", json.dumps({"desiredChips": 1}).encode(), False),
              ("GET", "/intents", b"", False)]
    got = {name: _intent_routes(name, script) for name in APPS}
    assert got["port"] == got["reference"]
    assert [s for s, _ in got["port"][:-1]] == [400, 400, 404, 404, 401, 401]


# --- the stacks: real HTTP, real gRPC, a fake host's GPUs ---

@contextlib.contextmanager
def _ref_stack():
    """The reference's stack of ``tests/test_elastic_reconcile.py``: (base,
    cluster, service, app, kill(uuid), ChipReplaced's reason)."""
    root = short_root()
    cluster = RefCluster(root, n_chips=6).start()
    container_dev = os.path.join(root, "container-dev")
    os.makedirs(container_dev)
    collector = TpuCollector(backend=cluster.backend,
                             podresources=PodResourcesClient(cluster.cfg.kubelet_socket,
                                                             timeout_s=5.0), cfg=cluster.cfg)
    mounter = TpuMounter(cluster.backend, cfg=cluster.cfg)
    mounter.resolve_target = lambda pod: MountTarget(
        dev_dir=container_dev, description=f"{pod.namespace}/{pod.name}")
    service = TpuMountService(cluster.kube, collector=collector, mounter=mounter, cfg=cluster.cfg)
    server = ref_build_server(service, address="localhost:0")
    server.start()
    cfg = cluster.cfg.replace(worker_port=server.bound_port, **LOOP)
    cluster.kube.create_pod(cfg.worker_namespace, {
        "metadata": {"name": "tpu-mounter-worker-abc", "namespace": cfg.worker_namespace,
                     "labels": {"app": "tpu-mounter-worker"}},
        "spec": {"nodeName": cluster.node_name, "containers": [{"name": "worker"}]},
        "status": {"phase": "Running", "podIP": "127.0.0.1"}})
    app = ref_app.MasterApp(cluster.kube, cfg=cfg,
                            registry=ref_app.WorkerRegistry(cluster.kube, cfg))
    httpd = ref_app.build_http_server(app, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield (f"http://127.0.0.1:{httpd.server_address[1]}", cluster,
               lambda pod: sorted(d.uuid for d in service.collector.get_pod_devices(pod,
                                                                                   "default")),
               app, lambda uuid: cluster.kill_chip(uuid.removeprefix("tpu-fake-accel")),
               "/addtpu/namespace/default/pod/{pod}/tpu/{n}/isEntireMount/false",
               "TPUChipReplaced", lambda: RefClient(app.registry.worker_address(
                   cluster.node_name)), lambda c, pod: c.probe_tpu(pod, "default"))
    finally:
        app.elastic.stop()
        httpd.shutdown()
        app.registry.stop()
        server.stop(grace=None)
        cluster.stop()
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _port_stack(tmp_path):
    """The port's: ``entry._MasterStack`` over a fake host of 6 GPUs."""
    cfg = dataclasses.replace(Config(), **LOOP)
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "fake"), 6, cfg=cfg)
    target = str(tmp_path / "container-dev")
    os.makedirs(target)
    with _MasterStack(cluster, {cluster.node_name: target}) as stack:
        service = stack.services[cluster.node_name]
        try:
            yield (stack.base, cluster,
                   lambda pod: sorted(d.uuid for d in service.collector.get_pod_devices(
                       pod, "default")),
                   stack.app, lambda uuid: cluster.kill_gpu(int(uuid.rsplit("-", 1)[1], 16)),
                   "/addgpu/namespace/default/pod/{pod}/gpu/{n}/isEntireMount/false",
                   "GPUChipReplaced", lambda: stack.client(cluster.node_name),
                   lambda c, pod: c.probe_gpu(pod, "default"))
        finally:
            stack.app.elastic.stop()


STACKS = {"reference": lambda tmp_path: _ref_stack(), "port": _port_stack}


def _probe_verdicts(stack) -> list:
    base, cluster, held, app, kill, add, _, client, probe = stack
    cluster.add_target_pod("trainer")
    status, body = http(base, "GET", add.format(pod="trainer", n=2))
    assert status == 200, body
    with client() as c:
        result, chips = probe(c, "trainer")
        out = [result.name, [c.healthy for c in chips]]
        kill(chips[0].uuid)
        result, chips2 = probe(c, "trainer")
        by_uuid = {ch.uuid: ch for ch in chips2}
        out += [result.name, by_uuid[chips[0].uuid].healthy,
                "dead" in by_uuid[chips[0].uuid].reason, by_uuid[chips[1].uuid].healthy]
        out.append(probe(c, "ghost")[0].name)
    return out


def test_the_probe_reports_gpu_health_as_the_references(tmp_path):
    got = {}
    for name, make in STACKS.items():
        with make(tmp_path / name) as stack:
            got[name] = _probe_verdicts(stack)
    assert got["port"] == got["reference"] == [
        "Success", [True, True], "Success", False, True, True, "PodNotFound"]


def _declare_converge_kill_heal(stack, healed) -> list:
    """The acceptance path with the loop running: 2 mounted, an intent of 4,
    a GPU killed and replaced, then an intent of 1."""
    base, cluster, held, app, kill, add, reason, _, _ = stack
    cluster.add_target_pod("trainer")
    status, body = http(base, "GET", add.format(pod="trainer", n=2))
    assert status == 200, body
    out = [len(held("trainer"))]
    app.elastic.start()
    status, _ = http(base, "PUT", "/intents/default/trainer",
                     {"desiredChips": 4, "minChips": 2})
    _wait_for(lambda: len(held("trainer")) == 4, 15.0, "never converged 2 -> 4")
    _wait_for(lambda: '"converged"' in http(base, "GET", "/intents/default/trainer")[1], 5.0,
              "the status never showed converged")
    before = held("trainer")
    healed0 = healed()
    victim = before[0]
    kill(victim)
    _wait_for(lambda: healed() == healed0 + 1, 15.0, "chips_healed_total never rose")
    _wait_for(lambda: victim not in held("trainer") and len(held("trainer")) == 4, 15.0,
              "the dead GPU never replaced")
    after = held("trainer")
    pod = cluster.kube.get_pod("default", "trainer")
    marker = json.loads(pod["metadata"]["annotations"]["tpumounter.io/chip-replaced"])
    reasons = [m.get("reason") for _, m in cluster.kube.events_posted]
    out += [status, len(before), victim in after, len(after), marker["removed"] == [victim],
            marker["generation"] >= 1, set(marker["added"]) <= set(after), reason in reasons]
    status, _ = http(base, "PUT", "/intents/default/trainer", {"desiredChips": 1})
    _wait_for(lambda: len(held("trainer")) == 1, 15.0, "never scaled down 4 -> 1")
    return out + [status, len(held("trainer"))]


def test_declare_converge_kill_heal_as_the_references(tmp_path):
    """The Event's reason is GPUChipReplaced where the reference's is
    TPUChipReplaced (ROADMAP §3); the marker, the series and the counts are
    the reference's."""
    got = {}
    for name, make in STACKS.items():
        mod = reconciler if name == "port" else ref_reconciler
        with make(tmp_path / name) as stack:
            got[name] = _declare_converge_kill_heal(stack, mod.CHIPS_HEALED.total)
    assert got["port"] == got["reference"] == [2, 200, 4, False, 4, True, True, True, True,
                                               200, 1]
    assert reconciler.REPLACED_REASON == "GPUChipReplaced"


def _heal_watcher(kube, watch, annot) -> list:
    kube.create_pod("default", _pod("trainer"))
    seen: list[dict] = []
    stop = threading.Event()
    watcher = threading.Thread(target=watch, args=(kube, "default", "trainer", seen.append),
                               kwargs={"stop": stop, "watch_timeout_s": 2.0}, daemon=True)
    watcher.start()
    try:
        marker = {"generation": 1, "removed": ["a0"], "added": ["a4"], "at": "now"}
        kube.patch_pod("default", "trainer",
                       {"metadata": {"annotations": {annot: json.dumps(marker)}}})
        _wait_for(lambda: seen, 5.0, "the heal watcher never fired")
        kube.patch_pod("default", "trainer",
                       {"metadata": {"annotations": {annot: json.dumps(marker)}}})
        time.sleep(0.3)
        return [s["removed"] for s in seen]
    finally:
        stop.set()
        watcher.join(timeout=5.0)


def test_the_heal_watcher_fires_once_a_generation_as_the_references():
    got = {"reference": _heal_watcher(RefFake(), ref_heal.watch_chip_replacements,
                                      ref_elastic.ANNOT_REPLACED),
           "port": _heal_watcher(FakeKubeClient(), heal.watch_chip_replacements,
                                 elastic.ANNOT_REPLACED)}
    assert got["port"] == got["reference"] == [["a0"]]
    assert elastic.ANNOT_REPLACED == ref_elastic.ANNOT_REPLACED


def _marker_while_watch_down(kube, watch, annot) -> tuple:
    kube.create_pod("default", _pod("trainer"))
    broken = threading.Event()
    broken.set()
    orig = kube.watch_pods

    def flaky(*args, **kwargs):
        if broken.is_set():
            raise RuntimeError("watch down")
        return orig(*args, **kwargs)

    kube.watch_pods = flaky
    seen: list[dict] = []
    stop = threading.Event()
    watcher = threading.Thread(target=watch, args=(kube, "default", "trainer", seen.append),
                               kwargs={"stop": stop, "watch_timeout_s": 2.0}, daemon=True)
    watcher.start()
    try:
        time.sleep(0.2)
        kube.patch_pod("default", "trainer", {"metadata": {"annotations": {annot: json.dumps(
            {"generation": 1, "removed": ["a"], "added": ["b"]})}}})
        time.sleep(0.3)
        during = len(seen)
        broken.clear()
        _wait_for(lambda: seen, 10.0, "the heal stamped in the watch's outage never came")
        return during, seen[0]["generation"]
    finally:
        stop.set()
        watcher.join(timeout=5.0)


def test_a_heal_stamped_while_the_watch_is_down_is_delivered_as_the_references():
    got = {"reference": _marker_while_watch_down(RefFake(), ref_heal.watch_chip_replacements,
                                                 ref_elastic.ANNOT_REPLACED),
           "port": _marker_while_watch_down(FakeKubeClient(), heal.watch_chip_replacements,
                                            elastic.ANNOT_REPLACED)}
    assert got["port"] == got["reference"] == (0, 1)


# --- the reconciler against a scripted worker ---

class _ScriptedWorker:
    """A worker in memory: GPU UUID -> healthy, and a flag that fails the
    mounts; the port's calls (probe_gpu, remove_gpu, add_gpu) and the
    reference's (probe_tpu, remove_tpu, add_tpu_detailed)."""

    def __init__(self, chips: dict[str, bool], full: bool = False):
        self.chips, self.full = chips, full
        self.fail_mounts = False
        self._serial = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _mount(self, n: int) -> list[str]:
        if self.fail_mounts:
            raise RuntimeError("forced mount failure")
        added = []
        for _ in range(n):
            added.append(f"replacement-{self._serial}")
            self._serial += 1
            self.chips[added[-1]] = True
        return added

    def probe_gpu(self, pod, ns):
        return api.ProbeGPUResult.Success, [api.ChipHealth(uuid=u, healthy=h)
                                            for u, h in sorted(self.chips.items())]

    def remove_gpu(self, pod, ns, uuids, force=False, remove_all=False, **kwargs):
        for u in uuids:
            self.chips.pop(u, None)
        return api.RemoveGPUResponse(api.RemoveGPUResult.Success)

    def add_gpu(self, pod, ns, n, entire=False, **kwargs):
        if self.full:
            return api.AddGPUResponse(api.AddGPUResult.InsufficientGPU)
        return api.AddGPUResponse(api.AddGPUResult.Success, uuids=self._mount(n))

    def probe_tpu(self, pod, ns):
        return ref_api.ProbeTPUResult.Success, [ref_api.ChipHealth(uuid=u, healthy=h)
                                                for u, h in sorted(self.chips.items())]

    def remove_tpu(self, pod, ns, uuids, force=False, remove_all=False, **kwargs):
        for u in uuids:
            self.chips.pop(u, None)
        return ref_api.RemoveTPUResult.Success

    def add_tpu_detailed(self, pod, ns, n, entire=False, prefer_ici=False, **kwargs):
        if self.full:
            return ref_api.AddTPUResult.InsufficientTPU, []
        return ref_api.AddTPUResult.Success, self._mount(n)


@contextlib.contextmanager
def _controller(name, tmp_path, worker, **knobs):
    """(the reconciler, its package, the kube) over a one-node cluster with
    a registered worker and `worker` as every client."""
    if name == "reference":
        root = short_root()
        cluster = RefCluster(root, n_chips=4).start()
        cfg = cluster.cfg.replace(elastic_resync_interval_s=30.0,
                                  elastic_min_reconcile_interval_s=0.0)
        labels = {"app": "tpu-mounter-worker"}
        mod, registry_cls = ref_elastic, ref_app.WorkerRegistry
    else:
        root = None
        cluster = FakeCluster.with_fake_gpus(str(tmp_path / "fake"), 4)
        cfg = dataclasses.replace(cluster.cfg, elastic_resync_interval_s=30.0,
                                  elastic_min_reconcile_interval_s=0.0)
        labels = dict(c.split("=", 1) for c in cfg.worker_label_selector.split(","))
        mod, registry_cls = elastic, port_app.WorkerRegistry
    cluster.kube.create_pod(cfg.worker_namespace, {
        "metadata": {"name": "w", "namespace": cfg.worker_namespace, "labels": labels},
        "spec": {"nodeName": cluster.node_name, "containers": [{"name": "w"}]},
        "status": {"phase": "Running", "podIP": "127.0.0.1"}})
    registry = registry_cls(cluster.kube, cfg)
    cluster.add_target_pod("trainer")
    rec = mod.ElasticReconciler(cluster.kube, registry, lambda addr: worker, cfg=cfg, **{
        k: (mod.BackoffPolicy(**v) if k == "backoff" else v) for k, v in knobs.items()})
    try:
        yield rec, mod, cluster.kube
    finally:
        rec.stop()
        registry.stop()
        cluster.stop()
        if root:
            shutil.rmtree(root, ignore_errors=True)


def _split_heal(name, tmp_path) -> list:
    worker = _ScriptedWorker({"chip-h": True, "chip-d": False})
    with _controller(name, tmp_path, worker) as (rec, mod, kube):
        mod.IntentStore(kube, rec.cfg).put("default", "trainer", mod.Intent(desired_chips=2))
        worker.fail_mounts = True
        with pytest.raises(mod.ReconcileError):
            rec.reconcile_once("default", "trainer")
        annotations = kube.get_pod("default", "trainer")["metadata"].get("annotations", {})
        out = ["chip-d" in worker.chips, mod.ANNOT_REPLACED in annotations]
        worker.fail_mounts = False
        healed = sys_modules_healed(name)
        before = healed()
        outcome = rec.reconcile_once("default", "trainer")
        marker = json.loads(kube.get_pod("default", "trainer")["metadata"]["annotations"]
                            [mod.ANNOT_REPLACED])
        return out + [outcome["phase"], outcome["removed_dead"], healed() - before,
                      marker["removed"], marker["added"]]


def sys_modules_healed(name):
    return (reconciler if name == "port" else ref_reconciler).CHIPS_HEALED.total


def test_a_heal_survives_a_pass_that_dies_after_the_removal_as_the_references(tmp_path):
    got = {name: _split_heal(name, tmp_path) for name in ("reference", "port")}
    assert got["port"] == got["reference"] == [False, False, "converged", ["chip-d"], 1.0,
                                               ["chip-d"], ["replacement-0"]]


def _degraded_above_floor(name, tmp_path) -> tuple:
    worker = _ScriptedWorker({f"chip-{i}": True for i in range(3)}, full=True)
    with _controller(name, tmp_path, worker) as (rec, mod, kube):
        mod.IntentStore(kube, rec.cfg).put("default", "trainer",
                                           mod.Intent(desired_chips=4, min_chips=2))
        outcome = rec.reconcile_once("default", "trainer")
        return outcome["phase"], outcome["actual"], outcome["added"]


def test_capacity_exhaustion_above_the_floor_is_degraded_as_the_references(tmp_path):
    got = {name: _degraded_above_floor(name, tmp_path) for name in ("reference", "port")}
    assert got["port"] == got["reference"] == ("degraded", 3, [])


def _malformed(name, tmp_path) -> tuple:
    with _controller(name, tmp_path, _ScriptedWorker({})) as (rec, mod, kube):
        kube.patch_pod("default", "trainer",
                       {"metadata": {"annotations": {mod.ANNOT_DESIRED: "four"}}})
        outcome = rec.reconcile_once("default", "trainer")
        return (outcome["phase"], "malformed" in outcome["error"],
                rec.queue.failures("default/trainer"))


def test_a_malformed_intent_is_parked_as_the_references(tmp_path):
    got = {name: _malformed(name, tmp_path) for name in ("reference", "port")}
    assert got["port"] == got["reference"] == ("invalid", True, 0)


class _FailingWorker(_ScriptedWorker):
    """No GPU held, and every mount dies."""

    def __init__(self):
        super().__init__({})
        self.fail_mounts = True


def _backoff(name, tmp_path) -> tuple:
    with _controller(name, tmp_path, _FailingWorker(),
                     backoff=dict(base_s=0.2, factor=2.0, cap_s=5.0, jitter=0.0)) \
            as (rec, mod, kube):
        mod.IntentStore(kube, rec.cfg).put("default", "trainer", mod.Intent(desired_chips=1))
        rec.start()
        rec.enqueue("default", "trainer")
        key = "default/trainer"
        _wait_for(lambda: len(rec.attempts.get(key, [])) >= 4, 20.0,
                  "the failing mount was never retried")
        stamps = rec.attempts[key][:4]
        rec.stop()
        gaps = [b - a for a, b in zip(stamps, stamps[1:])]
        status = rec.status_for("default", "trainer")
        return (all(b > a for a, b in zip(gaps, gaps[1:])),
                gaps[1] >= gaps[0] * 1.4 and gaps[2] >= gaps[1] * 1.4,
                status["phase"], "forced mount failure" in status["error"])


def test_a_failing_mount_backs_off_exponentially_as_the_references(tmp_path):
    got = {name: _backoff(name, tmp_path) for name in ("reference", "port")}
    assert got["port"] == got["reference"] == (True, True, "backoff", True)


def test_the_series_are_the_references():
    for series in ("RECONCILE_DURATION", "RECONCILE_QUEUE_DEPTH", "CHIPS_HEALED",
                   "CHIPS_HEAL_FAILURES", "INTENTS_REGISTERED"):
        ours, theirs = getattr(reconciler, series), getattr(ref_reconciler, series)
        assert (type(ours).__name__, ours.name, ours.help) == \
            (type(theirs).__name__, theirs.name, theirs.help), series


def test_record_rejection_is_the_capacity_planes_seam_and_does_nothing():
    """The reconciler's refusals go through ``obs.capacity.record_rejection``
    (``reconciler.capacity_obs``), as the reference's: with no plane
    registered it does nothing on both sides (the reference's
    ``test_module_level_rejection_is_noop_without_plane``); with one, each
    records one ``capacity.reject`` of the same outcome."""
    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu.obs import capacity as ref_capacity
    from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
    from gpumounter_tpu_torch.obs import capacity
    from gpumounter_tpu_torch.obs.audit import AUDIT
    assert reconciler.capacity_obs is capacity

    class _Fleet:
        def payload(self, max_age_s=None):
            return {"nodes": {"n": {"capacity": {"total": 4, "free": [0], "warm": [],
                                                 "fenced": [], "held": {}}}}}

    saved = ref_capacity._PLANE
    try:
        for mod in (ref_capacity, capacity):
            mod.register_plane(None)
            assert mod.record_rejection("n", "default", "p", 2) is None
        assert [r for r in REF_AUDIT.snapshot() if r["operation"] == "capacity.reject"] == []
        assert AUDIT.query(operation="capacity.reject") == []
        ref_capacity.register_plane(ref_capacity.CapacityPlane(_Fleet(), cfg=RefConfig()))
        capacity.register_plane(capacity.CapacityPlane(_Fleet(), cfg=Config()))
        for mod in (ref_capacity, capacity):
            assert mod.record_rejection("n", "default", "p", 2) is None
        ref = [r for r in REF_AUDIT.snapshot() if r["operation"] == "capacity.reject"]
        ours = AUDIT.query(operation="capacity.reject")
        assert len(ref) == len(ours) == 1
        assert (ours[0]["outcome"], ours[0]["details"]) == (ref[0]["outcome"],
                                                            ref[0]["details"])
        assert "cause: exhaustion" in ours[0]["outcome"]
    finally:
        ref_capacity.register_plane(saved)
        capacity.register_plane(None)


def test_elastic_migrate_check_on_the_cpu():
    """``entry.elastic_migrate_check("cpu")`` on a fake host of 1 GPU,
    through the master and the worker over gRPC: the heal of the vanished
    node, the migration with a tenant thread at each end (their logits'
    sha256 equal after the restore), and the rollback."""
    from gpumounter_tpu_torch.entry import elastic_migrate_check
    report = elastic_migrate_check("cpu")
    f = report["fake"]
    assert report["live"] is None
    assert f["heal"]["outcome"]["removed_dead"] == f["heal"]["outcome"]["added"] == \
        [f["heal"]["uuid"]]
    assert f["migration"]["source"]["sha256"] == f["migration"]["destination"]["sha256"]
    assert set(f["migration"]["phases_s"]) == {"quiesce", "checkpoint", "drain", "remount",
                                               "resume", "verify"}
    assert f["rollback"]["books"] == {"tenant-destination": [f["heal"]["uuid"]],
                                      "tenant-intent": []}
