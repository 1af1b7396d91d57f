"""The live migration, on the reference's and on the port's.

Each case of ``tests/test_migrate.py`` but the CLI's runs on both packages
over their own two-node stacks (real HTTP, real gRPC, fake hosts of 6 GPUs,
tenants on the ``watch_migration`` hooks of ``jaxside`` and ``torchside``)
and what each found must be equal: the journal (outcome, acks, the GPUs'
count and their indices on the destination, the phases timed), the tenants'
signals, the intent that follows the tenant, the rollback when the
destination is full, the adoption of an interrupted journal and its trace,
the refusals, QuiesceStatus over gRPC (and its messages' bytes), the
reconciler's pause, the stale lock, the tenant hook's acks and the series.
The Events take the GPU names (ROADMAP §3), and the remount mounts the same
GPUs as the reference's without its ICI hint.
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
from gpumounter_tpu import migrate as ref_migrate
from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.jaxside import migrate as ref_tenant
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu.migrate import journal as ref_journal
from gpumounter_tpu.migrate import orchestrator as ref_orchestrator
from gpumounter_tpu.obs import assembly as ref_assembly
from gpumounter_tpu.obs import trace as ref_trace
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.rpc.client import WorkerClient as RefClient
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.mounter import MountTarget, TpuMounter
from gpumounter_tpu.worker.server import TpuMountService
from gpumounter_tpu.worker.server import build_server as ref_build_server
from gpumounter_tpu_torch import elastic, migrate
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.entry import _MasterStack
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.migrate import journal, orchestrator
from gpumounter_tpu_torch.obs import assembly, trace
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.torchside import migrate as tenant

NODE_A, NODE_B = "host-a", "host-b"
KNOBS = dict(migrate_quiesce_timeout_s=3.0, migrate_resume_timeout_s=1.5,
             migrate_poll_interval_s=0.02, elastic_resync_interval_s=30.0)


def http(base: str, method: str, path: str, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=dict(AUTH_HEADER))
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _wait_for(predicate, timeout_s: float, message: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(message)


@dataclasses.dataclass
class Side:
    """One package's stack and the names it calls things by."""
    name: str
    base: str
    cluster: object
    app: object
    chips: object          # (node, pod) -> the UUIDs booked, sorted
    index: object          # (node, uuid) -> the GPU's index on the node
    mount_path: str        # the imperative add of 4 to trainer-a
    resource: str
    probe: object          # (client, pod) -> (result name, chips)
    remove: object         # (client, pod, uuids) -> result name
    mig: object            # the package's migrate.journal
    watch: object          # the tenant hook
    reason: str            # the Events' prefix: TPU or GPU


@contextlib.contextmanager
def _ref_stack():
    root = short_root()
    cluster = RefCluster(root, nodes={NODE_A: 6, NODE_B: 6}).start()
    cfg = cluster.cfg.replace(**KNOBS)
    servers, port_by_ip, services = [], {}, {}
    for i, name in enumerate(cluster.node_names):
        node_cfg = cluster.node_cfg(name, cfg)
        node = cluster.node(name)
        collector = TpuCollector(backend=node.backend,
                                 podresources=PodResourcesClient(node.kubelet_socket,
                                                                 timeout_s=5.0), cfg=node_cfg)
        mounter = TpuMounter(node.backend, cfg=node_cfg)
        base = os.path.join(root, f"container-dev-{name}")

        def _resolver(pod, _base=base):
            d = os.path.join(_base, f"{pod.namespace}-{pod.name}")
            os.makedirs(d, exist_ok=True)
            return MountTarget(dev_dir=d, description=f"{pod.namespace}/{pod.name}")

        mounter.resolve_target = _resolver
        services[name] = TpuMountService(cluster.kube, collector=collector, mounter=mounter,
                                         cfg=node_cfg)
        server = ref_build_server(services[name], address="localhost:0")
        server.start()
        servers.append(server)
        ip = f"10.0.0.{i + 1}"
        port_by_ip[ip] = server.bound_port
        cluster.kube.create_pod(cfg.worker_namespace, {
            "metadata": {"name": f"worker-{name}", "namespace": cfg.worker_namespace,
                         "labels": {"app": "tpu-mounter-worker"}},
            "spec": {"nodeName": name, "containers": [{"name": "w"}]},
            "status": {"phase": "Running", "podIP": ip}})
    app = ref_app.MasterApp(cluster.kube, cfg=cfg, worker_client_factory=lambda address: (
        RefClient(f"localhost:{port_by_ip[address.rsplit(':', 1)[0]]}")),
        registry=ref_app.WorkerRegistry(cluster.kube, cfg))
    httpd = ref_app.build_http_server(app, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def index(node, uuid):
        return next(d.index for d in cluster.node(node).backend.list_devices()
                    if d.uuid == uuid)

    try:
        yield Side("reference", f"http://127.0.0.1:{httpd.server_address[1]}", cluster, app,
                   lambda node, pod: sorted(d.uuid for d in services[node].collector
                                            .get_pod_devices(pod, "default")),
                   index, "/addtpu/namespace/default/pod/trainer-a/tpu/4/isEntireMount/false",
                   cluster.cfg.tpu_resource_name,
                   lambda c, pod: (lambda r: (r[0].name, r[1]))(c.probe_tpu(pod, "default")),
                   lambda c, pod, uuids: c.remove_tpu(pod, "default", uuids, force=True).name,
                   ref_journal, ref_tenant.watch_migration, "TPU")
    finally:
        app.migrations.stop()
        app.elastic.stop()
        httpd.shutdown()
        app.registry.stop()
        for s in servers:
            s.stop(grace=None)
        cluster.stop()
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _port_stack(tmp_path):
    cfg = dataclasses.replace(Config(), **KNOBS)
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "fake"), nodes={NODE_A: 6, NODE_B: 6},
                                         cfg=cfg)
    dirs = {}
    for node in cluster.node_names:
        dirs[node] = str(tmp_path / f"container-dev-{node}")
        os.makedirs(dirs[node])
    with _MasterStack(cluster, dirs) as stack:
        def index(node, uuid):
            return next(d.index for d in cluster.node(node).backend.list_devices()
                        if d.uuid == uuid)

        yield Side("port", stack.base, cluster, stack.app,
                   lambda node, pod: sorted(d.uuid for d in stack.services[node].collector
                                            .get_pod_devices(pod, "default")),
                   index, "/addgpu/namespace/default/pod/trainer-a/gpu/4/isEntireMount/false",
                   cluster.cfg.gpu_resource_name,
                   lambda c, pod: (lambda r: (r[0].name, r[1]))(c.probe_gpu(pod, "default")),
                   lambda c, pod, uuids: api.RemoveGPUResult(c.remove_gpu(
                       pod, "default", uuids, force=True).remove_gpu_result).name,
                   journal, tenant.watch_migration, "GPU")


STACKS = {"reference": lambda tmp_path: _ref_stack(), "port": _port_stack}


def _both(tmp_path, fn):
    """fn(side) on each package's stack; their answers."""
    got = {}
    for name, make in STACKS.items():
        with make(tmp_path / name) as side:
            got[name] = fn(side)
    return got


def _pods(s: Side, mount: bool = True) -> None:
    s.cluster.add_target_pod("trainer-a", node=NODE_A)
    s.cluster.add_target_pod("trainer-b", node=NODE_B)
    if mount:
        status, body = http(s.base, "GET", s.mount_path)
        assert status == 200, body


def _tenant(s: Side, pod, events, stop):
    thread = threading.Thread(target=s.watch, args=(s.cluster.kube, "default", pod,
                                                    lambda sig: events.append(("quiesce", sig))),
                              kwargs={"on_resume": lambda sig: events.append(("resume", sig)),
                                      "stop": stop, "watch_timeout_s": 2.0}, daemon=True)
    thread.start()
    return thread


def _migrate(s: Side, events: dict, wait_s: float = 30.0) -> dict:
    stop = threading.Event()
    threads = [_tenant(s, pod, events.setdefault(pod, []), stop)
               for pod in ("trainer-a", "trainer-b")]
    try:
        status, body = http(s.base, "POST", "/migrate", {
            "source": {"namespace": "default", "pod": "trainer-a"},
            "destination": {"namespace": "default", "pod": "trainer-b"}})
        assert status == 200, body
        return s.app.migrations.wait(json.loads(body)["id"], timeout_s=wait_s)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)


def _annotations(s: Side, pod: str) -> dict:
    return s.cluster.kube.get_pod("default", pod)["metadata"].get("annotations", {})


def _reasons(s: Side) -> list[str]:
    return [m.get("reason").replace(s.reason, "X", 1) for _, m in s.cluster.kube.events_posted
            if m.get("reason", "").startswith(s.reason + "Migration")]


def _end_to_end(s: Side) -> list:
    _pods(s)
    before = s.chips(NODE_A, "trainer-a")
    (ref_elastic if s.name == "reference" else elastic).IntentStore(
        s.cluster.kube, s.app.cfg).put("default", "trainer-a",
                                       (ref_elastic if s.name == "reference"
                                        else elastic).Intent(desired_chips=4))
    events: dict = {}
    j = _migrate(s, events)
    a, b = _annotations(s, "trainer-a"), _annotations(s, "trainer-b")
    return [j["outcome"], j["quiesced"], j["resumed"], sorted(j["chips"]) == before,
            len(j["dest_chips"]), j["downtime_s"] is not None and j["downtime_s"] >= 0,
            sorted(j["phase_durations_s"]), s.chips(NODE_A, "trainer-a"),
            s.chips(NODE_B, "trainer-b") == j["dest_chips"],
            sorted(s.index(NODE_B, u) for u in j["dest_chips"]),
            [e[0] for e in events["trainer-a"]], [e[0] for e in events["trainer-b"]],
            events["trainer-b"][0][1]["chips"] == j["dest_chips"],
            s.mig.migration_active(a), s.mig.migration_active(b),
            "tpumounter.io/desired-chips" in a, b.get("tpumounter.io/desired-chips"),
            _reasons(s)]


def test_a_migration_end_to_end_is_the_references(tmp_path):
    """4 GPUs move host-a -> host-b; both tenants ack; the intent follows;
    the destination's GPUs are the reference's indices, mounted without its
    ICI hint (the port's remount passes none: ROADMAP §3)."""
    got = _both(tmp_path, _end_to_end)
    assert got["port"] == got["reference"]
    assert got["port"][:7] == ["succeeded", True, True, True, 4, True,
                               ["drain", "quiesce", "remount", "resume", "verify"]]
    assert got["port"][9] == [0, 1, 2, 3]
    assert got["port"][-1] == ["XMigrationStarted", "XMigrationSucceeded"]
    assert (orchestrator.STARTED_REASON, orchestrator.SUCCEEDED_REASON,
            orchestrator.ROLLED_BACK_REASON) == ("GPUMigrationStarted", "GPUMigrationSucceeded",
                                                 "GPUMigrationRolledBack")


def _rolled_back(s: Side) -> list:
    _pods(s)
    before = s.chips(NODE_A, "trainer-a")
    s.cluster.kube.create_pod("default", {
        "metadata": {"name": "hog", "namespace": "default"},
        "spec": {"nodeSelector": {"kubernetes.io/hostname": NODE_B},
                 "containers": [{"name": "main", "resources": {
                     "limits": {s.resource: "6"}, "requests": {s.resource: "6"}}}]}})
    free = (s.cluster.free_chip_count if s.name == "reference" else s.cluster.free_gpu_count)
    _wait_for(lambda: free(NODE_B) == 0, 5.0, "the hog never scheduled")
    events: dict = {}
    j = _migrate(s, events)
    with s.app.migrations.client_factory(s.app.registry.worker_address(NODE_A)) as client:
        result, chips = s.probe(client, "trainer-a")
    return [j["outcome"], "re-mount" in j["error"], j["rollback_healthy"],
            s.chips(NODE_A, "trainer-a") == before, result,
            sorted(c.uuid for c in chips) == before, all(c.healthy for c in chips),
            s.chips(NODE_B, "trainer-b"),
            [s.mig.migration_active(_annotations(s, p)) for p in ("trainer-a", "trainer-b")],
            [e[0] for e in events["trainer-a"]], _reasons(s)]


def test_a_remount_failure_rolls_back_to_the_source_as_the_references(tmp_path):
    got = _both(tmp_path, _rolled_back)
    assert got["port"] == got["reference"] == [
        "rolled-back", True, 4, True, "Success", True, True, [], [None, None],
        ["quiesce", "resume"], ["XMigrationStarted", "XMigrationRolledBack"]]


def _interrupted(s: Side, tid: str | None) -> list:
    _pods(s)
    chips = s.chips(NODE_A, "trainer-a")
    with s.app.migrations.client_factory(s.app.registry.worker_address(NODE_A)) as client:
        removed = s.remove(client, "trainer-a", chips)
    j = s.mig.new_journal("mig-interrupted", "default", "trainer-a", "default", "trainer-b")
    j.update(phase="remount", chips=chips, dest_before=[], quiesced=True,
             downtime_started_at=time.time())
    if tid:
        j["trace_id"] = tid
    s.cluster.kube.patch_pod("default", "trainer-a", {"metadata": {"annotations": {
        s.mig.ANNOT_JOURNAL: s.mig.dump(j)}}})
    s.cluster.kube.patch_pod("default", "trainer-b", {"metadata": {"annotations": {
        s.mig.ANNOT_LOCK: json.dumps({"id": "mig-interrupted", "role": "destination"})}}})
    adopted = s.app.migrations.resume_interrupted()
    final = s.app.migrations.wait("mig-interrupted", timeout_s=30.0)
    out = [removed, adopted, final["outcome"], len(final["dest_chips"]),
           s.chips(NODE_B, "trainer-b") == final["dest_chips"],
           s.app.migrations.resume_interrupted()]
    if tid:
        tr, asm = (ref_trace, ref_assembly) if s.name == "reference" else (trace, assembly)
        names = {sp["name"] for sp in tr.TRACER.ring.spans_for(tid)}
        tree = asm.assemble(tid)
        out += [final["trace_id"] == tid,
                {"migrate.remount", "migrate.resume", "migrate.verify"} <= names,
                any(n.startswith("worker.Add") for n in names),
                tree is not None and tree["complete"], tree["roots"] >= 1,
                "migrate" in tree["phases"],
                abs(sum(tree["phases"].values()) - tree["wall_ms"])
                <= max(0.05, 0.01 * tree["wall_ms"])]
    return out


def test_an_interrupted_migration_resumes_after_a_restart_as_the_references(tmp_path):
    got = _both(tmp_path, lambda s: _interrupted(s, None))
    assert got["port"] == got["reference"] == ["Success", ["mig-interrupted"], "succeeded", 4,
                                               True, []]


def test_a_resumed_migration_keeps_its_first_trace_as_the_references(tmp_path):
    """The journal's trace id carries across the master's restart: the
    resumed machine's phases and the worker's spans join it, and it
    assembles complete."""
    got = _both(tmp_path, lambda s: _interrupted(s, "4d" * 16))
    assert got["port"] == got["reference"]
    assert got["port"][6:] == [True] * 7


def _rejections(s: Side) -> list:
    _pods(s, mount=False)

    def start(src, dst):
        status, body = http(s.base, "POST", "/migrate", {
            "source": {"namespace": "default", "pod": src},
            "destination": {"namespace": "default", "pod": dst}})
        return status, body

    out = []
    for src, dst, needle in (("trainer-a", "trainer-a", "same pod"), ("ghost", "trainer-b", ""),
                             ("trainer-a", "ghost", ""),
                             ("trainer-a", "trainer-b", "no tpumounter-managed chips")):
        status, body = start(src, dst)
        out.append((status, needle in body))
    status, body = http(s.base, "GET", s.mount_path)
    assert status == 200, body
    j = s.mig.new_journal("mig-busy", "default", "trainer-a", "default", "trainer-b")
    s.cluster.kube.patch_pod("default", "trainer-a", {"metadata": {"annotations": {
        s.mig.ANNOT_JOURNAL: s.mig.dump(j)}}})
    status, body = start("trainer-a", "trainer-b")
    out += [(status, "mig-busy" in body), http(s.base, "GET", "/migrations/nope")[0]]
    return out


def test_the_refusals_are_the_references(tmp_path):
    got = _both(tmp_path, _rejections)
    assert got["port"] == got["reference"] == [(400, True), (404, True), (404, True),
                                               (400, True), (409, True), 404]


def _quiesce_status(s: Side) -> list:
    _pods(s)
    with s.app.migrations.client_factory(s.app.registry.worker_address(NODE_A)) as client:
        result, status = client.quiesce_status("trainer-a", "default")
        out = [result.name, status.chip_count, status.acked_id, status.acked_phase]
        s.cluster.kube.patch_pod("default", "trainer-a", {"metadata": {"annotations": {
            "tpumounter.io/migration-ack": json.dumps({"id": "mig-x", "phase": "quiesced"})}}})
        result, status = client.quiesce_status("trainer-a", "default")
        out += [result.name, status.acked_id, status.acked_phase, status.holder_count]
        out.append(client.quiesce_status("ghost", "default")[0].name)
    return out


def test_quiesce_status_over_grpc_is_the_references(tmp_path):
    got = _both(tmp_path, _quiesce_status)
    assert got["port"] == got["reference"] == ["Success", 4, "", "", "Success", "mig-x",
                                               "quiesced", 0, "PodNotFound"]


def test_the_quiesce_status_messages_are_the_references_bytes():
    request = dict(pod_name="trainer-a", namespace="default", trace_context="ab" * 16 + "-" +
                   "cd" * 8)
    response = dict(quiesce_status_result=1, acked_id="mig-x", acked_phase="resumed",
                    holder_count=3, chip_count=4)
    ref_request = ref_api.QuiesceStatusRequest(**request)
    assert api.QuiesceStatusRequest(**request).encode() == ref_request.encode()
    assert api.QuiesceStatusResponse(**response).encode() == \
        ref_api.QuiesceStatusResponse(**response).encode()
    back = api.QuiesceStatusResponse.decode(ref_api.QuiesceStatusResponse(**response).encode())
    assert (back.acked_id, back.acked_phase, back.holder_count, back.chip_count) == \
        ("mig-x", "resumed", 3, 4)
    assert api.QuiesceStatusRequest().encode() == ref_api.QuiesceStatusRequest().encode() == b""
    assert [r.name for r in api.QuiesceStatusResult] == \
        [r.name for r in ref_api.QuiesceStatusResult]
    assert (api.QUIESCE_SERVICE, api.QUIESCE_METHOD) == ("gpu_mount.QuiesceStatusService",
                                                          ref_api.QUIESCE_METHOD_TPU)


class _Tattling:
    """A worker client that fails the test on any call."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        def record(*a, **k):
            self.calls.append(name)
            raise AssertionError("the reconciler touched the worker during a migration")
        return record


def _paused(name, tmp_path) -> list:
    if name == "reference":
        root = short_root()
        cluster = RefCluster(root, n_chips=4).start()
        el, mig = ref_elastic, ref_journal
    else:
        root = None
        cluster = FakeCluster.with_fake_gpus(str(tmp_path / "fake"), 4)
        el, mig = elastic, journal
    calls: list = []
    try:
        cluster.add_target_pod("trainer")
        rec = el.ElasticReconciler(cluster.kube, registry=None,
                                   client_factory=lambda addr: _Tattling(calls), cfg=cluster.cfg)
        el.IntentStore(cluster.kube, cluster.cfg).put("default", "trainer",
                                                      el.Intent(desired_chips=2))
        out = []
        for annotation, value in (
                (mig.ANNOT_JOURNAL, mig.dump(mig.new_journal("mig-1", "default", "trainer",
                                                             "default", "other"))),
                (mig.ANNOT_LOCK, json.dumps({"id": "mig-2", "role": "destination"}))):
            cluster.kube.patch_pod("default", "trainer", {"metadata": {"annotations": {
                mig.ANNOT_JOURNAL: None, mig.ANNOT_LOCK: None}}})
            cluster.kube.patch_pod("default", "trainer",
                                   {"metadata": {"annotations": {annotation: value}}})
            out.append(rec.reconcile_once("default", "trainer"))
        return [(o["phase"], o["migration"]) for o in out] + [calls]
    finally:
        cluster.stop()
        if root:
            shutil.rmtree(root, ignore_errors=True)


def test_the_reconciler_pauses_during_a_migration_as_the_references(tmp_path):
    got = {name: _paused(name, tmp_path) for name in ("reference", "port")}
    assert got["port"] == got["reference"] == [("migrating", "mig-1"), ("migrating", "mig-2"),
                                               []]


def _stale_lock(kube, mig) -> list:
    for name in ("src", "dst"):
        kube.create_pod("default", {"metadata": {"name": name, "namespace": "default"},
                                    "spec": {"containers": [{"name": "main"}]}})
    j = mig.new_journal("mig-done", "default", "src", "default", "dst")
    j["outcome"] = "succeeded"
    kube.patch_pod("default", "src", {"metadata": {"annotations": {
        mig.ANNOT_JOURNAL: mig.dump(j)}}})
    kube.patch_pod("default", "dst", {"metadata": {"annotations": {mig.ANNOT_LOCK: json.dumps(
        {"id": "mig-done", "role": "destination",
         "source": {"namespace": "default", "pod": "src"}})}}})
    annotations = kube.get_pod("default", "dst")["metadata"]["annotations"]
    out = [mig.migration_active(annotations), mig.migration_active(annotations, kube=kube)]
    kube.delete_pod("default", "src")
    out.append(mig.migration_active(annotations, kube=kube))
    kube.create_pod("default", {"metadata": {"name": "src", "namespace": "default"},
                                "spec": {"containers": [{"name": "main"}]}})
    kube.patch_pod("default", "src", {"metadata": {"annotations": {
        mig.ANNOT_JOURNAL: mig.dump(mig.new_journal("mig-done", "default", "src", "default",
                                                    "dst"))}}})
    return out + [mig.migration_active(annotations, kube=kube)]


def test_a_stale_destination_lock_heals_itself_as_the_references():
    got = {"reference": _stale_lock(RefFake(), ref_journal), "port": _stale_lock(
        FakeKubeClient(), journal)}
    assert got["port"] == got["reference"] == ["mig-done", None, None, "mig-done"]


def _hook(kube, watch, mig) -> list:
    kube.create_pod("default", {"metadata": {"name": "trainer", "namespace": "default"},
                                "spec": {"containers": [{"name": "main"}]}})
    # a signal from before the watcher (a tenant restarted mid-migration) is
    # delivered, unlike the heal's baseline
    kube.patch_pod("default", "trainer", {"metadata": {"annotations": {
        mig.ANNOT_PHASE: json.dumps({"id": "mig-7", "phase": "quiesce"})}}})
    events: list = []
    stop = threading.Event()
    thread = threading.Thread(target=watch, args=(kube, "default", "trainer",
                                                  lambda sig: events.append(("quiesce", sig))),
                              kwargs={"on_resume": lambda sig: events.append(("resume", sig)),
                                      "stop": stop, "watch_timeout_s": 2.0}, daemon=True)
    thread.start()

    def ack():
        raw = kube.get_pod("default", "trainer")["metadata"]["annotations"][mig.ANNOT_ACK]
        return {k: v for k, v in json.loads(raw).items() if k != "at"}

    try:
        _wait_for(lambda: events, 5.0, "the signal from before was not delivered")
        _wait_for(lambda: mig.ANNOT_ACK in kube.get_pod("default", "trainer")["metadata"]
                  ["annotations"], 5.0, "no ack")
        out = [events[0], ack()]
        kube.patch_pod("default", "trainer", {"metadata": {"annotations": {
            mig.ANNOT_PHASE: json.dumps({"id": "mig-7", "phase": "quiesce"})}}})
        time.sleep(0.3)
        out.append(len(events))
        kube.patch_pod("default", "trainer", {"metadata": {"annotations": {
            mig.ANNOT_PHASE: json.dumps({"id": "mig-7", "phase": "resume",
                                         "chips": ["a", "b"]})}}})
        _wait_for(lambda: len(events) == 2 and ack()["phase"] == "resumed", 5.0,
                  "the resume was not delivered and acked")
        return out + [events[1][0], ack()]
    finally:
        stop.set()
        thread.join(timeout=5.0)


def test_the_tenant_hook_delivers_and_acks_as_the_references():
    got = {"reference": _hook(RefFake(), ref_tenant.watch_migration, ref_journal),
           "port": _hook(FakeKubeClient(), tenant.watch_migration, journal)}
    assert got["port"] == got["reference"] == [
        ("quiesce", {"id": "mig-7", "phase": "quiesce"}), {"id": "mig-7", "phase": "quiesced"},
        1, "resume", {"id": "mig-7", "phase": "resumed"}]


def _series(s: Side) -> list:
    _pods(s)
    assert _migrate(s, {})["outcome"] == "succeeded"
    _, metrics = http(s.base, "GET", "/metrics")
    return ['tpumounter_migrations_total{outcome="succeeded",phase="verify"}' in metrics,
            'tpumounter_migration_phase_duration_seconds_count{phase="drain"}' in metrics,
            "tpumounter_migration_downtime_seconds_count" in metrics]


def test_the_migration_series_are_rendered_as_the_references(tmp_path):
    got = _both(tmp_path, _series)
    assert got["port"] == got["reference"] == [True, True, True]
    for series in ("MIGRATIONS_TOTAL", "MIGRATION_PHASE_DURATION", "MIGRATION_DOWNTIME"):
        ours, theirs = getattr(orchestrator, series), getattr(ref_orchestrator, series)
        assert (type(ours).__name__, ours.name, ours.help) == \
            (type(theirs).__name__, theirs.name, theirs.help), series


def test_the_package_exports_the_references_names():
    assert sorted(migrate.__all__) == sorted(ref_migrate.__all__)
    assert sorted(elastic.__all__) == sorted(ref_elastic.__all__)
    assert migrate.MigrationCoordinator.ABORTABLE_PHASES == \
        ref_migrate.MigrationCoordinator.ABORTABLE_PHASES


@pytest.mark.parametrize("name", ["reference", "port"])
def test_an_abort_before_the_remount_rolls_back(tmp_path, name):
    """An abort while the quiesce waits for its ack lands at the next
    boundary: the journal ends aborted and the source keeps its GPUs; a
    second abort of the finished migration is 409."""
    with STACKS[name](tmp_path / name) as s:
        _pods(s)
        before = s.chips(NODE_A, "trainer-a")
        status, body = http(s.base, "POST", "/migrate", {
            "source": {"namespace": "default", "pod": "trainer-a"},
            "destination": {"namespace": "default", "pod": "trainer-b"}})
        mid = json.loads(body)["id"]
        status, body = http(s.base, "POST", f"/migrations/{mid}/abort")
        assert (status, json.loads(body)) == (200, {"id": mid, "aborting": True})
        final = s.app.migrations.wait(mid, timeout_s=30.0)
        assert final["outcome"] == "aborted" and final["phase"] == "done"
        assert s.chips(NODE_A, "trainer-a") == before and s.chips(NODE_B, "trainer-b") == []
        assert http(s.base, "POST", f"/migrations/{mid}/abort")[0] == 409
