"""The master over real HTTP, on the reference's stack and on the port's.

The reference's stack is ``tests/test_master.py``'s: real HTTP -> its
``MasterApp`` -> real gRPC -> its worker -> its ``FakeCluster``. The port's is
the same shape in ``gpumounter_tpu_torch``, once over gRPC (the kubelet over
its gRPC socket too) and once over ``LoopbackWorkerClient`` (no network
between master and worker). The reference's scenarios run on all three and
record status codes, bodies, visible nodes and free counts; the records must
be equal, with the reference's TPU read as GPU (its node is tpu-node-0, the
port's gpu-node-0). The routes are the original GPUMounter's
(/addgpu/.../gpu/..., /removegpu/...), which both masters serve.

Then the registry's informer on both implementations: watch-based reads,
recovery after a dropped watch, and a watch event racing a LIST; and
``entry.master_check`` and ``entry.slice_check`` on the CPU, over gRPC, and
their refusal on a host without grpcio. No test sleeps to wait for a state.
Every comparison is exact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
from conftest import AUTH_HEADER

from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.mounter import MountTarget as RefTarget
from gpumounter_tpu.worker.mounter import TpuMounter
from gpumounter_tpu.worker.server import TpuMountService
from gpumounter_tpu.worker.server import build_server as ref_build_server
from gpumounter_tpu_torch.entry import SLICE_FLEET, master_check, slice_check
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master import app as port_app
from gpumounter_tpu_torch.testing.cluster import FakeCluster, LoopbackWorkerClient
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev
from gpumounter_tpu_torch.worker.server import build_server

N = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


class _RefStack:
    """tests/test_master.py's stack fixture."""

    resource = "google.com/tpu"

    def __init__(self, root):
        self.cluster = RefCluster(os.path.join(root, "ref"), n_chips=N).start()
        self.dev = os.path.join(root, "ref-dev")
        os.makedirs(self.dev)
        collector = TpuCollector(backend=self.cluster.backend,
                                 podresources=PodResourcesClient(
                                     self.cluster.cfg.kubelet_socket, timeout_s=5.0),
                                 cfg=self.cluster.cfg)
        mounter = TpuMounter(self.cluster.backend, cfg=self.cluster.cfg)
        mounter.resolve_target = lambda pod: RefTarget(
            dev_dir=self.dev, description=f"{pod.namespace}/{pod.name}")
        self.service = TpuMountService(self.cluster.kube, collector=collector, mounter=mounter,
                                       cfg=self.cluster.cfg)
        self.grpc = ref_build_server(self.service, address="localhost:0")
        self.grpc.start()
        self.cfg = self.cluster.cfg.replace(worker_port=self.grpc.bound_port)
        self.cluster.kube.create_pod(self.cfg.worker_namespace, {
            "metadata": {"name": "tpu-mounter-worker-abc", "namespace": self.cfg.worker_namespace,
                         "labels": {"app": "tpu-mounter-worker"}},
            "spec": {"nodeName": self.cluster.node_name, "containers": [{"name": "worker"}]},
            "status": {"phase": "Running", "podIP": "127.0.0.1"}})
        self.app = ref_app.MasterApp(self.cluster.kube, cfg=self.cfg,
                                     registry=ref_app.WorkerRegistry(self.cluster.kube, self.cfg))
        self.httpd = ref_app.build_http_server(self.app, port=0, host="127.0.0.1")
        self.base = _serve(self.httpd)

    def make_app(self, **changes):
        cfg = self.cfg.replace(**changes)
        return ref_app.MasterApp(self.cluster.kube, cfg=cfg,
                                 registry=ref_app.WorkerRegistry(self.cluster.kube, cfg))

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.registry.stop()
        self.grpc.stop(grace=None)
        self.cluster.stop()

    def held(self, pod):
        return [d.uuid for d in self.service.collector.get_pod_devices(pod, "default")]

    def node_path(self, uuid):
        return os.path.join(self.dev, self.service.collector.get_device_by_uuid(uuid).basename)

    def visible(self):
        return sum(1 for n in os.listdir(self.dev) if n.startswith("accel"))

    def free(self):
        return self.cluster.free_chip_count()


class _PortStack:
    resource = "nvidia.com/gpu"

    def __init__(self, root, transport):
        self.cluster = FakeCluster.with_fake_gpus(os.path.join(root, transport), N)
        self.dev = os.path.join(root, f"{transport}-dev")
        os.makedirs(self.dev)
        self.service = self.cluster.service(
            self.dev, kubelet="grpc" if transport == "grpc" else "memory")
        self.grpc, self.factory = None, None
        self.cfg = self.cluster.cfg
        if transport == "grpc":
            self.grpc = build_server(self.service, address="127.0.0.1:0")
            self.grpc.start()
            self.cfg = dataclasses.replace(self.cfg, worker_port=self.grpc.bound_port)
        else:
            self.factory = LoopbackWorkerClient.factory(self.service)
        self.cluster.register_worker()
        self.app = port_app.MasterApp(self.cluster.kube, cfg=self.cfg,
                                      worker_client_factory=self.factory)
        self.httpd = port_app.build_http_server(self.app, port=0, host="127.0.0.1")
        self.base = _serve(self.httpd)

    def make_app(self, **changes):
        return port_app.MasterApp(self.cluster.kube, cfg=dataclasses.replace(self.cfg, **changes))

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.registry.stop()
        if self.grpc is not None:
            self.grpc.stop(None).wait()
        self.cluster.stop()

    def held(self, pod):
        return [d.uuid for d in self.service.collector.get_pod_devices(pod, "default")]

    def node_path(self, uuid):
        return os.path.join(self.dev, self.cluster.backend.device_by_uuid(uuid).basename)

    def visible(self):
        return gpus_visible_in_dev(self.dev)

    def free(self):
        return self.cluster.free_gpu_count()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("master"))
    made = {"reference": _RefStack(root), "port": _PortStack(root, "grpc"),
            "loopback": _PortStack(root, "loopback")}
    yield made
    for stack in made.values():
        stack.close()


def http(stack, method, path, form=None, auth=True):
    data = urllib.parse.urlencode(form, doseq=True).encode() if form is not None else None
    req = urllib.request.Request(stack.base + path, data=data, method=method,
                                 headers=dict(AUTH_HEADER) if auth else {})
    try:
        with urllib.request.urlopen(req) as resp:
            status, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read().decode()
    return status, body.replace("TPU", "GPU").replace("tpu-node-0", "gpu-node-0")


def _add(stack, pod, n, entire="false"):
    return http(stack, "GET", f"/addgpu/namespace/default/pod/{pod}/gpu/{n}/"
                              f"isEntireMount/{entire}")


def _remove(stack, pod, form, force="false"):
    return http(stack, "POST", f"/removegpu/namespace/default/pod/{pod}/force/{force}", form)


# --- the scenarios of tests/test_master.py ---

def index_and_health(s, _):
    return [http(s, "GET", "/"), http(s, "GET", "/healthz", auth=False),
            http(s, "GET", "/healthz")]


def add_remove_via_http(s, pod):
    s.cluster.add_target_pod(pod)
    seen = [_add(s, pod, 2), s.visible(), s.free()]
    seen += [_remove(s, pod, {"uuids": ",".join(s.held(pod))}), s.visible(), s.free()]
    assert seen == [(200, "Add GPU Success\n"), 2, N - 2,
                    (200, "Remove 2 GPUs Success\n"), 0, N]
    return seen


def legacy_route_and_repeated_uuids(s, pod):
    """The original's route shape, and uuids as repeated form fields."""
    s.cluster.add_target_pod(pod)
    seen = [_add(s, pod, 1), _add(s, pod, 1), s.visible()]
    seen += [_remove(s, pod, {"uuids": s.held(pod)}), s.visible(), s.free()]
    assert seen[-1] == N
    return seen


def error_mapping(s, pod):
    s.cluster.add_target_pod(pod)
    seen = [_add(s, "ghost", 1),                      # no pod: 404 (main.go:55-59)
            _add(s, "ghost", "xx"),                   # bad gpuNum: 400
            _add(s, "ghost", 1, entire="maybe")]      # bad bool: 400
    seen += [_add(s, "ghost", bad) for bad in ("0", "-3", "65")]  # out of range: 400
    seen += [_add(s, pod, 64), s.free(), s.visible(),  # insufficient: 500
             _remove(s, pod, {}),                     # no uuids: 400
             _remove(s, pod, {"uuids": "GPU-nope"}),  # unknown uuid: 400
             _remove(s, "ghost", {"uuids": "x"}),     # no pod on remove: 404
             http(s, "GET", "/nope"),                 # no route: 404
             http(s, "GET", "/metrics/../nope"),
             http(s, "POST", "/addgpu/namespace/default/pod/x/gpu/1/isEntireMount/false"),
             http(s, "GET", f"/addgpu/namespace/default/pod/{pod}/gpu/1/isEntireMount/false",
                  auth=False),                        # no token: 401
             _remove(s, pod, {"uuids": "x"}, force="nah")]
    assert seen[0][0] == 404 and seen[6][0] == 500 and seen[-2][0] == 401
    return seen


def placement_errors(s, pod):
    """A pod not scheduled yet (400) and a pod on a node with no worker
    (500)."""
    kube = s.cluster.kube
    kube.create_pod("default", {"metadata": {"name": f"{pod}-pending", "namespace": "default"},
                                "spec": {"containers": [{"name": "main", "resources": {
                                    "limits": {s.resource: 99}}}]}})
    kube.create_pod("default", {"metadata": {"name": f"{pod}-far", "namespace": "default"},
                                "spec": {"nodeSelector": {"kubernetes.io/hostname": "far-node"},
                                         "containers": [{"name": "main"}]}})
    far = kube.wait_for_pod("default", f"{pod}-far",
                            lambda pj: pj is not None and Pod(pj).node_name, timeout_s=5)
    assert far is not None
    seen = [_add(s, f"{pod}-pending", 1), _add(s, f"{pod}-far", 1),
            _remove(s, f"{pod}-far", {"uuids": "x"})]
    for name in (f"{pod}-pending", f"{pod}-far"):
        kube.delete_pod("default", name)
    return seen


def busy_maps_to_400(s, pod):
    s.cluster.add_target_pod(pod)
    seen = [_add(s, pod, 1)]
    (uuid,) = s.held(pod)
    with open(s.node_path(uuid), "rb"):
        seen += [_remove(s, pod, {"uuids": uuid}), s.visible()]
    seen += [_remove(s, pod, {"uuids": uuid}), s.visible(), s.free()]
    assert seen[1] == (400, f"Pod: {pod} has running processes on GPU: {uuid}\n")
    return [seen[0], seen[1][0], *seen[2:]]


SCENARIOS = [index_and_health, add_remove_via_http, legacy_route_and_repeated_uuids,
             error_mapping, placement_errors, busy_maps_to_400]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(stacks, scenario):
    pod = scenario.__name__.replace("_", "-")
    records = {name: scenario(stack, pod) for name, stack in stacks.items()}
    assert records["port"] == records["reference"]
    assert records["loopback"] == records["port"]


def test_the_breaker_answers_503_with_retry_after(stacks):
    """A node whose worker refuses connections: the first calls fail (500),
    the breaker opens after its threshold, and the route then answers 503
    with Retry-After before any dial, on both masters alike."""
    records = {}
    for name in ("reference", "port"):
        stack = stacks[name]
        kube = stack.cluster.kube
        worker = {"metadata": {"name": "dead-worker", "namespace": stack.cfg.worker_namespace,
                               "labels": dict([stack.cfg.worker_label_selector.split("=")])},
                  "spec": {"nodeName": "dead-node", "containers": [{"name": "w"}]},
                  "status": {"phase": "Running", "podIP": "127.0.0.2"}}
        kube.create_pod(stack.cfg.worker_namespace, worker)
        kube.create_pod("default", {"metadata": {"name": "stranded", "namespace": "default"},
                                    "spec": {"nodeSelector": {
                                        "kubernetes.io/hostname": "dead-node"},
                                        "containers": [{"name": "main"}]}})
        assert kube.wait_for_pod("default", "stranded",
                                 lambda pj: pj is not None and Pod(pj).node_name, timeout_s=5)
        app = stack.make_app(breaker_failure_threshold=2, breaker_reset_s=60,
                             rpc_max_attempts=1)
        try:
            path = "/addgpu/namespace/default/pod/stranded/gpu/1/isEntireMount/false"
            seen = []
            for _ in range(3):
                status, _, body, headers = app.handle("GET", path, b"", dict(AUTH_HEADER))
                # the reference's trace header comes with obs/
                seen.append((status, body.split(";")[0].split(":")[0],
                             [h for h in headers if h == "Retry-After"]))
            records[name] = seen
            assert 55 <= int(headers["Retry-After"]) <= 60
        finally:
            app.registry.stop()
            kube.delete_pod("default", "stranded")
            kube.delete_pod(stack.cfg.worker_namespace, "dead-worker")
    assert records["port"] == records["reference"] == [
        (500, "Service Internal Error", []), (500, "Service Internal Error", []),
        (503, "worker on node dead-node is degraded (circuit breaker open)", ["Retry-After"])]


def test_the_port_serves_only_the_original_surface(stacks):
    """The reference's other routes wait for their packages: their paths get
    the structured 404. /workers lists the node's worker. The observability
    reads (/audit, /trace/<id>, /timeline), the API-outage pane (/apihealth),
    the shard table (/shards, an inactive manager's here), the fleet planes
    (/fleet, /slo, /tenants) and the recovery and health panes (/recovery,
    /health/nodes) are served, and want the mutate token while no read token
    is configured; /metrics is then open. With a read token every one of
    those reads takes it or the mutate token, nothing else, and the read
    token opens no mutation: not /addgpu, and not the two POSTs of the
    recovery and health planes. The intents and migrations (/intents,
    /intents/<ns>/<pod>, /migrate, /migrations, /migrations/<mid> and its
    abort) are served and want the mutate token, whatever the read token,
    as the reference's. So are the capacity pane and the share books
    (/capacity, /shares), reads in the read scope, and the shares' admission
    and release (POST /shares, DELETE /shares/<ns>/<pod>), which want the
    mutate token. 33 of the reference's 41 routes are served, each under the
    reference's name; its defrag and autoscale routes get the 404."""
    served = [name for _, _, name in port_app._ROUTES]
    assert len(served) == 33 and len(ref_app._ROUTES) == 41
    assert set(served) <= {name for _, _, name in ref_app._ROUTES}
    s = stacks["port"]
    for method, path, want in (("GET", "/intents", 200), ("GET", "/migrations", 200),
                               ("GET", "/migrations/mig-none", 404),
                               ("POST", "/migrations/mig-none/abort", 404),
                               ("GET", "/intents/default/no-such-pod", 404),
                               ("DELETE", "/intents/default/no-such-pod", 404),
                               ("POST", "/migrate", 400)):
        assert http(s, method, path, {} if method == "POST" else None)[0] == want, path
        assert http(s, method, path, auth=False) == (401, "missing or invalid bearer token\n")
    status, body = http(s, "GET", "/apihealth")
    assert status == 200 and set(json.loads(body)) == {"api", "store"}
    assert http(s, "GET", "/apihealth", auth=False) == (401, "missing or invalid bearer token\n")
    status, body = http(s, "GET", "/shards")
    assert status == 200 and json.loads(body)["active"] is False
    assert http(s, "GET", "/shards", auth=False) == (401, "missing or invalid bearer token\n")
    for path in ("/defrag", "/autoscale",
                 "/addtpu/namespace/default/pod/p/tpu/1/isEntireMount/false"):
        assert http(s, "GET", path) == (404, "404 page not found\n"), path
    for path in ("/defrag/plan", "/autoscale/pause"):
        assert http(s, "POST", path, {}) == (404, "404 page not found\n"), path
    assert set(served) == {name for _, _, name in ref_app._ROUTES} - {
        "defrag", "defrag_plan", "defrag_run", "defrag_pause", "autoscale",
        "autoscale_pause", "autoscale_resume", "autoscale_evaluate"}
    status, body = http(s, "GET", "/metrics", auth=False)
    assert status == 200 and "tpumounter_mount_total" in body
    for path, key in (("/fleet", "nodes"), ("/slo", "objectives"), ("/tenants", "tenants"),
                      ("/recovery", "evacuations"), ("/health/nodes", "quarantine_budget"),
                      ("/capacity", "feasibility"), ("/shares", "totals")):
        status, body = http(s, "GET", path)
        assert status == 200 and key in json.loads(body), path
        assert http(s, "GET", path, auth=False) == (401, "missing or invalid bearer token\n")
    read = {"Authorization": "Bearer read-only-scope"}
    scoped = s.make_app(auth_read_token="read-only-scope")
    try:
        for route in ("/metrics", "/fleet", "/slo", "/tenants", "/audit", "/timeline",
                      "/apihealth", "/shards", "/recovery", "/health/nodes", "/capacity",
                      "/shares"):
            assert scoped.handle("GET", route, b"", read)[0] == 200, route
            assert scoped.handle("GET", route, b"", dict(AUTH_HEADER))[0] == 200, route
            assert scoped.handle("GET", route, b"", {})[:3] == (
                401, "text/plain", "missing or invalid bearer token (read scope)\n"), route
        assert scoped.handle("GET", "/trace/" + "0" * 32, b"", read)[0] == 404
        assert scoped.handle("GET", "/addgpu/namespace/default/pod/p/gpu/1/isEntireMount/"
                                    "false", b"", read)[:3] == (
            401, "text/plain", "missing or invalid bearer token\n")
        assert scoped.handle("GET", "/workers", b"", read)[0] == 401
        for path in ("/recovery/evacuate/gpu-node-0", "/health/quarantine/gpu-node-0",
                     "/migrate", "/migrations/mig-none/abort", "/shares"):
            assert scoped.handle("POST", path, b"", read)[:3] == (
                401, "text/plain", "missing or invalid bearer token\n"), path
        for method, path in (("GET", "/intents"), ("GET", "/migrations"),
                             ("PUT", "/intents/default/p"), ("DELETE", "/intents/default/p"),
                             ("DELETE", "/shares/default/p")):
            assert scoped.handle(method, path, b"", read)[:3] == (
                401, "text/plain", "missing or invalid bearer token\n"), path
    finally:
        scoped.close()
    assert http(s, "POST", "/batch/addtpu", {}) == (404, "404 page not found\n")
    assert http(s, "GET", "/workers") == (200, "gpu-node-0 127.0.0.1\n")
    assert http(s, "GET", "/workers", auth=False) == (401, "missing or invalid bearer token\n")
    for path in ("/addslice", "/removeslice", "/batch/addgpu"):
        assert http(s, "POST", path, {})[0] != 404, path
    for path in ("/audit", "/audit?op=http.&limit=5", "/timeline", "/timeline?kind=span"):
        status, body = http(s, "GET", path)
        assert status == 200 and "records" in json.loads(body), path
        assert http(s, "GET", path, auth=False) == (401, "missing or invalid bearer token\n")
    assert http(s, "GET", "/trace/" + "0" * 32)[0] == 404  # served: no spans for that id
    assert http(s, "GET", "/trace/" + "0" * 32, auth=False) == (
        401, "missing or invalid bearer token\n")


def test_a_master_without_a_token_refuses_to_start(stacks):
    from gpumounter_tpu_torch.utils.auth import AuthConfigError
    s = stacks["port"]
    with pytest.raises(AuthConfigError, match="TPUMOUNTER_AUTH=insecure"):
        s.make_app(auth_token="", auth_token_file="")
    open_app = s.make_app(auth_mode="insecure")
    assert open_app.handle("GET", "/workers", b"", {})[0] == 200
    open_app.registry.stop()


# --- the registry's informer, on both implementations ---

REGISTRIES = {
    "reference": lambda root: (RefCluster(root, n_chips=1).start(), ref_app.WorkerRegistry),
    "port": lambda root: (FakeCluster.with_fake_gpus(root, 1), port_app.WorkerRegistry),
}


@pytest.fixture(params=list(REGISTRIES))
def registry_cluster(request, tmp_path):
    cluster, registry_cls = REGISTRIES[request.param](str(tmp_path))
    yield cluster, registry_cls
    cluster.stop()


def _worker_pod(cfg, name, node, ip):
    key, value = cfg.worker_label_selector.split("=")
    return {"metadata": {"name": name, "namespace": cfg.worker_namespace,
                         "labels": {key: value}},
            "spec": {"nodeName": node, "containers": [{"name": "w"}]},
            "status": {"phase": "Running", "podIP": ip}}


def _changes(reg):
    """A wait for a state of reg's cache, woken by each delta and each
    LIST (no sleep)."""
    cond = threading.Condition()

    def notifying(fn):
        def call(*args):
            out = fn(*args)
            with cond:
                cond.notify_all()
            return out
        return call

    reg._apply = notifying(reg._apply)
    reg._refresh_locked = notifying(reg._refresh_locked)

    def wait(predicate, timeout_s):
        deadline = time.monotonic() + timeout_s
        with cond:
            while not predicate(dict(reg._cache)):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                cond.wait(remaining)
        return True

    return wait


def test_worker_registry_is_watch_based(registry_cluster):
    cluster, registry_cls = registry_cluster
    cfg, kube = cluster.cfg, cluster.kube
    list_calls = []
    orig_list = kube.list_pods

    def counting_list(*args, **kwargs):
        list_calls.append(1)
        return orig_list(*args, **kwargs)

    kube.list_pods = counting_list
    kube.create_pod(cfg.worker_namespace, _worker_pod(cfg, "w1", "node-a", "10.0.0.1"))
    reg = registry_cls(kube, cfg)
    wait = _changes(reg)
    try:
        assert reg.worker_address("node-a") == f"10.0.0.1:{cfg.worker_port}"
        primed = len(list_calls)
        assert primed >= 1
        for _ in range(50):
            assert reg.worker_address("node-a") is not None
            reg.registry_snapshot()
        assert len(list_calls) == primed, "reads hit the API server"
        kube.create_pod(cfg.worker_namespace, _worker_pod(cfg, "w2", "node-b", "10.0.0.2"))
        assert wait(lambda c: "node-b" in c, 5), "the watch never delivered the new worker"
        kube.delete_pod(cfg.worker_namespace, "w2")
        assert wait(lambda c: "node-b" not in c, 5), "the watch never dropped the worker"
        assert len(list_calls) == primed
    finally:
        reg.stop()


def test_registry_recovers_after_dropped_watch(registry_cluster):
    cluster, registry_cls = registry_cluster
    cfg, kube = cluster.cfg, cluster.kube
    kube.create_pod(cfg.worker_namespace, _worker_pod(cfg, "w1", "node-a", "10.0.0.1"))
    reg = registry_cls(kube, cfg)
    wait = _changes(reg)
    try:
        assert reg.worker_address("node-a") is not None
        orig_watch = kube.watch_pods
        broken = threading.Event()
        broken.set()

        def flaky_watch(*args, **kwargs):
            if broken.is_set():
                raise RuntimeError("watch dropped (apiserver restart)")
            return orig_watch(*args, **kwargs)

        kube.watch_pods = flaky_watch
        kube.create_pod(cfg.worker_namespace, _worker_pod(cfg, "w2", "node-b", "10.0.0.2"))
        reg._last_list = -1e9  # age the stamp: allow the miss's LIST
        assert reg.worker_address("node-b") == f"10.0.0.2:{cfg.worker_port}"
        broken.clear()
        kube.create_pod(cfg.worker_namespace, _worker_pod(cfg, "w3", "node-c", "10.0.0.3"))
        assert wait(lambda c: "node-c" in c, 10), "the watch loop never recovered"
    finally:
        reg.stop()


def test_registry_refresh_does_not_lose_racing_watch_event(registry_cluster):
    cluster, registry_cls = registry_cluster
    cfg, kube = cluster.cfg, cluster.kube
    kube.create_pod(cfg.worker_namespace, _worker_pod(cfg, "w1", "node-a", "10.0.0.1"))
    reg = registry_cls(kube, cfg)
    try:
        assert reg.worker_address("node-a") is not None
        pod_cls = type(reg)._apply_to.__globals__["Pod"]
        deleted = pod_cls({"metadata": {"name": "w1", "namespace": cfg.worker_namespace},
                           "spec": {"nodeName": "node-a"}, "status": {}})
        orig_list = kube.list_pods

        def racing_list(*args, **kwargs):
            pods = orig_list(*args, **kwargs)
            reg._apply("DELETED", deleted)  # the delta that races the LIST
            return pods

        kube.list_pods = racing_list
        reg._last_list = -1e9
        reg._refresh()
        assert "node-a" not in reg._cache, "the LIST resurrected a worker deleted during it"
    finally:
        reg.stop()


def test_master_check_on_the_cpu():
    """``entry.master_check`` on a fake host of 8 GPUs, over the worker's
    gRPC server: the HTTP flows of 1 and of 8 GPUs and the error mapping,
    status and body."""
    report = master_check("cpu", fake_gpus=8, repeats=1)
    assert "live" not in report and "live_errors" not in report
    assert sorted(report["fake"]) == [1, 8]
    for n, flow in report["fake"].items():
        assert flow["case"] == "round-trip" and len(flow["uuids"]) == n
        assert len(flow["add_ms"]) == len(flow["remove_ms"]) == 1
    assert report["fake_errors"] == {
        "insufficient": (500, "Insufficient GPU on Node: gpu-node-0"),
        "no pod": (404, "No pod: ghost in namespace: default"),
        "unknown uuid": (400, "Invalid UUIDs: GPU-not-here"),
        "no token": (401, "missing or invalid bearer token")}
    assert len(report["call_ms"]["fake"]) == 1 and report["codec_ms"] > 0


def test_master_check_without_grpcio_raises_and_names_grpcio():
    """No fallback: the check runs over gRPC or not at all."""
    prog = ("import sys\n"
            "sys.modules['grpc'] = None\n"
            "from gpumounter_tpu_torch.entry import master_check\n"
            "try:\n"
            "    master_check('cpu', fake_gpus=1, repeats=1)\n"
            "except ModuleNotFoundError as exc:\n"
            "    print('raised', exc.name, exc)\n")
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("raised grpc ") and "grpcio" in out.stdout


def test_slice_check_without_grpcio_raises_and_names_grpcio():
    """No fallback for the slice check either."""
    prog = ("import sys\n"
            "sys.modules['grpc'] = None\n"
            "from gpumounter_tpu_torch.entry import slice_check\n"
            "try:\n"
            "    slice_check('cpu', repeats=1)\n"
            "except ModuleNotFoundError as exc:\n"
            "    print('raised', exc.name, exc)\n")
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("raised grpc ") and "grpcio" in out.stdout


def test_slice_check_on_the_cpu():
    """``entry.slice_check`` on the fake fleet of 4 hosts of 8 GPUs, over one
    worker gRPC server a node: the slice of all 32 added and removed (the
    plan's ranks checked), the squatted slice rolled back with 503 and every
    other host free, the batch of 8 targets and a ghost, and the fan-out
    core's tasks of each kind."""
    report = slice_check("cpu", repeats=1)
    assert "live" not in report
    fleet = report["fleet"]
    assert (fleet["case"], fleet["hosts"], fleet["gpus"]) == (
        "round-trip", SLICE_FLEET["NODES"], SLICE_FLEET["GPUS"])
    assert len(fleet["add_ms"]) == len(fleet["remove_ms"]) == 1
    assert [w["env"]["NODE_RANK"] for w in fleet["plan"]["workers"]] == ["0", "1", "2", "3"]
    assert fleet["plan"]["slice"]["WORLD_SIZE"] == "32"
    assert report["rollback"]["status"] == 503
    assert report["rollback"]["body"] == "slice mount failed (rank-2: InsufficientGPU)"
    assert report["batch"]["by_result"] == {"Success": 8, "PodNotFound": 1}
    # one task a host for each slice request; one a node group of each batch
    assert report["fanout_tasks"] == {"slice-mount": 8, "slice-remove": 4, "bulk-mount": 5}
