"""ProbeGPU and the nodes of the Kubernetes API, against the reference.

ProbeGPU (``worker/server.py`` ``probe_gpu``, ``rpc/client.py``
``probe_gpu``) is the reference's ProbeTPU under the GPU name, served as
``gpu_mount.ProbeGPUService/ProbeGPU``: its messages encode to the
reference's bytes, and over real gRPC the two workers answer one scenario
alike (a pod not found, a pod with nothing, a mounted accelerator, a process
holding its host node, its node deleted from the target's /dev). The canary's
default probe drives each package's worker path alike. Nodes: the fake API's
``create_node`` / ``set_node_ready`` / ``delete_node`` and the reads of both
clients (``FakeKubeClient``, and ``RestKubeClient`` over the stand-in API
server) answer as the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import types

import pytest
from test_torch_worker import _Ref
from gpumounter_tpu_torch.testing.kube_api import FakeApiServer, selfsigned
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.health import plane as ref_plane
from gpumounter_tpu.k8s import client as ref_client
from gpumounter_tpu.k8s import errors as ref_errors
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.rpc.client import WorkerClient as RefClient
from gpumounter_tpu_torch.health import plane
from gpumounter_tpu_torch.k8s import client as port_client
from gpumounter_tpu_torch.k8s import errors as port_errors
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.worker.server import build_server

TC = "0123456789abcdef0123456789abcdef-0123456789abcdef"


# --- the messages ---

def test_the_result_values_and_service_names():
    assert [(m.name, int(m)) for m in api.ProbeGPUResult] == [
        (m.name, int(m)) for m in ref_api.ProbeTPUResult]
    assert (api.PROBE_SERVICE, api.PROBE_METHOD) == (
        ref_api.PROBE_SERVICE_TPU.replace("tpu_mount.ProbeTPU", "gpu_mount.ProbeGPU"),
        ref_api.PROBE_METHOD_TPU.replace("TPU", "GPU"))


@pytest.mark.parametrize("pod, ns, tc", [("p", "default", ""), ("tenant-7", "kube-system", TC),
                                         ("", "", "")])
def test_the_probe_request_is_the_references_bytes(pod, ns, tc):
    mine = api.ProbeGPURequest(pod, ns, trace_context=tc)
    ref = ref_api.ProbeTPURequest(pod_name=pod, namespace=ns, trace_context=tc)
    assert mine.encode() == ref.encode()
    back = api.ProbeGPURequest.decode(ref.encode())
    assert (back.pod_name, back.namespace, back.trace_context) == (pod, ns, tc)


@pytest.mark.parametrize("result, chips", [
    (0, []), (1, []),
    (0, [("GPU-a", True, "", 0)]),
    (0, [("GPU-a", True, "", 2), ("GPU-b", False, "injected device node vanished from target "
                                            "/dev", 0)])])
def test_the_probe_response_is_the_references_bytes(result, chips):
    mine = api.ProbeGPUResponse(result, chips=[api.ChipHealth(*c) for c in chips])
    ref = ref_api.ProbeTPUResponse(probe_tpu_result=result, chips=[
        ref_api.ChipHealth(uuid=u, healthy=h, reason=r, holder_count=n) for u, h, r, n in chips])
    assert mine.encode() == ref.encode()
    back = api.ProbeGPUResponse.decode(ref.encode())
    assert [(c.uuid, c.healthy, c.reason, c.holder_count) for c in back.chips] == chips


# --- ProbeGPU over real gRPC, both workers ---

class _Port:
    """The port's worker over gRPC, the container a bare directory."""

    def __init__(self, tmp_path):
        self.cluster = FakeCluster.with_fake_gpus(str(tmp_path / "port"), 4)
        self.dev = str(tmp_path / "port-container-dev")
        os.makedirs(self.dev)
        self.service = self.cluster.service(self.dev)
        self.server = build_server(self.service, address="localhost:0")
        self.server.start()
        self.addr = f"localhost:{self.server.bound_port}"

    def close(self):
        self.server.stop(None).wait()

    def add_pod(self, name, namespace="default"):
        self.cluster.add_target_pod(name, namespace=namespace)

    def add(self, pod, n):
        with WorkerClient(self.addr) as client:
            return list(client.add_gpu(pod, "default", n).uuids)

    def probe(self, pod):
        with WorkerClient(self.addr) as client:
            result, chips = client.probe_gpu(pod, "default")
        return int(result), [(c.healthy, c.reason, c.holder_count) for c in chips]

    def host_path(self, uuid):
        return self.service.collector.backend.device_by_uuid(uuid).device_path

    def node_path(self, uuid):
        return os.path.join(self.dev, self.service.collector.backend.device_by_uuid(uuid)
                            .basename)


class _RefSide(_Ref):
    def add(self, pod, n):
        with RefClient(self.addr) as client:
            return list(client.add_tpu_detailed(pod, "default", n)[1])

    def probe(self, pod):
        with RefClient(self.addr) as client:
            result, chips = client.probe_tpu(pod, "default")
        return int(result), [(c.healthy, c.reason, c.holder_count) for c in chips]

    def host_path(self, uuid):
        return self.service.collector.get_device_by_uuid(uuid).device_path


def _probe_scenario(side) -> list:
    """A pod not found; a pod with nothing; one accelerator mounted; this
    process holding its host node; its node gone from the target's /dev."""
    out = [side.probe("ghost")]
    side.add_pod("p")
    out.append(side.probe("p"))
    (uuid,) = side.add("p", 1)
    out.append(side.probe("p"))
    fd = os.open(side.host_path(uuid), os.O_RDONLY)
    try:
        out.append(side.probe("p"))
    finally:
        os.close(fd)
    os.unlink(side.node_path(uuid))
    out.append(side.probe("p"))
    return out


def test_probe_gpu_answers_as_the_references_over_grpc(tmp_path):
    ref, port = _RefSide(tmp_path), _Port(tmp_path)
    try:
        got = {"reference": _probe_scenario(ref), "port": _probe_scenario(port)}
    finally:
        ref.close()
        port.close()
    assert got["port"] == got["reference"] == [
        (1, []), (0, []), (0, [(True, "", 0)]), (0, [(True, "", 1)]),
        (0, [(False, "injected device node vanished from target /dev", 0)])]


def test_the_worker_rpc_failpoint_fires_for_probe_gpu(tmp_path):
    from gpumounter_tpu_torch.faults import failpoints
    port = _Port(tmp_path)
    try:
        port.add_pod("p")
        with failpoints.armed({"worker.rpc": "error(probe refused)"}):
            with WorkerClient(port.addr) as client, pytest.raises(Exception) as exc:
                client.probe_gpu("p", "default")
            assert failpoints.hits("worker.rpc") == 1
        assert "probe refused" in str(exc.value)
    finally:
        port.close()


# --- the canary's default probe over the worker path ---

def test_the_canary_drives_the_worker_path_as_the_references(tmp_path):
    """A quarantined node's canary: with no canary pod a skip (no probe
    driven), with one a real add, ProbeGPU and forced remove that pass,
    leaving the pod holding nothing; on both packages."""
    sides = {"reference": (_RefSide(tmp_path), ref_plane, RefClient),
             "port": (_Port(tmp_path), plane, WorkerClient)}
    got = {}
    try:
        for name, (side, mod, client_cls) in sides.items():
            port_no = int(side.addr.rsplit(":", 1)[1])
            if name == "reference":
                cfg = side.cluster.cfg.replace(worker_port=port_no, health_enabled=True,
                                               health_canary_namespace="default")
            else:
                cfg = dataclasses.replace(side.cluster.cfg, worker_port=port_no,
                                          health_enabled=True,
                                          health_canary_namespace="default")
            p = mod.HealthPlane(cfg)
            p.quarantine("node-c", reason="limping")
            registry = types.SimpleNamespace(registry_snapshot=lambda: {"node-c": "localhost"})
            prober = mod.CanaryProber(p, registry, lambda a, c=client_cls: c(a), cfg=cfg)
            skipped = prober.probe_once()
            side.add_pod(f"{cfg.health_canary_pod_prefix}node-c")
            driven = prober.probe_once()
            canary = p.payload()["nodes"]["node-c"]["canary"]
            held = side.probe(f"{cfg.health_canary_pod_prefix}node-c")
            got[name] = (skipped, driven, canary["consecutive_ok"],
                         canary["consecutive_failures"], held)
    finally:
        for side, _, _ in sides.values():
            side.close()
    assert got["port"] == got["reference"] == (0, 1, 1, 0, (0, []))


# --- nodes: the fake API and both clients ---

def _node_calls(kube, errors) -> list:
    def strip(node):
        node = dict(node, metadata={k: v for k, v in node["metadata"].items() if k != "uid"})
        return node

    out = [strip(kube.create_node("n1")), strip(kube.create_node("n2", ready=False))]
    kube.set_node_ready("n1", False, reason="KubeletStopped")
    out.append(strip(kube.get_node("n1")))
    out.append(sorted(n["metadata"]["name"] for n in kube.list_nodes()))
    kube.delete_node("n2")
    kube.delete_node("never-there")
    out.append(sorted(n["metadata"]["name"] for n in kube.list_nodes()))
    for call in (lambda: kube.get_node("n2"), lambda: kube.set_node_ready("gone", True)):
        with pytest.raises(errors.NotFoundError) as exc:
            call()
        out.append(str(exc.value))
    kube.set_partitioned(True, mode="reads")
    for call in (lambda: kube.get_node("n1"), kube.list_nodes):
        with pytest.raises(errors.PartitionError):
            call()
    kube.set_partitioned(False)
    return out


def test_the_fake_apis_nodes_are_the_references():
    assert _node_calls(FakeKubeClient(), port_errors) == _node_calls(RefFake(), ref_errors)


@pytest.fixture(scope="module")
def tls(tmp_path_factory):
    pair = selfsigned(str(tmp_path_factory.mktemp("tls")))
    if pair is None:
        pytest.skip("openssl is needed for the stand-in API server's certificate")
    return pair


def test_the_rest_clients_read_nodes_as_the_references(tls):
    """Each client against a fresh stand-in server holding the same nodes: the
    same requests, the same answers (the Node's uid aside), a missing node
    the same 404."""
    got = {}
    for name, mod, errors in (("port", port_client, port_errors),
                              ("reference", ref_client, ref_errors)):
        fake = FakeKubeClient()
        fake.create_node("gpu-node-0")
        fake.create_node("gpu-node-1", ready=False)
        server = FakeApiServer(fake, *tls).start()
        try:
            kube = mod.RestKubeClient("127.0.0.1", server.port, server.token, ca_file=tls[0])
            one = kube.get_node("gpu-node-1")
            many = kube.list_nodes()
            with pytest.raises(errors.ApiError) as exc:
                kube.get_node("missing")
            got[name] = ({**one, "metadata": {"name": one["metadata"]["name"]}},
                         [n["metadata"]["name"] for n in many], exc.value.status,
                         [(m, p) for m, p, _, _ in server.requests])
        finally:
            server.stop()
    assert got["port"] == got["reference"]
    assert got["port"][0]["status"]["conditions"] == [{"type": "Ready", "status": "False"}]
    assert got["port"][1:3] == (["gpu-node-0", "gpu-node-1"], 404)


def test_a_store_reads_node_readiness_through_the_fake():
    """The master's store answers a Node now that the clients have them
    (None when there is none), and a recovery controller reads its Ready."""
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.store import KubeMasterStore
    kube = FakeKubeClient()
    kube.create_node("n1")
    store = KubeMasterStore(kube, Config())
    assert store.get_node("n1")["status"]["conditions"][0]["status"] == "True"
    kube.set_node_ready("n1", False)
    assert store.get_node("n1")["status"]["conditions"][0]["status"] == "False"
    assert store.get_node("n2") is None
