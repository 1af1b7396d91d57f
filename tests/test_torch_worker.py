"""The worker's add and remove flows: the reference's service over gRPC (as
``tests/test_worker.py`` runs it) and the port's ``GpuMountService`` in
process, scenario by scenario, on fake nodes of 4 accelerators each.

Every scenario runs on both and records what a caller sees: the result
integers (the reference's AddTPUResult / RemoveTPUResult and the port's
AddGPUResult / RemoveGPUResult share their values), the gRPC status of a
refused call, the nodes visible in the container's device directory, and
the free count of the node. The two records must be equal.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import grpc
import pytest

from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.rpc.client import WorkerClient
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.mounter import MountTarget as RefTarget
from gpumounter_tpu.worker.mounter import TpuMounter
from gpumounter_tpu.worker.server import TpuMountService, build_server
from gpumounter_tpu_torch.entry import mount_check
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev
from gpumounter_tpu_torch.worker.server import ServiceError

N = 4  # accelerators on the node


def test_result_values_are_the_references():
    assert [(m.name, int(m)) for m in api.AddGPUResult] == [
        (m.name.replace("TPU", "GPU"), int(m)) for m in ref_api.AddTPUResult]
    assert [(m.name, int(m)) for m in api.RemoveGPUResult] == [
        (m.name.replace("TPU", "GPU"), int(m)) for m in ref_api.RemoveTPUResult]


class _Ref:
    """The reference: FakeCluster + TpuMountService over real gRPC, the
    container a bare directory (as tests/test_worker.py wires it)."""

    def __init__(self, tmp_path):
        self.cluster = RefCluster(str(tmp_path / "ref"), n_chips=N).start()
        self.dev = str(tmp_path / "ref-container-dev")
        os.makedirs(self.dev)
        collector = TpuCollector(
            backend=self.cluster.backend,
            podresources=PodResourcesClient(self.cluster.cfg.kubelet_socket, timeout_s=5.0),
            cfg=self.cluster.cfg)
        mounter = TpuMounter(self.cluster.backend, cfg=self.cluster.cfg)
        mounter.resolve_target = lambda pod: RefTarget(
            dev_dir=self.dev, description=f"{pod.namespace}/{pod.name}")
        self.service = TpuMountService(self.cluster.kube, collector=collector,
                                       mounter=mounter, cfg=self.cluster.cfg)
        self.server = build_server(self.service, address="localhost:0")
        self.addr = f"localhost:{self.server.bound_port}"
        self.server.start()

    def close(self):
        self.server.stop(grace=None)
        self.cluster.stop()

    def add_pod(self, name):
        self.cluster.add_target_pod(name)

    def add(self, pod, n, entire=False):
        with WorkerClient(self.addr) as client:
            try:
                return int(client.add_tpu(pod, "default", n, is_entire_mount=entire))
            except grpc.RpcError as exc:
                return exc.code().name

    def remove(self, pod, uuids, force=False):
        with WorkerClient(self.addr) as client:
            return int(client.remove_tpu(pod, "default", uuids, force=force))

    def held(self, pod):
        return [d.uuid for d in self.service.collector.get_pod_devices(pod, "default")]

    def node_path(self, uuid):
        dev = self.service.collector.get_device_by_uuid(uuid)
        return os.path.join(self.dev, dev.basename)

    def visible(self):
        return sum(1 for n in os.listdir(self.dev) if n.startswith("accel"))

    def free(self):
        return self.cluster.free_chip_count()


class _Port:
    """The port: FakeCluster + GpuMountService in process, the container a
    bare directory."""

    def __init__(self, tmp_path):
        self.cluster = FakeCluster.with_fake_gpus(str(tmp_path / "port"), N)
        self.dev = str(tmp_path / "port-container-dev")
        os.makedirs(self.dev)
        self.service = self.cluster.service(self.dev)

    def close(self):
        pass

    def add_pod(self, name):
        self.cluster.add_target_pod(name)

    def add(self, pod, n, entire=False):
        try:
            return int(self.service.add_gpu(api.AddGPURequest(pod, "default", n, entire))
                       .add_gpu_result)
        except ServiceError as exc:
            return exc.code

    def remove(self, pod, uuids, force=False):
        return int(self.service.remove_gpu(
            api.RemoveGPURequest(pod, "default", uuids, force=force)).remove_gpu_result)

    def held(self, pod):
        return [d.uuid for d in self.service.collector.get_pod_devices(pod, "default")]

    def node_path(self, uuid):
        return os.path.join(self.dev, self.cluster.backend.device_by_uuid(uuid).basename)

    def visible(self):
        return gpus_visible_in_dev(self.dev)

    def free(self):
        return self.cluster.free_gpu_count()


def _holder(path):
    """A child process holding `path` open, once it says so."""
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; f = open(sys.argv[1], 'rb'); print('held', "
         "flush=True); sys.stdin.read()", path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    assert child.stdout.readline().strip() == "held"
    return child


# Each scenario returns what the caller saw; tests/test_worker.py:63-210's
# expectations are asserted on the way.

def add_then_remove(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 2), s.visible(), s.free()]
    seen += [s.remove("trainer", s.held("trainer")), s.visible(), s.free()]
    assert seen == [0, 2, 2, 0, 0, 4]
    return seen


def pod_not_found(s):
    seen = [s.add("ghost", 1), s.remove("ghost", ["any"])]
    assert seen == [2, 2]
    return seen


def insufficient(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 99), s.free(), s.add("trainer", 99, entire=True), s.free(),
            s.visible()]
    assert seen == [1, 4, 1, 4, 0]
    return seen


def unknown_uuid(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 1), s.remove("trainer", ["bogus"]), s.visible(), s.free()]
    assert seen == [0, 4, 1, 3]
    return seen


def busy_then_force(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 1)]
    (uuid,) = s.held("trainer")
    child = _holder(s.node_path(uuid))
    try:
        seen += [s.remove("trainer", [uuid]), s.visible(), s.free()]
        seen += [s.remove("trainer", [uuid], force=True), s.visible(), s.free()]
        seen.append(child.wait(timeout=30))  # the forced remove killed the holder
    finally:
        child.kill()
        child.wait()
    assert seen == [0, 1, 1, 3, 0, 0, 4, -9]
    return seen


def busy_then_plain_after_release(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 1)]
    (uuid,) = s.held("trainer")
    with open(s.node_path(uuid), "rb"):
        seen += [s.remove("trainer", [uuid]), s.visible()]
    seen += [s.remove("trainer", [uuid]), s.visible(), s.free()]
    assert seen == [0, 1, 1, 0, 0, 4]
    return seen


def entire_mount_gates(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 2, entire=True), s.add("trainer", 1), s.visible(), s.free()]
    assert seen == [0, "FAILED_PRECONDITION", 2, 2]
    return seen


def single_then_entire(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 1), s.add("trainer", 1, entire=True), s.add("trainer", 1),
            s.visible(), s.free()]
    assert seen == [0, "FAILED_PRECONDITION", 0, 2, 2]
    return seen


def entire_remove_removes_all(s):
    s.add_pod("trainer")
    seen = [s.add("trainer", 2, entire=True), s.visible()]
    first = s.held("trainer")[0]
    seen += [s.remove("trainer", [first]), s.visible(), s.free()]
    assert seen == [0, 2, 0, 0, 4]
    return seen


def concurrent_entire_mounts(s):
    """Two entire mounts of one pod at once: exactly one wins, the other is
    refused by the gate, not mounted twice. The first call's allocation
    waits until the second call has reached the pod lock, so without the
    lock both would pass the gate (no sleeps: an event)."""
    s.add_pod("trainer")
    service = s.service
    arrived, both_here = [], threading.Event()
    locks, held = service._pod_locks, service._pod_locks.held

    def counting_held(key):
        arrived.append(key)
        if len(arrived) == 2:
            both_here.set()
        return held(key)

    locks.held = counting_held
    allocator = service.allocator
    alloc_name = ("get_available_tpus" if hasattr(allocator, "get_available_tpus")
                  else "get_available_gpus")
    orig = getattr(allocator, alloc_name)

    def waiting_alloc(*args, **kwargs):
        both_here.wait(timeout=10)
        return orig(*args, **kwargs)

    setattr(allocator, alloc_name, waiting_alloc)
    results = []
    threads = [threading.Thread(target=lambda: results.append(s.add("trainer", 2, True)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seen = [sorted(results, key=str), len(arrived), s.visible(), s.free()]
    assert seen == [[0, "FAILED_PRECONDITION"], 2, 2, 2]
    return seen


SCENARIOS = [add_then_remove, pod_not_found, insufficient, unknown_uuid, busy_then_force,
             busy_then_plain_after_release, entire_mount_gates, single_then_entire,
             entire_remove_removes_all, concurrent_entire_mounts]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(tmp_path, scenario):
    ref, port = _Ref(tmp_path), _Port(tmp_path)
    try:
        assert scenario(port) == scenario(ref)
    finally:
        ref.close()
        port.close()


def test_add_result_carries_uuids_and_phases(tmp_path):
    port = _Port(tmp_path)
    port.add_pod("trainer")
    resp = port.service.add_gpu(api.AddGPURequest("trainer", "default", 2))
    assert resp.add_gpu_result == api.AddGPUResult.Success
    assert sorted(resp.uuids) == sorted(port.held("trainer"))
    assert {"slave_pod_schedule", "mount", "total"} <= set(resp.phases_ms)
    with pytest.raises(ServiceError) as exc:
        port.service.add_gpu(api.AddGPURequest("trainer", "default", 0))
    assert exc.value.code == "INVALID_ARGUMENT"


def test_flows_through_the_namespace_entry(tmp_path):
    """The same flows with the target entered through a mount namespace:
    this process's own (setns into it needs CAP_SYS_ADMIN)."""
    port = _Port(tmp_path)
    service = port.cluster.service(port.dev, ns_pid=os.getpid())
    port.add_pod("trainer")
    try:
        resp = service.add_gpu(api.AddGPURequest("trainer", "default", 2))
    except ServiceError as exc:
        if "cannot enter the mount namespace" in exc.message:
            pytest.skip(f"no namespace entry here: {exc.message}")
        raise
    assert resp.add_gpu_result == api.AddGPUResult.Success
    assert port.visible() == 2
    assert sorted(os.listdir(port.dev)) == sorted(
        [os.path.basename(port.node_path(u)) for u in resp.uuids]
        + ["nvidia-uvm", "nvidia-uvm-tools", "nvidiactl"])
    removed = service.remove_gpu(api.RemoveGPURequest("trainer", "default", resp.uuids))
    assert removed.remove_gpu_result == api.RemoveGPUResult.Success
    assert port.visible() == 0 and port.free() == N


@pytest.mark.parametrize("n", [1, 3])
def test_mount_check_on_the_cpu(n):
    report = mount_check("cpu", fake_gpus=n, repeats=2)
    assert "live" not in report
    for k, flow in report["fake"].items():
        assert flow["case"] == "round-trip" and len(flow["uuids"]) == k
        assert len(flow["add_ms"]) == len(flow["remove_ms"]) == 2


def test_mount_check_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mount_check()


class _OneGpuNvml:
    """NVML's answers for one GPU of minor 3, behind CtypesNvml's interface."""

    def init(self):
        pass

    def shutdown(self):
        pass

    def count(self):
        return 1

    def minor(self, i):
        return 3

    def uuid(self, i):
        return "GPU-00000003-1111-2222-3333-444444444444"

    def pci_bus_id(self, i):
        return ""


@pytest.mark.parametrize("through_ns", [False, True], ids=["own-dir", "namespace-entry"])
def test_a_real_device_without_cap_mknod_is_refused_and_rolled_back(tmp_path, monkeypatch,
                                                                    through_ns):
    """A real GPU node (not a fake) that cannot be mknod'ed: add_gpu fails
    with the refusal naming CAP_MKNOD, no node is left in the target, and
    the slave pod is gone with the GPU free again. No copy stands in."""
    from gpumounter_tpu_torch.device.backend import NvidiaDeviceBackend, NvmlIdentity
    host = tmp_path / "host-dev"
    host.mkdir()
    try:
        os.mknod(host / "nvidia3", 0o666 | 0o020000, os.makedev(195, 3))
        os.mknod(host / "nvidiactl", 0o666 | 0o020000, os.makedev(195, 255))
    except PermissionError as exc:
        pytest.skip(f"the fake host /dev needs mknod: {exc}")
    cluster = FakeCluster(NvidiaDeviceBackend(str(host), identity=NvmlIdentity(lib=_OneGpuNvml())))
    target = tmp_path / "container-dev"
    target.mkdir()
    service = cluster.service(str(target), ns_pid=os.getpid() if through_ns else None)
    cluster.add_target_pod("trainer")

    def refuse(*args, **kwargs):
        raise PermissionError(1, "Operation not permitted")

    monkeypatch.setattr(os, "mknod", refuse)
    with pytest.raises(ServiceError) as exc:
        service.add_gpu(api.AddGPURequest("trainer", "default", 1))
    assert exc.value.code == "INTERNAL"
    assert "CAP_MKNOD" in exc.value.message and "nvidia3" in exc.value.message
    assert os.listdir(target) == []
    assert cluster.free_gpu_count() == 1
    assert cluster.kube.list_pods(cluster.cfg.pool_namespace) == []


@pytest.mark.parametrize("through_ns", [False, True], ids=["own-dir", "namespace-entry"])
def test_a_node_not_visible_after_mknod_fails_and_rolls_back(tmp_path, monkeypatch,
                                                             through_ns):
    """A mknod that "succeeds" but leaves no node where the tenant looks (a
    namespace being torn down) fails the batch; the slave pods go."""
    from gpumounter_tpu_torch.nsutil import ns
    port = _Port(tmp_path)
    service = port.cluster.service(port.dev, ns_pid=os.getpid() if through_ns else None)
    port.add_pod("trainer")
    monkeypatch.setattr(ns, "_mknod_here", lambda path, major, minor: None)
    monkeypatch.setattr(ns, "_mknod_at", lambda path, major, minor, source_path="": None)
    with pytest.raises(ServiceError) as exc:
        service.add_gpu(api.AddGPURequest("trainer", "default", 2))
    assert "not visible" in exc.value.message
    assert port.visible() == 0 and port.free() == N
    assert port.cluster.kube.list_pods(port.cluster.cfg.pool_namespace) == []


def test_a_namespace_that_cannot_be_entered_is_named(monkeypatch):
    """A failed setns is not reported as a mknod refusal."""
    from gpumounter_tpu_torch.nsutil import ns

    def refuse(fd, nstype):
        raise PermissionError(1, "Operation not permitted")

    monkeypatch.setattr(os, "setns", refuse)
    with pytest.raises(ns.NamespaceError, match="cannot enter the mount namespace"):
        ns.run_in_mount_ns(os.getpid(), lambda: "unreached")
