"""The port's gRPC transport against the reference's, over real sockets.

  * The worker's scenarios of ``tests/test_torch_worker.py`` in both
    directions: the port's ``WorkerClient`` against the reference's worker
    (its ``build_server``, reached under the original's gpu_mount names),
    and the reference's ``WorkerClient(legacy=True)`` against the port's
    ``build_server``. Each scenario asserts the reference's results, gRPC
    codes of refused calls, visible nodes and free counts on the way.
  * The port's ``PodResourcesClient`` against the reference's
    ``FakeKubeletServer`` (v1, v1alpha1, both), and the reverse.
  * A retried add under one idempotency key mounts once; the breaker opens
    after its threshold and recovers through one half-open probe, step by
    step as the reference's; a missing or wrong token is UNAUTHENTICATED.
  * The namespace-entry flows with the gRPC server serving in the same
    process, and a client on a host without grpcio, each in a subprocess.

Every comparison is exact.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import grpc
import pytest
import test_torch_worker as tw

from gpumounter_tpu.collector import podresources as ref_pr
from gpumounter_tpu.rpc import health as ref_health
from gpumounter_tpu.rpc import resilience as ref_res
from gpumounter_tpu.rpc.client import WorkerClient as RefWorkerClient
from gpumounter_tpu_torch.collector import podresources as pr
from gpumounter_tpu_torch.rpc import api, health, resilience
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.rpc.resilience import (BreakerOpenError, CircuitBreaker,
                                                 RpcCallError, WorkerUnavailableError)
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.worker.server import ServiceError, build_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _PortClientRefWorker(tw._Ref):
    """The reference's worker over gRPC, called by the port's client."""

    def add(self, pod, n, entire=False):
        with WorkerClient(self.addr) as client:
            try:
                return int(client.add_gpu(pod, "default", n, entire).add_gpu_result)
            except RpcCallError as exc:
                return exc.code

    def remove(self, pod, uuids, force=False):
        with WorkerClient(self.addr) as client:
            return int(client.remove_gpu(pod, "default", uuids, force=force).remove_gpu_result)


class _RefClientPortWorker(tw._Port):
    """The port's worker behind its gRPC server, called by the reference's
    client under the original's service names."""

    def __init__(self, tmp_path):
        super().__init__(tmp_path)
        self.server = build_server(self.service, address="localhost:0")
        self.addr = f"localhost:{self.server.bound_port}"
        self.server.start()

    def close(self):
        self.server.stop(None).wait()

    def add(self, pod, n, entire=False):
        with RefWorkerClient(self.addr, legacy=True) as client:
            try:
                return int(client.add_tpu(pod, "default", n, is_entire_mount=entire))
            except grpc.RpcError as exc:
                return exc.code().name

    def remove(self, pod, uuids, force=False):
        with RefWorkerClient(self.addr, legacy=True) as client:
            return int(client.remove_tpu(pod, "default", uuids, force=force))


@pytest.mark.parametrize("direction", [_PortClientRefWorker, _RefClientPortWorker],
                         ids=["port-client-ref-worker", "ref-client-port-worker"])
@pytest.mark.parametrize("scenario", tw.SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_across_the_wire(tmp_path, scenario, direction):
    stack = direction(tmp_path)
    try:
        scenario(stack)  # asserts the reference's record on the way
    finally:
        stack.close()


# --- pod-resources over gRPC ---

def _claims(kubelet):
    kubelet.set_claim("trainer", "default", "nvidia.com/gpu", ["GPU-a", "1"])
    kubelet.set_claim("trainer", "default", "example.com/nic", ["n0"], container="side")
    kubelet.set_claim("slave", "gpu-pool", "nvidia.com/gpu", ["GPU-b"])


@pytest.mark.parametrize("versions, pinned", [
    (("v1",), pr.SERVICE_V1), (("v1alpha1",), pr.SERVICE_V1ALPHA1),
    (("v1", "v1alpha1"), pr.SERVICE_V1)])
def test_pod_resources_across_the_wire(versions, pinned):
    with tempfile.TemporaryDirectory(dir="/tmp") as d:
        ref_server = ref_pr.FakeKubeletServer(os.path.join(d, "ref.sock"), versions=versions)
        _claims(ref_server)
        port_server = pr.FakeKubeletServer(os.path.join(d, "port.sock"), versions=versions)
        _claims(port_server.kubelet)
        ref_server.start()
        port_server.start()
        try:
            with pr.PodResourcesClient(ref_server.socket_path, timeout_s=5) as ours, \
                    ref_pr.PodResourcesClient(port_server.socket_path, timeout_s=5) as theirs:
                got = ours.list()
                want = ref_pr.PodResourcesClient(ref_server.socket_path, timeout_s=5).list()
                assert [p.encode() for p in got] == [p.encode() for p in want]
                assert ours.pinned == pinned
                assert [p.encode() for p in theirs.list()] == [p.encode() for p in got]
                assert list(pr.iter_device_claims(got, "nvidia.com/gpu")) == [
                    ("trainer", "default", "GPU-a"), ("trainer", "default", "1"),
                    ("slave", "gpu-pool", "GPU-b")]
        finally:
            ref_server.stop()
            port_server.stop()


def test_a_collector_over_the_kubelet_socket(tmp_path):
    """The port's collector on the gRPC kubelet reads what the in-memory
    one reads."""
    cluster = FakeCluster.with_fake_gpus(str(tmp_path), 4)
    try:
        cluster.add_target_pod("trainer")
        over_grpc = cluster.service(str(tmp_path), kubelet="grpc")
        in_memory = cluster.service(str(tmp_path))
        cluster.kubelet.set_claim("trainer", "default", "nvidia.com/gpu",
                                  [cluster.backend.list_devices()[2].uuid])
        assert [d.uuid for d in over_grpc.collector.get_pod_devices("trainer", "default")] == \
            [d.uuid for d in in_memory.collector.get_pod_devices("trainer", "default")] == \
            [cluster.backend.list_devices()[2].uuid]
        assert isinstance(over_grpc.collector._podresources, pr.PodResourcesClient)
    finally:
        cluster.stop()


# --- idempotency, the breaker, auth, health ---

@pytest.fixture()
def port_worker(tmp_path):
    stack = _RefClientPortWorker(tmp_path)
    stack.add_pod("trainer")
    yield stack
    stack.close()


def test_a_retried_add_under_one_key_mounts_once(port_worker):
    """The first attempt mounts, then its reply is lost (UNAVAILABLE): the
    client's retry carries the same key and is answered from the worker's
    record; one more call with that key mounts nothing either."""
    service, calls = port_worker.service, []

    class LosesTheFirstReply:
        cfg = service.cfg
        remove_gpu = service.remove_gpu
        collect_telemetry = service.collect_telemetry  # the server's third method
        probe_gpu = service.probe_gpu  # and its fourth
        quiesce_status = service.quiesce_status  # and its fifth

        def add_gpu(self, request):
            calls.append(request.idempotency_key)
            response = service.add_gpu(request)
            if len(calls) == 1:
                raise ServiceError("UNAVAILABLE", "reply lost")
            return response

    server = build_server(LosesTheFirstReply(), address="localhost:0")
    server.start()
    try:
        with WorkerClient(f"localhost:{server.bound_port}",
                          cfg=Config(rpc_max_attempts=3, rpc_retry_base_s=0.0)) as client:
            first = client.add_gpu("trainer", "default", 2, idempotency_key="key-1")
            again = client.add_gpu("trainer", "default", 2, idempotency_key="key-1")
            fresh = client.add_gpu("trainer", "default", 1)
    finally:
        server.stop(None).wait()
    assert calls[:3] == ["key-1"] * 3 and len(calls) == 4 and calls[3] != "key-1"
    assert first.uuids == again.uuids and len(first.uuids) == 2
    assert len(fresh.uuids) == 1 and not set(fresh.uuids) & set(first.uuids)
    assert port_worker.free() == tw.N - 3 and port_worker.visible() == 3
    with WorkerClient(port_worker.addr) as client:
        removed = [client.remove_gpu("trainer", "default", first.uuids, idempotency_key="rm-1")
                   for _ in range(2)]
    assert [int(r.remove_gpu_result) for r in removed] == [0, 0]
    assert port_worker.free() == tw.N - 1


def test_the_reference_worker_honours_the_ports_key(tmp_path):
    ref = tw._Ref(tmp_path)
    try:
        ref.add_pod("trainer")
        with WorkerClient(ref.addr) as client:
            a = client.add_gpu("trainer", "default", 2, idempotency_key="same")
            b = client.add_gpu("trainer", "default", 2, idempotency_key="same")
        assert a.uuids == b.uuids and ref.free() == tw.N - 2
    finally:
        ref.close()


def _dead_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_the_breaker_opens_after_its_threshold():
    """Calls to a worker that is not there: UNAVAILABLE twice, then the
    breaker is open and the third call fails fast without a dial."""
    breaker = CircuitBreaker(failure_threshold=2, reset_s=60)
    address = _dead_address()
    seen = []
    with WorkerClient(address, cfg=Config(rpc_max_attempts=1), breaker=breaker) as client:
        for _ in range(3):
            try:
                client.add_gpu("trainer", "default", 1)
            except (WorkerUnavailableError, BreakerOpenError) as exc:
                seen.append((type(exc).__name__, exc.code, breaker.state(address)))
    assert seen == [("WorkerUnavailableError", "UNAVAILABLE", "closed"),
                    ("WorkerUnavailableError", "UNAVAILABLE", "open"),
                    ("BreakerOpenError", "BREAKER_OPEN", "open")]


def test_the_breaker_steps_as_the_references(monkeypatch):
    """One sequence of failures, successes and clock steps on both
    breakers: the same states, retry-afters, admissions and on_open calls."""
    now = [1000.0]
    for mod in (resilience, ref_res):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    records = []
    for cls in (CircuitBreaker, ref_res.CircuitBreaker):
        b, opened, out = cls(failure_threshold=3, reset_s=10), [], []
        b.on_open = opened.append
        now[0] = 1000.0
        for step in ["f", "f", "s", "f", "f", "f", "t4", "a", "t7", "a", "a", "f", "t10",
                     "a", "s", "a", "f"]:
            if step == "f":
                b.record_failure("w")
            elif step == "s":
                b.record_success("w")
            elif step == "a":
                out.append(("allow", b.allow("w")))
            else:
                now[0] += float(step[1:])
            out.append((b.state("w"), b.retry_after("w")))
        records.append((out, opened))
    assert records[0] == records[1]
    assert records[0][1] == ["w", "w"]


@pytest.mark.parametrize("token", [None, "wrong-secret"], ids=["missing", "wrong"])
def test_a_missing_or_wrong_token_is_unauthenticated(port_worker, tmp_path, token):
    with WorkerClient(port_worker.addr, token=token) as client:
        with pytest.raises(RpcCallError) as exc:
            client.add_gpu("trainer", "default", 1)
    assert exc.value.code == "UNAUTHENTICATED"
    with RefWorkerClient(port_worker.addr, legacy=True, token=token) as client:
        with pytest.raises(grpc.RpcError) as ref_exc:
            client.add_tpu("trainer", "default", 1)
    assert ref_exc.value.code() == grpc.StatusCode.UNAUTHENTICATED
    ref = tw._Ref(tmp_path)
    try:
        with WorkerClient(ref.addr, token=token) as client:
            with pytest.raises(RpcCallError) as exc:
                client.add_gpu("trainer", "default", 1)
        assert exc.value.code == "UNAUTHENTICATED"
    finally:
        ref.close()
    assert port_worker.free() == tw.N


def test_health_is_open_and_answers_both_ways(port_worker, tmp_path):
    assert ref_health.check_health(port_worker.addr) == health.SERVING
    assert ref_health.check_health(port_worker.addr, api.ADD_SERVICE) == health.SERVING
    ref = tw._Ref(tmp_path)
    try:
        assert health.check_health(ref.addr) == health.SERVING
    finally:
        ref.close()
    with pytest.raises(grpc.RpcError) as exc:
        health.check_health(port_worker.addr, "no.such.Service")
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND


def test_a_server_without_a_token_refuses_to_start(tmp_path):
    import dataclasses

    from gpumounter_tpu_torch.utils.auth import AuthConfigError
    cluster = FakeCluster.with_fake_gpus(str(tmp_path), 1)
    service = cluster.service(str(tmp_path))
    service.cfg = dataclasses.replace(service.cfg, auth_token="", auth_token_file="")
    with pytest.raises(AuthConfigError, match="TPUMOUNTER_AUTH=insecure"):
        build_server(service, address="localhost:0")
    service.cfg = dataclasses.replace(service.cfg, auth_mode="insecure")
    server = build_server(service, address="localhost:0")
    server.start()
    try:
        with WorkerClient(f"localhost:{server.bound_port}", token=None) as client:
            assert client.add_gpu("ghost", "default", 1).add_gpu_result == \
                api.AddGPUResult.PodNotFound
    finally:
        server.stop(None).wait()


def _run(prog: str, timeout: int = 120) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


FLOWS_UNDER_GRPC = r"""
import json, os, tempfile
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev
from gpumounter_tpu_torch.worker.server import build_server
root = tempfile.mkdtemp()
cluster = FakeCluster.with_fake_gpus(root, 4)
dev = os.path.join(root, "tenant-dev"); os.makedirs(dev)
service = cluster.service(dev, ns_pid=os.getpid(), kubelet="grpc")
server = build_server(service, address="127.0.0.1:0"); server.start()
cluster.add_target_pod("trainer")
seen = {"add": [], "remove": []}
with WorkerClient(f"127.0.0.1:{server.bound_port}") as client:
    for _ in range(5):
        try:
            added = client.add_gpu("trainer", "default", 2)
        except Exception as exc:
            seen["error"] = str(exc)
            break
        seen["add"].append([int(added.add_gpu_result), gpus_visible_in_dev(dev),
                            cluster.free_gpu_count()])
        removed = client.remove_gpu("trainer", "default", list(added.uuids))
        seen["remove"].append([int(removed.remove_gpu_result), gpus_visible_in_dev(dev),
                               cluster.free_gpu_count()])
server.stop(None).wait(); cluster.stop()
print(json.dumps(seen))
"""


def test_namespace_entry_with_the_grpc_server_serving_in_the_process():
    """Five add/remove rounds whose namespace entries start from a gRPC
    server's threads while grpc's own threads run in the process. A forked
    copy of such a process runs grpcio's fork handlers, which aborted it on
    the card's machine; the helper is spawned and exec'd instead. No
    GRPC_ENABLE_FORK_SUPPORT."""
    out = _run(FLOWS_UNDER_GRPC)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    if "cannot enter the mount namespace" in seen.get("error", ""):
        pytest.skip(f"no namespace entry here: {seen['error']}")
    assert seen == {"add": [[0, 2, 2]] * 5, "remove": [[0, 0, 4]] * 5}, out.stderr[-3000:]


AT_FORK = r"""
import os
from gpumounter_tpu_torch.nsutil import ns
r, w = os.pipe()
os.register_at_fork(after_in_child=lambda: os.write(w, b"a fork handler ran"))
ns.run_in_mount_ns(os.getpid(), [["missing", ["/"]]])
os.close(w)
print(os.read(r, 100).decode() or "no fork handler ran")
"""


def test_a_namespace_entry_runs_no_fork_handler_of_the_worker():
    """The entry starts a new interpreter (spawn and exec), never a forked
    copy of the worker: no at-fork handler registered in the worker runs.
    grpcio registers such handlers, and on the card's machine (grpcio 1.80,
    gVisor) they aborted a forked child while the worker served gRPC; this
    is the deterministic form of that fault."""
    out = _run(AT_FORK)
    assert (out.returncode, out.stdout.strip()) == (0, "no fork handler ran"), out.stderr


def test_without_grpcio_a_default_client_raises_and_names_grpcio():
    prog = ("import sys\n"
            "sys.modules['grpc'] = None\n"
            "from gpumounter_tpu_torch.rpc.client import WorkerClient\n"
            "try:\n"
            "    WorkerClient('127.0.0.1:1')\n"
            "except ModuleNotFoundError as exc:\n"
            "    print('raised', exc.name, exc)\n")
    out = _run(prog)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised grpc ") and "grpcio" in out.stdout
