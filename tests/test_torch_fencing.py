"""The worker's half of epoch fencing: field 8 on the wire, the refusal of a
stale epoch, its persistence in the ledger, and the master's 503.

The worker-side cases of ``tests/test_fencing.py`` run on both packages: the
epoch's bytes (field 8, int64) equal to the reference's and decoding to 0
when absent; over real gRPC, each package's client against its own worker
(4 accelerators, a ledger each), a stale epoch refused as ``FencedError``,
never retried and mutating nothing, while the current and newer epochs and
epoch 0 pass; the highest epoch read back from the ledger after a restart.
The reference's client against the port's worker gets its own
``FencedError``. Then the master's mapping: a fenced worker call answers
503 with Retry-After 1, as ``gpumounter_tpu/master/app.py:1782-1785``.
"""

from __future__ import annotations

import grpc
import pytest
from torch_durability import SIDES, Refused
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.rpc.client import WorkerClient as RefWorkerClient
from gpumounter_tpu.rpc.resilience import FencedError as RefFencedError
from gpumounter_tpu.worker import server as ref_server
from gpumounter_tpu_torch.master.app import MasterApp
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.rpc.resilience import RPC_RETRIES, FencedError
from gpumounter_tpu_torch.testing.cluster import FakeCluster, LoopbackWorkerClient
from gpumounter_tpu_torch.worker import server

# --- the wire ---

EPOCHS = [0, 1, 7, 2**40 + 3, -1]


@pytest.mark.parametrize("epoch", EPOCHS)
def test_the_epoch_rides_the_wire_as_the_references_bytes(epoch):
    ours = api.AddGPURequest("p", "ns", 1, epoch=epoch)
    ref = ref_api.AddTPURequest(pod_name="p", namespace="ns", tpu_num=1, epoch=epoch)
    assert ours.encode() == ref.encode()
    assert api.AddGPURequest.decode(ref.encode()).epoch == epoch
    ours_rm = api.RemoveGPURequest("p", "ns", ["u"], epoch=epoch)
    ref_rm = ref_api.RemoveTPURequest(pod_name="p", namespace="ns", uuids=["u"], epoch=epoch)
    assert ours_rm.encode() == ref_rm.encode()
    assert ref_api.RemoveTPURequest.decode(ours_rm.encode()).epoch == epoch


def test_an_absent_epoch_decodes_to_zero():
    for cls in (api.AddGPURequest, api.RemoveGPURequest):
        assert cls.decode(cls("p", "ns").encode()).epoch == 0
    assert api.AddGPURequest.decode(
        ref_api.AddTPURequest(pod_name="p", namespace="ns", tpu_num=1).encode()).epoch == 0


def test_the_fenced_series_is_the_references():
    for series in ("FENCED_WRITES", "SLAVE_RELEASE_DEFERRED", "SLAVE_RELEASE_FAILURES"):
        ours, ref = getattr(server, series), getattr(ref_server, series)
        assert (ours.name, ours.help) == (ref.name, ref.help)


# --- the worker, over gRPC ---

class _Served:
    """A side's worker on a gRPC server of its package, and a client of its
    package; calls answer the result integer or the error's type name."""

    def __init__(self, side):
        self.side = side
        mod = ref_server if side.kind == "reference" else server
        self.server = mod.build_server(side.service, address="localhost:0")
        self.server.start()
        self.addr = f"localhost:{self.server.bound_port}"
        self.fenced = mod.FENCED_WRITES

    def call(self, method, *args, **kwargs):
        client_cls = RefWorkerClient if self.side.kind == "reference" else WorkerClient
        with client_cls(self.addr) as client:
            try:
                if self.side.kind == "reference":
                    fn = {"add": client.add_tpu, "remove": client.remove_tpu}[method]
                    return int(fn(*args, **kwargs))
                if method == "add":
                    return int(client.add_gpu(*args, **kwargs).add_gpu_result)
                return int(client.remove_gpu(*args, **kwargs).remove_gpu_result)
            except (FencedError, RefFencedError) as exc:
                return f"FencedError({exc.code})"

    def close(self):
        self.server.stop(grace=None)


@pytest.fixture()
def served(tmp_path):
    made = {}
    for name, cls in SIDES.items():
        made[name] = _Served(cls(str(tmp_path / name)))
    yield made
    for s in made.values():
        s.close()
        s.side.close()


def test_a_stale_epoch_is_fenced_as_the_references(served):
    got = {}
    for name, s in served.items():
        s.side.add_pod("trainer")
        fenced0 = s.fenced.total()
        retries0 = RPC_RETRIES.total()
        steps = [s.call("add", "trainer", "default", 1, epoch=3), s.side.free()]
        # a partitioned old owner at epoch 2: refused, typed, nothing mutated
        steps += [s.call("add", "trainer", "default", 1, epoch=2), s.side.free()]
        steps += [s.call("remove", "trainer", "default", [], force=True, remove_all=True,
                         epoch=2), s.side.free()]
        # the current owner (the same epoch) and a newer one go through
        steps += [s.call("add", "trainer", "default", 1, epoch=3),
                  s.call("add", "trainer", "default", 1, epoch=4), s.side.free()]
        steps += [s.fenced.total() - fenced0, s.side.service.ledger.epoch()]
        if name == "port":
            steps.append(RPC_RETRIES.total() - retries0)  # never retried
        got[name] = steps
    assert got["port"][:-1] == got["reference"]
    assert got["port"] == [0, 3, "FencedError(FENCED)", 3, "FencedError(FENCED)", 3, 0, 0, 1,
                           2, 4, 0]


def test_epoch_zero_is_never_fenced(served):
    """The original's single master sends no epoch (0): it goes through
    after an epoch was recorded."""
    got = {}
    for name, s in served.items():
        s.side.add_pod("trainer")
        got[name] = [s.call("add", "trainer", "default", 1, epoch=5),
                     s.call("add", "trainer", "default", 1), s.side.free()]
    assert got["port"] == got["reference"] == [0, 0, 2]


def test_the_references_client_is_fenced_by_the_ports_worker(served):
    port = served["port"]
    port.side.add_pod("trainer")
    assert port.call("add", "trainer", "default", 1, epoch=6) == 0
    with RefWorkerClient(port.addr, legacy=True) as client:
        with pytest.raises(RefFencedError):
            client.add_tpu("trainer", "default", 1, epoch=5)
        assert client.add_tpu("trainer", "default", 1, epoch=6) == ref_api.AddTPUResult.Success


def test_the_epoch_survives_a_restart_as_the_references(tmp_path):
    got = {}
    for name, cls in SIDES.items():
        side = cls(str(tmp_path / name))
        try:
            side.add_pod("trainer")
            assert side.add("trainer", 1, epoch=6) == 0
            side.restart()
            with pytest.raises(Refused) as refused:
                side.add("trainer", 1, epoch=5)
            got[name] = (side.service.ledger.epoch(), refused.value.code,
                         refused.value.message.split(";")[0], side.free())
        finally:
            side.close()
    assert got["port"] == got["reference"] == (6, "FAILED_PRECONDITION",
                                               "FENCED: stale epoch 5 < 6", 3)


def test_a_draining_worker_refuses_a_fenced_epoch_as_draining(tmp_path):
    """After the drain closed the ledger, a newer epoch is answered
    draining, not with the persist's failure."""
    got = {}
    for name, cls in SIDES.items():
        side = cls(str(tmp_path / name))
        try:
            side.add_pod("trainer")
            assert side.service.drain(timeout_s=1.0)
            with pytest.raises(Refused) as refused:
                side.add("trainer", 1, epoch=9)
            got[name] = (refused.value.code, refused.value.message)
        finally:
            side.close()
    assert got["port"] == got["reference"] == ("UNAVAILABLE",
                                                "worker draining (SIGTERM); retry elsewhere")


# --- the master ---

class _StaleClient(LoopbackWorkerClient):
    """A loopback client that stamps epoch 3 on every call: a master
    replica whose view of the node's owner is old."""

    epoch = 3

    def add_gpu(self, *args, **kwargs):
        return super().add_gpu(*args, epoch=self.epoch, **kwargs)

    def remove_gpu(self, *args, **kwargs):
        return super().remove_gpu(*args, epoch=self.epoch, **kwargs)


def test_the_master_answers_a_fenced_call_503_with_retry_after_1(tmp_path):
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "node"), 2)
    (tmp_path / "dev").mkdir()
    service = cluster.service(str(tmp_path / "dev"))
    pod = cluster.add_target_pod("trainer")
    cluster.register_worker()
    service.add_gpu(api.AddGPURequest("trainer", "default", 1, epoch=5))
    app = MasterApp(cluster.kube, cfg=cluster.cfg,
                    worker_client_factory=_StaleClient.factory(service))
    try:
        for method, path, body in [
                ("GET", "/addgpu/namespace/default/pod/trainer/gpu/1/isEntireMount/false", b""),
                ("POST", "/removegpu/namespace/default/pod/trainer/force/false",
                 f"uuids={service.collector.get_pod_devices(pod.name, 'default')[0].uuid}"
                 .encode())]:
            status, _, text, headers = app.handle(
                method, path, body, {"Authorization": f"Bearer {cluster.cfg.auth_token}"})
            assert (status, headers.get("Retry-After")) == (503, "1"), text
            assert text.startswith("stale shard ownership (fenced by worker)")
    finally:
        app.registry.stop()
    assert cluster.free_gpu_count() == 1  # nothing changed


def test_a_fenced_call_is_not_a_transport_failure():
    """FencedError is an RpcCallError the client never retries: a
    FAILED_PRECONDITION whose detail starts FENCED; any other detail stays
    an RpcCallError."""

    class _Rpc(grpc.RpcError):
        def __init__(self, detail):
            self._detail = detail

        def code(self):
            return grpc.StatusCode.FAILED_PRECONDITION

        def details(self):
            return self._detail

    client = WorkerClient.__new__(WorkerClient)
    client.address = "w:1200"
    fenced = client._typed(_Rpc("FENCED: stale epoch 2 < 3"), "FAILED_PRECONDITION", "AddGPU")
    other = client._typed(_Rpc("pod already holds an entire-mount"), "FAILED_PRECONDITION",
                          "AddGPU")
    assert type(fenced) is FencedError and fenced.code == "FENCED"
    assert type(other).__name__ == "RpcCallError" and other.code == "FAILED_PRECONDITION"
