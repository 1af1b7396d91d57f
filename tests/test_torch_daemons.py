"""The two daemons as processes, and the lazy grpc import.

``python -m gpumounter_tpu_torch.worker.main`` and ``...master.main`` run
against a stand-in API server (``tests/torch_kube_fake.py``, HTTPS, over a
``FakeCluster``'s fake Kubernetes, whose scheduler plays the device plugin)
and the cluster's kubelet served over gRPC (``FakeKubeletServer``). The
tenant is a real process in a mount namespace of its own with a tmpfs /dev,
behind a cgroup-v1 directory that names it. One add and one remove go over
HTTP to the master, which routes them over gRPC to the worker, which enters
the tenant's namespace; then both daemons stop on SIGTERM with exit code 0.
The worker keeps a ledger (TPUMOUNTER_LEDGER_DIR): after SIGTERM it is
closed clean with no open transaction, and a worker started again over it
replays nothing.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest
from torch_kube_fake import FakeApiServer, selfsigned

from gpumounter_tpu_torch.cgroup import container_cgroup_dir
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.worker.ledger import MountLedger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "daemon-test-secret"


def test_the_mount_path_imports_without_grpc():
    """grpc's fork handlers must not be in a process that only mounts: the
    mounter, the namespace entry, the master's app and what the card's
    script imports load without grpc."""
    modules = ["gpumounter_tpu_torch.worker.mounter", "gpumounter_tpu_torch.nsutil.ns",
               "gpumounter_tpu_torch.master.app", "gpumounter_tpu_torch.worker.server",
               "gpumounter_tpu_torch.rpc.client", "gpumounter_tpu_torch.rpc.health",
               "gpumounter_tpu_torch.collector.collector", "gpumounter_tpu_torch.k8s.client",
               "gpumounter_tpu_torch.testing.cluster", "gpumounter_tpu_torch.worker.main",
               "gpumounter_tpu_torch.master.main", "gpumounter_tpu_torch.entry"]
    prog = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "assert 'grpc' not in sys.modules, sorted(m for m in sys.modules if 'grpc' in m)\n"
            "from gpumounter_tpu_torch.utils.lazy_grpc import grpc\n"
            "grpc.StatusCode\n"
            "assert 'grpc' in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert (out.returncode, out.stdout.strip()) == (0, "ok"), out.stderr[-3000:]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Daemon:
    """A daemon process whose log is drained into `lines`; `ready` is set
    at the line that contains `marker`."""

    def __init__(self, module: str, env: dict, marker: str):
        self.lines: list[str] = []
        self.ready = threading.Event()
        self.proc = subprocess.Popen([sys.executable, "-m", module], cwd=REPO, env=env,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                     text=True)
        self._thread = threading.Thread(target=self._drain, args=(marker,), daemon=True)
        self._thread.start()

    def _drain(self, marker):
        for line in self.proc.stderr:
            self.lines.append(line)
            if marker in line:
                self.ready.set()
        self.ready.set()  # the process ended: let the waiter see it

    def log(self) -> str:
        return "".join(self.lines[-40:])

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._thread.join(timeout=5)


def _http(base, method, path, form=None):
    data = urllib.parse.urlencode(form).encode() if form is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Authorization": f"Bearer {TOKEN}"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


@pytest.fixture()
def tenant():
    """A process in its own mount namespace with an empty tmpfs on /dev."""
    proc = subprocess.Popen(["unshare", "--mount", "--propagation", "private", "sh", "-c",
                             "mount -t tmpfs tmpfs /dev && echo ready && exec sleep 600"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    if line != "ready":
        proc.kill()
        proc.wait()
        pytest.skip(f"no mount namespace of its own here: {proc.stderr.read().strip()}")
    yield proc.pid
    proc.kill()
    proc.wait()


def test_the_daemons_mount_and_remove_over_http(tmp_path, tenant):
    tls = selfsigned(str(tmp_path))
    if tls is None:
        pytest.skip("openssl is needed for the stand-in API server's certificate")
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "node"), 2)
    api = FakeApiServer(cluster.kube, *tls).start()
    kubelet = cluster.serve_kubelet()
    cgroup_root = tmp_path / "cgroup"
    (cgroup_root / "devices" / "kubepods").mkdir(parents=True)
    api_token = tmp_path / "sa-token"
    api_token.write_text(api.token)
    worker_port, ops_port, master_port = _free_port(), _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "TPUMOUNTER_AUTH": "token",
           "TPUMOUNTER_AUTH_TOKEN": TOKEN, "KUBERNETES_SERVICE_HOST": "127.0.0.1",
           "KUBERNETES_SERVICE_PORT": str(api.port), "TPUMOUNTER_TOKEN_FILE": str(api_token),
           "TPUMOUNTER_CA_FILE": tls[0], "WORKER_PORT": str(worker_port)}
    daemons = []
    try:
        pod = cluster.add_target_pod("tenant")
        cg = container_cgroup_dir(pod, "tenant-cid", "containerd", cgroup_root=str(cgroup_root),
                                  driver="cgroupfs", version=1)
        os.makedirs(cg)
        for name, text in [("cgroup.procs", f"{tenant}\n"), ("devices.allow", ""),
                           ("devices.deny", "")]:
            with open(os.path.join(cg, name), "w") as f:
                f.write(text)
        cluster.register_worker()
        worker_env = {**env, "FAKE_DEVICE_DIR": cluster.backend.root,
                      "KUBELET_POD_RESOURCES_SOCKET": kubelet.socket_path,
                      "METRICS_PORT": str(ops_port), "CGROUP_ROOT": str(cgroup_root),
                      "CGROUP_DRIVER": "cgroupfs", "CGROUP_VERSION": "1",
                      "TPUMOUNTER_LEDGER_DIR": str(tmp_path / "ledger")}
        daemons.append(_Daemon("gpumounter_tpu_torch.worker.main", worker_env, "serving gRPC"))
        daemons.append(_Daemon("gpumounter_tpu_torch.master.main",
                               {**env, "MASTER_PORT": str(master_port)}, "serving on"))
        for d in daemons:
            assert d.ready.wait(120) and d.proc.poll() is None, d.log()
        base = f"http://127.0.0.1:{master_port}"
        with urllib.request.urlopen(f"http://127.0.0.1:{ops_port}/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"

        assert _http(base, "GET", "/addgpu/namespace/default/pod/tenant/gpu/1/"
                                  "isEntireMount/false") == (200, "Add GPU Success\n"), \
            daemons[0].log()
        (uuid,) = [u for u, owner in cluster.assignment.items() if owner is not None]
        node = cluster.backend.device_by_uuid(uuid).basename
        tenant_dev = f"/proc/{tenant}/root/dev"
        assert node in os.listdir(tenant_dev)
        with open(os.path.join(cg, "devices.allow")) as f:
            assert f.read().strip()  # the grant was written
        assert _http(base, "POST", "/removegpu/namespace/default/pod/tenant/force/false",
                     {"uuids": uuid}) == (200, "Remove 1 GPUs Success\n"), daemons[0].log()
        assert node not in os.listdir(tenant_dev)
        assert cluster.free_gpu_count() == 2
        assert cluster.kube.list_pods(cluster.cfg.pool_namespace) == []
        assert [d.stop() for d in daemons] == [0, 0], [d.log() for d in daemons]
        assert "drain clean" in daemons[0].log(), daemons[0].log()
        ledger = MountLedger(str(tmp_path / "ledger"))
        assert ledger.was_clean_shutdown() and ledger.open_transactions() == []
        assert ledger.net_holdings() == {}
        ledger.abandon()
        again = _Daemon("gpumounter_tpu_torch.worker.main", worker_env, "serving gRPC")
        daemons.append(again)
        assert again.ready.wait(120) and again.proc.poll() is None, again.log()
        assert "ledger replay: 0 open transaction(s), 0 holding(s) corrected" in again.log()
        assert again.stop() == 0, again.log()
    finally:
        for d in daemons:
            d.stop()
        api.stop()
        cluster.stop()
