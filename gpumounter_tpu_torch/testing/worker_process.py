"""A node's worker as a child process, so that its death can be a SIGKILL.

``python -m gpumounter_tpu_torch.testing.worker_process '<spec>'`` builds the
worker's service as ``FakeCluster.service(kubelet="grpc")`` builds it: the
backend of ``backend_from_config``, the kubelet over gRPC on
``cfg.kubelet_socket``, a ``DirTargetMounter`` into the spec's tenant
directory (through the mount namespace of ``ns_pid`` when one is given) and
the ledger of ``cfg.ledger_dir``. Its API is a ``RestKubeClient`` to a
stand-in API server (``testing/kube_api.FakeApiServer``) over the parent's
fake cluster. It serves gRPC on 127.0.0.1, prints ``serving <port>`` and
runs until it is killed. The spec is JSON: {"cfg": the ``Config`` fields,
"api": {"port", "token", "ca"}, "dev_dir", "ns_pid", "cgroup_dirs"}.

``WorkerProcess(spec, log_path)`` starts it and waits for its port. Its
``stop`` is a gRPC server's: without grace the process dies at once
(SIGKILL), so ``WorkerServers`` can hold it as a node's server.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time

from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import PodResourcesClient
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import backend_from_config
from gpumounter_tpu_torch.k8s.client import RestKubeClient
from gpumounter_tpu_torch.testing.cluster import DirTargetMounter
from gpumounter_tpu_torch.utils.log import init_logger
from gpumounter_tpu_torch.worker.server import GpuMountService, build_server

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class WorkerProcess:
    """The child process, started; ``port`` is where it serves gRPC on
    127.0.0.1, and its log (stderr) goes to `log_path`. Raises when it has
    not served within `timeout_s`, with the log's tail."""

    def __init__(self, spec: dict, log_path: str, timeout_s: float = 60.0):
        self.log_path = log_path
        self._log = open(log_path, "w")
        path = os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH", "")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gpumounter_tpu_torch.testing.worker_process",
             json.dumps(spec)], cwd=_REPO, env={**os.environ, "PYTHONPATH": path},
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=self._log, text=True)
        try:
            self.port = self._await_port(timeout_s)
        except BaseException:
            self.stop()
            raise

    def _await_port(self, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ready, _, _ = select.select([self.proc.stdout], [], [], 0.1)
            if ready:
                line = self.proc.stdout.readline()
                if line.startswith("serving "):
                    return int(line.split()[1])
                if not line:
                    break
        raise RuntimeError(f"the worker process did not serve within {timeout_s} s "
                           f"(exit {self.proc.poll()}): {self.log_tail()}")

    def log_tail(self, n: int = 3000) -> str:
        if not self._log.closed:
            self._log.flush()
        with open(self.log_path, errors="replace") as f:
            return f.read()[-n:]

    def stop(self, grace: float | None = None) -> threading.Event:
        """Without `grace` SIGKILL; with it SIGTERM, then SIGKILL after
        `grace` seconds. Returns a set Event once the process is gone, as
        a gRPC server's stop returns one to wait on."""
        if self.proc.poll() is None:
            if grace is None:
                self.proc.kill()
            else:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()
        self._log.close()
        done = threading.Event()
        done.set()
        return done


def main(argv: list[str] | None = None) -> None:
    spec = json.loads((sys.argv[1:] if argv is None else argv)[0])
    init_logger()
    cfg = Config(**spec["cfg"])
    api = spec["api"]
    kube = RestKubeClient("127.0.0.1", api["port"], api["token"], ca_file=api["ca"])
    backend = backend_from_config(cfg)
    collector = GpuCollector(backend, PodResourcesClient(cfg.kubelet_socket, timeout_s=5.0),
                             cfg=cfg)
    mounter = DirTargetMounter(backend, spec["dev_dir"], cfg=cfg, ns_pid=spec["ns_pid"],
                               cgroup_dirs=spec["cgroup_dirs"], kube=kube)
    server = build_server(GpuMountService(kube, collector, mounter=mounter, cfg=cfg),
                          address="127.0.0.1:0")
    server.start()
    print(f"serving {server.bound_port}", flush=True)
    threading.Event().wait()


if __name__ == "__main__":
    main()
