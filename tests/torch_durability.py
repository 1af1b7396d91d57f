"""Both packages' worker, with its ledger, on one scenario.

``RefSide`` is the reference's ``TpuMountService`` over its ``FakeCluster``,
driven in process as ``tests/test_ledger.py`` drives it; ``PortSide`` is the
port's ``GpuMountService`` over its own. Each side mounts into a bare
directory that stands for the container's /dev, keeps its ledger in a
directory of its own, and answers in one vocabulary: GPUs by their index on
the fake host (the two packages' UUIDs and node names differ), journals
with ids, times, device numbers and slave names masked.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

from gpumounter_tpu.cgroup.policy import POLICY_ENGINE as REF_POLICY_ENGINE
from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.k8s.types import Pod as RefPod
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.mounter import MountTarget as RefTarget
from gpumounter_tpu.worker.mounter import TpuMounter
from gpumounter_tpu.worker.resync import LedgerResync as RefResync
from gpumounter_tpu.worker.server import TpuMountService
from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.worker.resync import LedgerResync
from gpumounter_tpu_torch.worker.server import ServiceError

N = 4  # GPUs on the fake host


def short_root() -> str:
    """A new directory right under the temporary directory, for a
    reference cluster: its kubelet's unix socket must stay under the
    107 bytes of a socket path, which a pytest worker's tmp_path and a
    long test name can pass."""
    return tempfile.mkdtemp(prefix="tpm-")


class Refused(Exception):
    """A call the service refused, as either package words it: the status
    name and the message."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class _Ctx:
    """The reference's servicer context: abort raises."""

    def abort(self, code, details):
        raise Refused(code.name, details)


class _Side:
    """What both sides share: the reading of their state."""

    kind = ""

    def indices(self, uuids) -> set[int]:
        by_uuid = {d.uuid: d.index for d in self.backend.list_devices()}
        return {by_uuid[u] for u in uuids}

    def uuids(self, indices) -> list[str]:
        by_index = {d.index: d.uuid for d in self.backend.list_devices()}
        return [by_index[i] for i in indices]

    def mounted(self) -> set[int]:
        """The GPUs whose node is in the container's directory."""
        return {d.index for d in self.backend.list_devices()
                if os.path.lexists(os.path.join(self.dev, os.path.basename(d.device_path)))}

    def holdings(self) -> dict[tuple[str, str], set[int]]:
        return {k: self.indices(v) for k, v in self.service.ledger.net_holdings().items()}

    def open_txns(self) -> int:
        return len(self.service.ledger.open_transactions())

    def journal(self) -> list[dict]:
        with open(self.service.ledger.path, encoding="utf-8") as f:
            return mask_journal([json.loads(line) for line in f if line.strip()], self)

    def replay(self) -> dict:
        return summary_shape(self.resync(self.service).replay_once())

    def restart(self) -> None:
        """The worker's death (the ledger's fd abandoned) and a new service
        over the same ledger directory."""
        self.service.ledger.abandon()
        self.service = self._build()


class RefSide(_Side):
    kind = "reference"
    resync = RefResync
    policy_engine = REF_POLICY_ENGINE

    def __init__(self, root: str, ledger: bool = True):
        self.cluster_root = short_root()
        self.cluster = RefCluster(self.cluster_root, n_chips=N).start()
        self.dev = os.path.join(root, "container-dev")
        os.makedirs(self.dev)
        self.ledger_dir = os.path.join(root, "ledger") if ledger else ""
        self.backend = self.cluster.backend
        self.service = self._build()

    def _build(self) -> TpuMountService:
        cfg = self.cluster.cfg.replace(ledger_dir=self.ledger_dir)
        collector = TpuCollector(backend=self.cluster.backend,
                                 podresources=PodResourcesClient(cfg.kubelet_socket,
                                                                 timeout_s=5.0), cfg=cfg)
        mounter = TpuMounter(self.cluster.backend, cfg=cfg)
        mounter.resolve_target = lambda pod: RefTarget(
            dev_dir=self.dev, description=f"{pod.namespace}/{pod.name}", pod=pod)
        return TpuMountService(self.cluster.kube, collector=collector, mounter=mounter, cfg=cfg)

    def close(self) -> None:
        if self.service.ledger is not None:
            self.service.ledger.abandon()
        self.cluster.stop()
        shutil.rmtree(self.cluster_root, ignore_errors=True)

    def add_pod(self, name: str) -> None:
        self.cluster.add_target_pod(name)

    def add(self, pod: str, n: int, epoch: int = 0) -> int:
        return int(self.service.add_tpu(ref_api.AddTPURequest(
            pod_name=pod, namespace="default", tpu_num=n, epoch=epoch), _Ctx()).add_tpu_result)

    def remove(self, pod: str, indices, force: bool = False, epoch: int = 0) -> int:
        return int(self.service.remove_tpu(ref_api.RemoveTPURequest(
            pod_name=pod, namespace="default", uuids=self.uuids(indices), force=force,
            epoch=epoch), _Ctx()).remove_tpu_result)

    def share_mount(self, pod: str, n: int, weight: int, budget: int) -> None:
        """n GPUs booked through slave pods, then mounted by the mounter with
        a fractional policy (the service's wire has no share fields in the
        port)."""
        owner = RefPod(self.cluster.kube.get_pod("default", pod))
        devices, _ = self.service.allocator.get_available_tpus(owner, n, 1)
        target = self.service.mounter.resolve_target(owner)
        self.service.mounter.mount_many(target, devices,
                                        policy={d.uuid: (weight, budget) for d in devices})

    def books(self, pod: str) -> set[int]:
        owner = RefPod(self.cluster.kube.get_pod("default", pod))
        self.service.collector.update_status()
        slaves = {s.name for s in self.service.allocator.slave_pods_for(owner)}
        return self.indices(d.uuid for d in self.service.collector.get_pod_devices(
            pod, "default", slave_pod_names=slaves, refresh=False))

    def free(self) -> int:
        return self.cluster.free_chip_count()

    def delete_pod(self, name: str) -> None:
        self.cluster.kube.delete_pod("default", name)


class PortSide(_Side):
    kind = "port"
    resync = LedgerResync
    policy_engine = POLICY_ENGINE

    def __init__(self, root: str, ledger: bool = True):
        self.ledger_dir = os.path.join(root, "ledger") if ledger else ""
        self.cluster = FakeCluster.with_fake_gpus(os.path.join(root, "cluster"), N,
                                                  cfg=Config(ledger_dir=self.ledger_dir))
        self.dev = os.path.join(root, "container-dev")
        os.makedirs(self.dev)
        self.backend = self.cluster.backend
        self.service = self._build()

    def _build(self):
        return self.cluster.service(self.dev)

    def close(self) -> None:
        if self.service.ledger is not None:
            self.service.ledger.abandon()
        self.cluster.stop()

    def add_pod(self, name: str) -> None:
        self.cluster.add_target_pod(name)

    @staticmethod
    def _refused(exc: ServiceError):
        return Refused(exc.code, exc.message)

    def add(self, pod: str, n: int, epoch: int = 0) -> int:
        try:
            return int(self.service.add_gpu(api.AddGPURequest(
                pod, "default", n, epoch=epoch)).add_gpu_result)
        except ServiceError as exc:
            raise self._refused(exc) from exc

    def remove(self, pod: str, indices, force: bool = False, epoch: int = 0) -> int:
        try:
            return int(self.service.remove_gpu(api.RemoveGPURequest(
                pod, "default", self.uuids(indices), force, epoch=epoch)).remove_gpu_result)
        except ServiceError as exc:
            raise self._refused(exc) from exc

    def share_mount(self, pod: str, n: int, weight: int, budget: int) -> None:
        owner = Pod(self.cluster.kube.get_pod("default", pod))
        devices, _ = self.service.allocator.get_available_gpus(owner, n, 1)
        target = self.service.mounter.resolve_target(owner)
        self.service.mounter.mount_many(target, devices,
                                        policy={d.uuid: (weight, budget) for d in devices})

    def books(self, pod: str) -> set[int]:
        owner = Pod(self.cluster.kube.get_pod("default", pod))
        self.service.collector.update_status()
        slaves = {s.name for s in self.service.allocator.slave_pods_for(owner)}
        return self.indices(d.uuid for d in self.service.collector.get_pod_devices(
            pod, "default", slave_pod_names=slaves, refresh=False))

    def free(self) -> int:
        return self.cluster.free_gpu_count()

    def delete_pod(self, name: str) -> None:
        self.cluster.kube.delete_pod("default", name)


SIDES = {"reference": RefSide, "port": PortSide}


def summary_shape(summary: dict) -> dict:
    """A replay's summary with each txn list as its length."""
    return {k: len(v) if isinstance(v, list) else v for k, v in summary.items()}


_ID = re.compile(r"^[mur]-[0-9a-f]{10}$")


def mask_journal(records: list[dict], side) -> list[dict]:
    """Ids as T0, T1, ... (R0, ... for releases) in order of appearance,
    times dropped, each GPU as its index, its device numbers dropped, slave
    names as S0, S1, ..., the target's directory and UID as placeholders."""
    ids: dict[str, str] = {}
    slaves: dict[str, str] = {}
    by_uuid = {d.uuid: d.index for d in side.backend.list_devices()}

    def _id(value: str, prefix: str) -> str:
        assert _ID.match(value), value
        return ids.setdefault(value, f"{prefix}{sum(1 for v in ids.values() if v[0] == prefix)}")

    def _chip(chip: dict) -> dict:
        out = {k: v for k, v in chip.items() if k not in ("major", "minor", "rel_path")}
        out["uuid"] = by_uuid[chip["uuid"]]
        out["rel_path"] = by_uuid[chip["uuid"]]
        if chip.get("slave"):
            out["slave"] = slaves.setdefault(chip["slave"], f"S{len(slaves)}")
        return out

    masked = []
    for record in records:
        rec = {k: v for k, v in record.items() if k != "at"}
        if "txn" in rec:
            rec["txn"] = _id(rec["txn"], "T")
        if "rel" in rec:
            rec["rel"] = _id(rec["rel"], "R")
        if "chips" in rec:
            rec["chips"] = [_chip(c) for c in rec["chips"]]
        if rec.get("pod_uid"):
            rec["pod_uid"] = "<uid>"
        if rec.get("dev_dir"):
            rec["dev_dir"] = "<dev>"
        if "pods" in rec:
            rec["pods"] = [slaves.setdefault(p, f"S{len(slaves)}") for p in rec["pods"]]
        if rec.get("namespace") in ("tpu-pool", "gpu-pool") and rec.get("kind") == "release":
            rec["namespace"] = "<pool>"
        if "holdings" in rec:
            rec["holdings"] = [{**h, "chips": [_chip(c) for c in h["chips"]]}
                               for h in rec["holdings"]]
        masked.append(rec)
    return masked
