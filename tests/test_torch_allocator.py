"""The allocator against the reference's: the slave pod's manifest, and the
insufficient case, the rollback, the mount type and the removal plan run
on both packages' fake clusters (4 accelerators each)."""

from __future__ import annotations

import pytest

from gpumounter_tpu.allocator.allocator import InsufficientTpuError, SlavePodError as RefSlaveErr
from gpumounter_tpu.allocator.allocator import TpuAllocator
from gpumounter_tpu.allocator.allocator import base_slave_manifest as ref_manifest
from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.k8s.types import Pod as RefPod
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu_torch.allocator.allocator import (GpuAllocator, InsufficientGpuError,
                                                      SlavePodError, base_slave_manifest)
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.testing.cluster import FakeCluster

N = 4


def test_slave_manifest_differs_only_in_resource_name_and_toleration_key():
    shared = dict(pool_namespace="pool", slave_pod_image="alpine:3")
    labels = {"app": "pool", "tpumounter.io/owner-uid": "u1"}
    got = base_slave_manifest(Config(**shared), "p-slave-pod-ab", "node-1", 2, labels,
                              annotations={"k": "v"})
    want = ref_manifest(RefConfig(**shared), "p-slave-pod-ab", "node-1", 2, labels,
                        annotations={"k": "v"})
    res = got["spec"]["containers"][0]["resources"]
    assert res == {"limits": {"nvidia.com/gpu": "2"}, "requests": {"nvidia.com/gpu": "2"}}
    assert got["spec"]["tolerations"][0]["key"] == "nvidia.com/gpu"
    assert want["spec"]["containers"][0]["resources"]["limits"] == {"google.com/tpu": "2"}
    for manifest in (got, want):
        manifest["spec"]["containers"][0]["resources"] = None
        manifest["spec"]["tolerations"][0]["key"] = None
    assert got == want


class _Side:
    def __init__(self, kind, tmp_path):
        self.kind = kind
        if kind == "reference":
            self.cluster = RefCluster(str(tmp_path / "ref"), n_chips=N).start()
            self.collector = TpuCollector(
                backend=self.cluster.backend,
                podresources=PodResourcesClient(self.cluster.cfg.kubelet_socket, timeout_s=5.0),
                cfg=self.cluster.cfg)
            self.allocator = TpuAllocator(self.cluster.kube, self.collector,
                                          cfg=self.cluster.cfg)
            self.get = self.allocator.get_available_tpus
            self.remove_plan = self.allocator.get_remove_tpus
            self.wrap, self.insufficient, self.slave_error = (RefPod, InsufficientTpuError,
                                                              RefSlaveErr)
        else:
            self.cluster = FakeCluster.with_fake_gpus(str(tmp_path / "port"), N)
            self.collector = GpuCollector(self.cluster.backend, self.cluster.kubelet,
                                          cfg=self.cluster.cfg)
            self.allocator = GpuAllocator(self.cluster.kube, self.collector,
                                          cfg=self.cluster.cfg)
            self.get = self.allocator.get_available_gpus
            self.remove_plan = self.allocator.get_remove_gpus
            self.wrap, self.insufficient, self.slave_error = (Pod, InsufficientGpuError,
                                                              SlavePodError)

    def close(self):
        if self.kind == "reference":
            self.cluster.stop()

    def pod(self, name="trainer"):
        self.cluster.add_target_pod(name)
        return self.wrap(self.cluster.kube.get_pod("default", name))

    def slaves(self):
        return len(self.cluster.kube.list_pods(self.cluster.cfg.pool_namespace))

    def free(self):
        return (self.cluster.free_chip_count() if self.kind == "reference"
                else self.cluster.free_gpu_count())

    def outcome(self, fn):
        try:
            devices, slaves = fn()
            return ("ok", len(devices), len(slaves))
        except self.insufficient:
            return ("insufficient",)
        except self.slave_error:
            return ("slave_error",)

    def lag_device_plugin(self):
        """The kubelet never learns the slaves' devices (device plugin lag)."""
        if self.kind == "reference":
            self.cluster.node().kubelet.set_claim = lambda *a, **k: None
        else:
            self.cluster.kubelet.set_claim = lambda *a, **k: None


def _both(tmp_path, scenario):
    ref, port = _Side("reference", tmp_path), _Side("port", tmp_path)
    try:
        got, want = scenario(port), scenario(ref)
    finally:
        ref.close()
        port.close()
    assert got == want
    return got


def test_insufficient_rolls_back_on_both(tmp_path):
    def scenario(s):
        owner = s.pod()
        creates = s.cluster.kube.create_calls
        seen = [s.outcome(lambda: s.get(owner, N + 1, 1)), s.slaves(), s.free(),
                s.cluster.kube.create_calls - creates,
                s.outcome(lambda: s.get(owner, N + 1, N + 1)), s.slaves(), s.free(),
                s.outcome(lambda: s.get(owner, 2, 1)), s.slaves(), s.free()]
        return seen

    assert _both(tmp_path, scenario) == [("insufficient",), 0, N, N + 1, ("insufficient",),
                                         0, N, ("ok", 2, 2), 2, N - 2]


def test_device_plugin_lag_rolls_back_on_both(tmp_path):
    def scenario(s):
        owner = s.pod()
        s.lag_device_plugin()
        return [s.outcome(lambda: s.get(owner, 2, 1)), s.slaves()]

    assert _both(tmp_path, scenario) == [("slave_error",), 0]


def test_bad_request_shapes_raise_on_both(tmp_path):
    def scenario(s):
        owner = s.pod()
        out = []
        for total, per in ((3, 2), (0, 1)):
            with pytest.raises(ValueError):
                s.get(owner, total, per)
            out.append(s.slaves())
        unscheduled = s.wrap({"metadata": {"name": "x", "namespace": "default", "uid": "u"}})
        out.append(s.outcome(lambda: s.get(unscheduled, 1, 1)))
        return out

    assert _both(tmp_path, scenario) == [0, 0, ("slave_error",)]


def test_mount_type_and_removal_plan_on_both(tmp_path):
    def scenario(s):
        single, entire = s.pod("single"), s.pod("entire")
        seen = [s.allocator.get_mount_type(single).value]
        devices, _ = s.get(single, 2, 1)
        seen.append(s.allocator.get_mount_type(single).value)
        s.get(entire, 2, 2)
        seen.append(s.allocator.get_mount_type(entire).value)
        uuids = [d.uuid for d in devices]
        seen.append(sorted(d.uuid for d in s.remove_plan(single, uuids[:1], False)) ==
                    uuids[:1])
        seen.append(s.remove_plan(single, uuids[:1] + ["bogus"], False))
        seen.append(len(s.remove_plan(entire, [], True)))
        seen.append({d.pod_name for d in s.remove_plan(single, uuids, False)} ==
                    {p.name for p in s.allocator.slave_pods_for(single)})
        s.allocator.delete_slave_pods([p.name for p in s.allocator.slave_pods_for(single)])
        seen += [s.allocator.get_mount_type(single).value, s.free()]
        return seen

    assert _both(tmp_path, scenario) == ["no-mount", "single-mount", "entire-mount", True, [],
                                         2, True, "no-mount", 2]
