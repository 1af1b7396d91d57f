"""The cgroup layer against the reference's: container cgroup paths over QoS
x driver x runtime x cgroup version, the driver and version sniffed from
fake roots, the QoS derivation, the v1 rule lines, and the refusal on a
cgroup v2 host (whose eBPF controller is not ported yet). Hermetic: fake
cgroup roots under tmp_path."""

from __future__ import annotations

import itertools
import os

import pytest

from gpumounter_tpu.cgroup import naming as ref
from gpumounter_tpu.cgroup.v1 import V1DeviceController as RefV1
from gpumounter_tpu.device.tpu import CompanionNode as RefCompanion
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu.k8s.types import Pod as RefPod
from gpumounter_tpu_torch.cgroup import V2_MISSING, CgroupError, naming
from gpumounter_tpu_torch.cgroup.v1 import V1DeviceController
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import FakeDeviceBackend
from gpumounter_tpu_torch.device.gpu import CompanionNode, GpuDevice
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountError, MountTarget

UID = "11111111-2222-3333-4444-555555555555"
RESOURCES = {
    "Guaranteed": {"limits": {"cpu": "1", "memory": "1Gi"}},
    "Burstable": {"requests": {"cpu": "500m"}},
    "BestEffort": {},
}


def _pod(qos: str, with_status: bool) -> dict:
    obj = {"metadata": {"name": "trainer", "namespace": "ml", "uid": UID},
           "spec": {"containers": [{"name": "main", "resources": RESOURCES[qos]}]},
           "status": {"qosClass": qos} if with_status else {}}
    return obj


CASES = list(itertools.product(RESOURCES, ("systemd", "cgroupfs"),
                               ("docker", "containerd", "cri-o", ""), (1, 2),
                               (True, False)))


@pytest.mark.parametrize("qos,driver,runtime,version,with_status", CASES,
                         ids=lambda v: str(v) if v != "" else "bare")
def test_container_cgroup_paths_match_the_reference(tmp_path, qos, driver, runtime,
                                                    version, with_status):
    obj = _pod(qos, with_status)
    port_pod, ref_pod = Pod(obj), RefPod(obj)
    assert naming.pod_qos_class(port_pod) == ref.pod_qos_class(ref_pod) == qos
    got = naming.pod_cgroup_relpath(port_pod, "cafe01", runtime, driver)
    assert got == ref.pod_cgroup_relpath(ref_pod, "cafe01", runtime, driver)
    root = str(tmp_path)
    got_dir = naming.container_cgroup_dir(port_pod, "cafe01", runtime, cgroup_root=root,
                                          driver=driver, version=version)
    assert got_dir == ref.container_cgroup_dir(ref_pod, "cafe01", runtime, cgroup_root=root,
                                               driver=driver, version=version)
    assert got_dir.endswith(got)


@pytest.mark.parametrize("name", [
    "kubepods.slice", "kubepods-burstable.slice", "kubepods-besteffort-pod1_2.slice",
    "-.slice", "a-b-c-d.slice", "bad", "a--b.slice", "-a.slice"])
def test_expand_slice_matches_the_reference(name):
    def run(fn):
        try:
            return fn(name)
        except ValueError as exc:
            return ("ValueError", str(exc))
    assert run(naming.expand_slice) == run(ref.expand_slice)


@pytest.mark.parametrize("layout", ["v1-systemd", "v1-cgroupfs", "v2-systemd", "v2-cgroupfs",
                                    "v1-empty", "v2-empty", "missing"])
def test_driver_and_version_sniffing_match_the_reference(tmp_path, layout):
    root = tmp_path / "cg"
    if layout != "missing":
        version, kind = layout.split("-")
        base = root if version == "v2" else root / "devices"
        base.mkdir(parents=True)
        if version == "v2":
            (root / "cgroup.controllers").write_text("cpu memory\n")
        if kind != "empty":
            (base / ("kubepods.slice" if kind == "systemd" else "kubepods")).mkdir()
    assert naming.detect_cgroup_version(str(root)) == ref.detect_cgroup_version(str(root))
    assert naming.detect_cgroup_driver(str(root)) == ref.detect_cgroup_driver(str(root))


def test_resolved_container_dir_on_a_fake_v1_root_and_its_pids(tmp_path):
    root = tmp_path / "cg"
    (root / "devices" / "kubepods.slice").mkdir(parents=True)
    obj = _pod("Burstable", False)
    got = naming.container_cgroup_dir(Pod(obj), "cid1", "containerd", cgroup_root=str(root))
    assert got == ref.container_cgroup_dir(RefPod(obj), "cid1", "containerd",
                                           cgroup_root=str(root))
    os.makedirs(got)
    with open(os.path.join(got, "cgroup.procs"), "w") as f:
        f.write("12\n34\n")
    assert naming.get_cgroup_pids(got) == ref.get_cgroup_pids(got) == [12, 34]
    assert naming.get_cgroup_pids(str(tmp_path / "absent")) == []


def test_a_pod_without_uid_or_with_an_unknown_driver_raises_as_the_reference():
    obj = _pod("Burstable", True)
    obj["metadata"]["uid"] = ""
    for mod, pod in ((naming, Pod(obj)), (ref, RefPod(obj))):
        with pytest.raises(ValueError, match="has no UID"):
            mod.pod_cgroup_relpath(pod, "c", "containerd", "systemd")
    obj["metadata"]["uid"] = UID
    for mod, pod in ((naming, Pod(obj)), (ref, RefPod(obj))):
        with pytest.raises(ValueError, match="unknown cgroup driver"):
            mod.pod_cgroup_relpath(pod, "c", "containerd", "other")


def _recorder(controller):
    lines = []
    controller._write = lambda cg, filename, rule: lines.append((filename, rule))
    return lines


def test_v1_rule_lines_match_the_reference():
    port, want = V1DeviceController(), RefV1()
    got_lines, want_lines = _recorder(port), _recorder(want)
    gpu = GpuDevice(index=0, device_path="/dev/nvidia3", major=195, minor=3, uuid="GPU-x",
                    companions=[CompanionNode("nvidiactl", 195, 255),
                                CompanionNode("nvidia-uvm", 509, 0)])
    chip = TpuDevice(index=0, device_path="/dev/nvidia3", major=195, minor=3, uuid="x",
                     companions=[RefCompanion("nvidiactl", 195, 255),
                                 RefCompanion("nvidia-uvm", 509, 0)])
    port.grant("/cg", gpu)
    want.grant("/cg", chip)
    port.revoke("/cg", gpu)
    want.revoke("/cg", chip)
    assert got_lines == want_lines == [
        ("devices.allow", "c 195:3 rw"), ("devices.allow", "c 195:255 rw"),
        ("devices.allow", "c 509:0 rw"), ("devices.deny", "c 195:3 rw")]


def test_v1_writes_land_in_the_files_and_a_failed_write_raises(tmp_path):
    gpu = GpuDevice(index=0, device_path="/dev/nvidia0", major=195, minor=0, uuid="GPU-x")
    V1DeviceController().grant(str(tmp_path), gpu)
    assert (tmp_path / "devices.allow").read_text() == "c 195:0 rw"
    with pytest.raises(CgroupError, match="devices.deny"):
        V1DeviceController().revoke(str(tmp_path / "absent"), gpu)


def test_a_v2_host_raises_the_named_mount_error(tmp_path):
    backend = FakeDeviceBackend.create(str(tmp_path / "dev"), 1)
    (dev,) = backend.list_devices()
    mounter = GpuMounter(backend, cfg=Config(cgroup_version="2"))
    target = MountTarget(dev_dir=str(tmp_path / "container"), cgroup_dirs=[str(tmp_path)],
                         description="ml/trainer")
    for call in (lambda: mounter.mount_many(target, [dev]),
                 lambda: mounter.unmount(target, dev, force=True)):
        with pytest.raises(MountError) as exc:
            call()
        assert V2_MISSING in str(exc.value)
    assert not os.path.exists(target.dev_dir)  # nothing injected, nothing granted
    assert not (tmp_path / "devices.allow").exists()
    # A bare directory target needs no grant, on any host.
    bare = MountTarget(dev_dir=str(tmp_path / "bare"))
    mounter.mount_many(bare, [dev])
    assert os.path.exists(os.path.join(bare.dev_dir, dev.basename))
