"""The cgroup layer against the reference's: container cgroup paths over QoS
x driver x runtime x cgroup version, the driver and version sniffed from
fake roots, the QoS derivation, the v1 rule lines, and the worker on a
cgroup v2 host: the base rules folded from the container's /dev, a mount
and remove through ``GpuMountService``, a rolled-back batch and the
companions' keys, each beside the reference's mounter on the same tree and
the same stubbed kernel (``testing/bpf.py``'s ``FakeBpf``). Hermetic: fake
cgroup roots and /dev trees under tmp_path (mknod needs root)."""

from __future__ import annotations

import contextlib
import itertools
import os
import stat as statmod

import pytest

import gpumounter_tpu.cgroup as ref_cgroup
from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.cgroup import naming as ref
from gpumounter_tpu.cgroup import policy as ref_policy
from gpumounter_tpu.cgroup.v1 import V1DeviceController as RefV1
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.device.backend import DeviceBackend as RefBackend
from gpumounter_tpu.device.tpu import CompanionNode as RefCompanion
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu.k8s.types import Pod as RefPod
from gpumounter_tpu.utils import metrics as ref_metrics
from gpumounter_tpu.worker import mounter as ref_mounter
import gpumounter_tpu_torch.cgroup as port_cgroup
from gpumounter_tpu_torch.cgroup import CgroupError, ebpf, naming, policy
from gpumounter_tpu_torch.cgroup.v1 import V1DeviceController
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import FakeDeviceBackend
from gpumounter_tpu_torch.device.gpu import CompanionNode, GpuDevice
from gpumounter_tpu_torch.testing.bpf import FakeBpf
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.utils import metrics
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget, _fold_access

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


# --- the worker on cgroup v2 ---

UVM = 511  # nvidia-uvm's major is dynamic; stat gives whatever the host chose
HOST_NODES = [("nvidiactl", 195, 255), ("nvidia-uvm", UVM, 0), ("nvidia-uvm-tools", UVM, 1)]
CHAR = ebpf.BPF_DEVCG_DEV_CHAR
RW = ebpf.BPF_DEVCG_ACC_READ | ebpf.BPF_DEVCG_ACC_WRITE


def _mknod(path, major, minor, mode=0o666):
    os.mknod(str(path), mode | statmod.S_IFCHR, os.makedev(major, minor))
    os.chmod(str(path), mode)


def _gpu_host(root, n: int) -> str:
    """A fake host /dev: nvidia0..n-1 (195:i) and the three companions."""
    os.makedirs(root)
    for i in range(n):
        _mknod(os.path.join(root, f"nvidia{i}"), 195, i)
    for name, major, minor in HOST_NODES:
        _mknod(os.path.join(root, name), major, minor)
    return str(root)


def _container_dev(root, gpu_leftovers: bool) -> str:
    """A container's /dev as runc made it: null, fuse from a device plugin,
    a 000-mode node; with `gpu_leftovers` also a GPU node and the
    companions an earlier hot mount left behind."""
    os.makedirs(root)
    _mknod(os.path.join(root, "null"), 1, 3)
    _mknod(os.path.join(root, "fuse"), 10, 229)
    _mknod(os.path.join(root, "secret"), 10, 231, mode=0o000)
    if gpu_leftovers:
        _mknod(os.path.join(root, "nvidia0"), 195, 0)
        for name, major, minor in HOST_NODES[:2]:
            _mknod(os.path.join(root, name), major, minor)
    return str(root)


class _RefHost(RefBackend):
    """The reference's view of the same host: the same numbers."""

    def __init__(self, n: int):
        self.n = n

    def list_devices(self):
        return [TpuDevice(index=i, device_path=f"/dev/nvidia{i}", major=195, minor=i,
                          uuid=FakeDeviceBackend.fake_uuid(i),
                          companions=[RefCompanion(*c) for c in HOST_NODES])
                for i in range(self.n)]

    def running_pids(self, device):
        return []


def _rules(rules) -> list[tuple]:
    return [(r.type, r.major, r.minor, r.access) for r in rules]


@pytest.fixture(params=[False, True], ids=["legacy", "maps"])
def v2(request, tmp_path, monkeypatch):
    """Both packages' v2 controllers (process singletons, as the mounters
    take them) over stubbed kernels, in directories of this test; the
    process-global tables reset around it."""
    def reset():
        for mod in (ebpf, ref_ebpf):
            mod.DEVICE_TELEMETRY.reset()
            mod.DEVICE_TELEMETRY._readers.clear()
        for mod in (policy, ref_policy):
            mod.POLICY_ENGINE.reset()
        for reg in (metrics.REGISTRY, ref_metrics.REGISTRY):
            reg.reset_all()
    reset()
    out = {}
    with contextlib.ExitStack() as stack:
        for name, mod, pkg in (("port", ebpf, port_cgroup), ("reference", ref_ebpf, ref_cgroup)):
            kernel = stack.enter_context(FakeBpf(maps=request.param).installed(mod))
            ctl = mod.V2DeviceController(pin_dir=str(tmp_path / name / "bpffs"),
                                         state_dir=str(tmp_path / name / "state"))
            stack.callback(ctl.close)
            monkeypatch.setattr(pkg, "_v2_singleton", ctl)
            out[name] = (kernel, ctl)
        yield out
    reset()


def test_fold_access_matches_the_reference():
    for major, minor, mode in itertools.product((1, 10, 136, 195, 508), (3, 7, 229),
                                                (0o20666, 0o20644, 0o20444, 0o20220, 0o20000)):
        assert _fold_access(major, minor, mode) == ref_mounter._fold_access(major, minor, mode)
    assert _fold_access(10, 229, 0o20000) == "r"
    assert _fold_access(136, 7, 0o20620) == "rwm"


def test_v2_base_rules_match_the_reference(tmp_path, v2):
    """The container's /dev folds into the base rules; a GPU node of this
    host left there does not (its rule would outlive its revoke); the
    companions do."""
    host = FakeDeviceBackend(_gpu_host(tmp_path / "host", 2))
    dev = _container_dev(tmp_path / "container", gpu_leftovers=True)
    port = GpuMounter(host, cfg=Config(cgroup_version="2"))
    want = ref_mounter.TpuMounter(_RefHost(2), cfg=RefConfig().replace(cgroup_version="2"))
    assert port.controller is v2["port"][1] and want.controller is v2["reference"][1]
    caller = [("c", 195, 1, "rw")]
    got = port._v2_base_rules(MountTarget(dev_dir=dev, description="ml/t"),
                              [ebpf.DeviceRule(*r) for r in caller])
    expected = want._v2_base_rules(ref_mounter.MountTarget(dev_dir=dev, description="ml/t"),
                                   [ref_ebpf.DeviceRule(*r) for r in caller])
    assert _rules(got) == _rules(expected)
    assert sorted(_rules(got)) == sorted(caller + [
        ("c", 1, 3, "rwm"), ("c", 10, 229, "rw"), ("c", 10, 231, "r"),
        ("c", 195, 255, "rw"), ("c", UVM, 0, "rw")])


def test_a_v2_mount_and_remove_through_the_service(tmp_path, v2):
    """add_gpu(2) on a host of 4: our program replaces runc's (7) on the
    pod's cgroup, with the base rules the reference's mounter folds from
    the same /dev; both GPUs and their companions are admitted rw, the
    other GPUs are not; remove_gpu puts runc's program back exactly."""
    kernel, ctl = v2["port"]
    cluster = FakeCluster(FakeDeviceBackend(_gpu_host(tmp_path / "host", 4)),
                          cfg=Config(cgroup_version="2"))
    cgroup = tmp_path / "cgroup" / "pod"
    os.makedirs(cgroup)
    kernel.preattach(str(cgroup), 7)
    dev = _container_dev(tmp_path / "container", gpu_leftovers=False)
    want_base = ref_mounter.TpuMounter(_RefHost(4), cfg=RefConfig().replace(
        cgroup_version="2"))._v2_base_rules(ref_mounter.MountTarget(dev_dir=dev), [])
    service = cluster.service(dev, cgroup_dirs=[str(cgroup)])
    cluster.add_target_pod("trainer")

    added = service.add_gpu(api.AddGPURequest("trainer", "default", 2))
    assert added.add_gpu_result == api.AddGPUResult.Success
    gpus = [cluster.backend.device_by_uuid(u) for u in added.uuids]
    key = str(cgroup)
    assert _rules(ctl._state[key].base_rules) == _rules(want_base)
    assert [kernel.describe(p)[0] for p in kernel.attached[key]] == ["ours"]
    admit = lambda major, minor, access=RW: kernel.verdict(  # noqa: E731
        policy.interpret_device_program, key, CHAR, access, major, minor)
    for gpu in gpus:
        assert admit(gpu.major, gpu.minor) == 1
    others = {(195, i) for i in range(4)} - {(g.major, g.minor) for g in gpus}
    assert [admit(*o) for o in sorted(others)] == [0, 0]
    assert [admit(major, minor) for _, major, minor in HOST_NODES] == [1, 1, 1]
    assert admit(10, 229) == 1 and admit(10, 231) == 0 and admit(10, 231, 2) == 1
    assert metrics.MOUNT_TOTAL.get(result="success") == 2
    assert ebpf.DEVICE_TELEMETRY.counts()[("default/trainer", "grant")] == 2

    removed = service.remove_gpu(api.RemoveGPURequest("trainer", "default", added.uuids))
    assert removed.remove_gpu_result == api.RemoveGPUResult.Success
    assert kernel.attached[key] == [7]
    assert ctl._state == {} and os.listdir(ctl.state_dir) == [] and os.listdir(ctl.pin_dir) == []
    assert metrics.UNMOUNT_TOTAL.get(result="success") == 2
    assert {dict(k)["phase"] for k in metrics.PHASE_LATENCY.snapshot()} == {
        "cgroup_grant", "device_inject", "busy_check", "cgroup_revoke", "device_remove"}


def _both_mounters(tmp_path, n: int = 2):
    host = FakeDeviceBackend(_gpu_host(tmp_path / "host", n))
    port = GpuMounter(host, cfg=Config(cgroup_version="2"))
    ref_m = ref_mounter.TpuMounter(_RefHost(n), cfg=RefConfig().replace(cgroup_version="2"))
    return host.list_devices(), port, _RefHost(n).list_devices(), ref_m


def test_a_failed_v2_grant_rolls_the_batch_back_as_the_reference(tmp_path, v2):
    """Two GPUs into a pod of two containers: the second cgroup's query is
    refused, so the batch rolls back; the first cgroup's undo cannot put
    runc's program back, so the rollback leaks it and counts one failure.
    The port and the reference raise the same and leave the same."""
    port_gpus, port, ref_gpus, ref_m = _both_mounters(tmp_path)
    cgroups = [str(tmp_path / "cg" / c) for c in ("a", "b")]
    seen = {}
    for name, mounter, gpus, target_cls in (
            ("port", port, port_gpus, MountTarget),
            ("reference", ref_m, ref_gpus, ref_mounter.MountTarget)):
        for c in cgroups:
            os.makedirs(c, exist_ok=True)
        kernel, ctl = v2[name]
        kernel.preattach(cgroups[0], 7)
        kernel.preattach(cgroups[1], 8)
        kernel.fail_query.add(cgroups[1])
        kernel.fail_attach.add(7)
        dev_dir = str(tmp_path / f"{name}-dev")
        os.makedirs(dev_dir)
        target = target_cls(dev_dir=dev_dir, cgroup_dirs=cgroups, description="ml/trainer")
        with pytest.raises(Exception) as exc:
            mounter.mount_many(target, gpus)
        assert type(exc.value).__name__ == "MountError"
        seen[name] = (str(exc.value).replace(dev_dir, "DEV"),
                      kernel.observe(ctl, str(tmp_path / name), {"a": cgroups[0],
                                                                 "b": cgroups[1]}),
                      os.listdir(dev_dir))
    assert seen["port"] == seen["reference"]
    assert "refusing to grant blindly" in seen["port"][0]
    attached = seen["port"][1]["attached"]
    assert [d[0] for d in attached["a"]] == ["ours"] and attached["b"] == [("orig", 8)]
    assert metrics.MOUNT_ROLLBACK_FAILURES.get() == \
        ref_metrics.MOUNT_ROLLBACK_FAILURES.get() == 1
    assert metrics.MOUNT_TOTAL.get(result="error") == \
        ref_metrics.MOUNT_TOTAL.get(result="error") == 2


def test_the_companions_go_with_the_last_gpu_on_v2(tmp_path, v2):
    """Two GPUs mounted, then removed one by one: the first removal keeps
    the companions for the other GPU; the last takes them too (on the map
    path their keys leave the map) and restores runc's program. On v1 the
    companions stay allowed (``cgroup/v1.py``: only the GPU's node is
    denied). The reference does the same, step for step."""
    port_gpus, port, ref_gpus, ref_m = _both_mounters(tmp_path)
    cg = str(tmp_path / "cg")
    os.makedirs(cg)
    steps = {}
    for name, mounter, gpus, target_cls, unmount in (
            ("port", port, port_gpus, MountTarget,
             lambda m, t, d: m.unmount_many(t, [d], force=True)),
            ("reference", ref_m, ref_gpus, ref_mounter.MountTarget,
             lambda m, t, d: m.unmount(t, d, force=True))):
        kernel, ctl = v2[name]
        kernel.preattach(cg, 7)
        dev_dir = str(tmp_path / f"{name}-dev")
        os.makedirs(dev_dir)
        target = target_cls(dev_dir=dev_dir, cgroup_dirs=[cg], description="ml/trainer")
        mounter.mount_many(target, gpus)
        out = []
        for gpu in gpus:
            unmount(mounter, target, gpu)
            verdicts = ([kernel.verdict(policy.interpret_device_program, cg, CHAR, RW, ma, mi)
                         for ma, mi in [(195, 0), (195, 1)] + [c[1:] for c in HOST_NODES]]
                        if kernel.attached[cg] != [7] else "runc's")
            out.append((kernel.observe(ctl, str(tmp_path / name), {"cg": cg}), verdicts))
        steps[name] = out
    assert steps["port"] == steps["reference"]
    (first, first_verdicts), (last, last_verdicts) = steps["port"]
    assert first_verdicts == [0, 1, 1, 1, 1]
    assert last_verdicts == "runc's" and last["attached"]["cg"] == [("orig", 7)]
    assert last["policy_maps"] == {} and last["tracked"] == []
    if first["policy_maps"]:
        assert len(first["policy_maps"]["cg"]) == 4  # GPU 1 and its three companions


def test_a_fractional_policy_lands_where_the_reference_puts_it(tmp_path, v2):
    """`policy=` (a GPU's uuid -> weight, rate budget): on a target with
    no cgroup the userspace engine holds it, and the unmount clears the
    engine's entry; on v2 with kernel maps the grant's policy-map entry
    carries it; on v2 without maps the grant is a static rule and the
    policy is held nowhere. The reference does the same in each case."""
    port_gpus, port, ref_gpus, ref_m = _both_mounters(tmp_path)
    cg = str(tmp_path / "cg")
    os.makedirs(cg)
    seen = {}
    for name, mounter, gpus, target_cls, engine, unmount in (
            ("port", port, port_gpus, MountTarget, policy.POLICY_ENGINE,
             lambda m, t, d: m.unmount_many(t, [d], force=True)),
            ("reference", ref_m, ref_gpus, ref_mounter.MountTarget, ref_policy.POLICY_ENGINE,
             lambda m, t, d: m.unmount(t, d, force=True))):
        kernel, ctl = v2[name]
        kernel.preattach(cg, 7)
        share = {gpus[0].uuid: (60, 8), gpus[1].uuid: (40, 0)}
        out = []
        for key, cgroups in (("bare", []), ("cgroup", [cg])):
            dev_dir = str(tmp_path / f"{name}-{key}-dev")
            os.makedirs(dev_dir)
            target = target_cls(dev_dir=dev_dir, cgroup_dirs=cgroups, description=f"ml/{key}")
            mounter.mount_many(target, gpus, policy=share)
            out.append((engine.entries(f"ml/{key}"),
                        kernel.observe(ctl, str(tmp_path / name), {"cg": cg})["policy_maps"]))
            unmount(mounter, target, gpus[0])
            out.append(engine.entries(f"ml/{key}"))
        seen[name] = out
    assert seen["port"] == seen["reference"]
    key = ebpf.telemetry_key
    bare, bare_after = seen["port"][0][0], seen["port"][1]
    assert bare == {key(195, 0): ebpf.policy_value(60, 8),
                    key(195, 1): ebpf.policy_value(40, ebpf.POLICY_UNMETERED)}
    assert bare_after == {key(195, 1): ebpf.policy_value(40, ebpf.POLICY_UNMETERED)}
    engine_entries, maps = seen["port"][2]
    assert engine_entries == {}
    if maps:
        assert maps["cg"][key(195, 0)] == ebpf.policy_value(60, 8)
