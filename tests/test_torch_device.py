"""The device layer: ``NvidiaDeviceBackend`` on a fake /dev tree with both
identity sources (an NVML stand-in behind ``CtypesNvml``'s interface, and a
fake ``/proc/driver/nvidia/gpus``), and the primitives it shares with the
reference (``stat_device_numbers``, ``scan_proc_for_device``,
``probe_device``), held to the reference's answers on the same nodes.

The fake trees hold real character devices (mknod, as root here); a node
that a process must open is a clone of /dev/null or /dev/full, which open
anywhere.
"""

from __future__ import annotations

import os
import stat
import subprocess
import sys

import pytest

from gpumounter_tpu.device.backend import RealAccelBackend
from gpumounter_tpu.device.backend import scan_proc_for_device as ref_scan
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu.device.tpu import stat_device_numbers as ref_stat
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import InMemoryKubelet
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import (COMPANIONS, CtypesNvml, FakeDeviceBackend,
                                                 IdentityError, NvidiaDeviceBackend,
                                                 NvmlIdentity, ProcfsIdentity,
                                                 backend_from_config, identity_from_config,
                                                 scan_proc_for_device)
from gpumounter_tpu_torch.device.gpu import GpuDevice, stat_device_numbers
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev

NV_MAJOR = 195


class FakeNvml:
    """NVML's answers for a host, behind CtypesNvml's interface."""

    def __init__(self, gpus):
        self.gpus = gpus  # [(minor, uuid, pci)] in NVML index order
        self.calls = []

    def init(self):
        self.calls.append("init")

    def shutdown(self):
        self.calls.append("shutdown")

    def count(self):
        return len(self.gpus)

    def minor(self, i):
        return self.gpus[i][0]

    def uuid(self, i):
        return self.gpus[i][1]

    def pci_bus_id(self, i):
        return self.gpus[i][2]


def _uuid(i):
    return f"GPU-0000000{i}-1111-2222-3333-444444444444"


def _mknod(path, major, minor):
    try:
        os.mknod(path, 0o666 | stat.S_IFCHR, os.makedev(major, minor))
    except PermissionError as exc:
        pytest.skip(f"the fake /dev tree needs mknod: {exc}")


def _dev_tree(root, minors, companions=COMPANIONS):
    """nvidia<m> for each minor, and the companions (nvidiactl 195:255,
    nvidia-uvm 509:0, nvidia-uvm-tools 509:1)."""
    root.mkdir(exist_ok=True)
    for m in minors:
        _mknod(root / f"nvidia{m}", NV_MAJOR, m)
    numbers = {"nvidiactl": (NV_MAJOR, 255), "nvidia-uvm": (509, 0),
               "nvidia-uvm-tools": (509, 1)}
    for name in companions:
        _mknod(root / name, *numbers[name])
    return root


def _procfs(root, gpus):
    """/proc/driver/nvidia/gpus: one directory per PCI address, in the
    driver's format."""
    for minor, uuid, pci in gpus:
        d = root / pci
        d.mkdir(parents=True)
        (d / "information").write_text(
            f"Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\nGPU UUID: \t {uuid}\n"
            f"Video BIOS: \t 96.00.99.00.01\nBus Type: \t PCIe\nDMA Size: \t 52 bits\n"
            f"Bus Location: \t {pci}\nDevice Minor: \t {minor}\n")
    return root


def _identity(kind, tmp_path, gpus):
    if kind == "nvml":
        return NvmlIdentity(lib=FakeNvml(gpus))
    return ProcfsIdentity(str(_procfs(tmp_path / "gpus", gpus)))


IDENTITIES = ["nvml", "procfs"]

# An 8-GPU host whose minors are not in PCI order: the NVML index (PCI
# order) and the minor number differ.
HOST8 = [(m, _uuid(i), f"0000:{0x18 + 0x10 * i:02x}:00.0")
         for i, m in enumerate([2, 0, 3, 1, 6, 4, 7, 5])]


@pytest.mark.parametrize("kind", IDENTITIES)
def test_nodes_tie_to_gpus_by_minor_not_by_name_order(tmp_path, kind):
    dev = _dev_tree(tmp_path / "dev", [m for m, _, _ in HOST8])
    backend = NvidiaDeviceBackend(str(dev), identity=_identity(kind, tmp_path, HOST8))
    devices = backend.list_devices()
    assert [d.index for d in devices] == list(range(8))
    for d, (minor, uuid, pci) in zip(devices, HOST8):
        assert (d.uuid, d.pci_bus_id, d.minor, d.major) == (uuid, pci, minor, NV_MAJOR)
        assert d.device_path == str(dev / f"nvidia{minor}")
        assert stat_device_numbers(d.device_path) == (NV_MAJOR, minor, True)
        assert [(c.rel_path, c.major, c.minor) for c in d.companions] == [
            ("nvidiactl", NV_MAJOR, 255), ("nvidia-uvm", 509, 0), ("nvidia-uvm-tools", 509, 1)]
    assert backend.device_by_uuid(_uuid(3)).device_path == str(dev / "nvidia1")


@pytest.mark.parametrize("kind", IDENTITIES)
def test_two_nodes_for_one_card(tmp_path, kind):
    """A sandbox may show nvidia0 and nvidia3 for its one card, whose minor
    is 3: one GPU, and nvidia0 reported as no device."""
    gpus = [(3, _uuid(0), "0000:3b:00.0")]
    dev = _dev_tree(tmp_path / "dev", [0, 3])
    backend = NvidiaDeviceBackend(str(dev), identity=_identity(kind, tmp_path, gpus))
    scan = backend.scan()
    assert [(d.basename, d.uuid, d.index) for d in scan.devices] == [("nvidia3", _uuid(0), 0)]
    assert scan.unbound == [("nvidia0", NV_MAJOR, 0, "no GPU has minor 0")]
    assert scan.missing == []
    # The tenant's count of nvidia[0-9]+ nodes reads 2 on such a /dev
    # (ROADMAP §3): it counts names, the worker ties minors.
    assert gpus_visible_in_dev(str(dev)) == 2


def test_a_gpu_without_a_node_and_a_node_that_is_not_a_device(tmp_path):
    gpus = [(0, _uuid(0), ""), (1, _uuid(1), "")]
    dev = _dev_tree(tmp_path / "dev", [0])
    (dev / "nvidia7").write_text("")  # a regular file
    scan = NvidiaDeviceBackend(str(dev), identity=NvmlIdentity(lib=FakeNvml(gpus))).scan()
    assert [d.uuid for d in scan.devices] == [_uuid(0)]
    assert [g.uuid for g in scan.missing] == [_uuid(1)]
    assert scan.unbound == [("nvidia7", 0, 0, "not a character device")]


def test_absent_companions_are_left_out_and_named(tmp_path):
    dev = _dev_tree(tmp_path / "dev", [0], companions=("nvidiactl", "nvidia-uvm"))
    (dev / "nvidia-uvm").unlink()
    (dev / "nvidia-uvm").write_text("")
    backend = NvidiaDeviceBackend(str(dev), identity=NvmlIdentity(
        lib=FakeNvml([(0, _uuid(0), "")])))
    (d,) = backend.list_devices()
    assert [c.rel_path for c in d.companions] == ["nvidiactl"]
    absent = backend.absent_companions()
    assert absent["nvidia-uvm"] == "not a character device"
    assert absent["nvidia-uvm-tools"].startswith("stat failed")


def test_a_companion_of_rdev_0_0_names_no_device(tmp_path):
    dev = _dev_tree(tmp_path / "dev", [0], companions=("nvidiactl", "nvidia-uvm"))
    _mknod(dev / "nvidia-uvm-tools", 0, 0)
    backend = NvidiaDeviceBackend(str(dev), identity=NvmlIdentity(
        lib=FakeNvml([(0, _uuid(0), "")])))
    assert backend.absent_companions() == {"nvidia-uvm-tools": "rdev 0:0 names no device"}


def test_identity_sources_agree_and_nvml_is_shut_down(tmp_path):
    lib = FakeNvml(HOST8)
    nvml = NvmlIdentity(lib=lib).gpus()
    assert lib.calls == ["init", "shutdown"]
    procfs = ProcfsIdentity(str(_procfs(tmp_path / "gpus", HOST8))).gpus()
    assert nvml == procfs


def test_identity_failures_raise(tmp_path):
    with pytest.raises(IdentityError, match="/nonexistent/libnvidia-ml.so.1"):
        CtypesNvml("/nonexistent/libnvidia-ml.so.1").init()
    with pytest.raises(IdentityError, match="cannot list"):
        ProcfsIdentity(str(tmp_path / "none")).gpus()
    bad = tmp_path / "gpus" / "0000:3b:00.0"
    bad.mkdir(parents=True)
    (bad / "information").write_text("Model: H100\n")
    with pytest.raises(IdentityError, match="GPU UUID|Device Minor"):
        ProcfsIdentity(str(tmp_path / "gpus")).gpus()
    with pytest.raises(ValueError, match="nvml or procfs"):
        identity_from_config(Config(gpu_identity_source="sysfs"))


def test_backend_from_config(tmp_path):
    fake = backend_from_config(Config(fake_device_dir=str(tmp_path)))
    assert isinstance(fake, FakeDeviceBackend)
    real = backend_from_config(Config(fake_device_dir="", device_dir=str(tmp_path),
                                      gpu_identity_source="procfs",
                                      nvidia_procfs_dir=str(tmp_path / "p")))
    assert isinstance(real, NvidiaDeviceBackend) and isinstance(real.identity, ProcfsIdentity)
    assert Config().gpu_resource_name == "nvidia.com/gpu"


def test_the_collector_matches_an_index_as_the_nvml_index_only(tmp_path):
    """The device plugin's index strategy advertises NVML indexes: "1" is
    NVML index 1 (minor 0 on HOST8), never nvidia1, and a node name is not
    a device ID."""
    dev = _dev_tree(tmp_path / "dev", [m for m, _, _ in HOST8])
    backend = NvidiaDeviceBackend(str(dev), identity=NvmlIdentity(lib=FakeNvml(HOST8)))
    kubelet = InMemoryKubelet()
    kubelet.set_claim("a", "ns", "nvidia.com/gpu", ["1"])
    kubelet.set_claim("b", "ns", "nvidia.com/gpu", [_uuid(4)])
    kubelet.set_claim("c", "ns", "nvidia.com/gpu", ["nvidia2", str(dev / "nvidia7")])
    kubelet.set_claim("d", "ns", "example.com/other", ["0"])
    collector = GpuCollector(backend, kubelet, cfg=Config())
    owners = {d.device_path: d.pod_name for d in collector.devices if d.pod_name}
    assert owners == {str(dev / "nvidia0"): "a", str(dev / "nvidia6"): "b",
                      str(dev / "nvidia7"): "c"}
    assert collector.get_pod_devices("a", "ns")[0].index == 1


def _ref_device(path, major, minor):
    return TpuDevice(index=0, device_path=path, major=major, minor=minor, uuid="x")


def _port_device(path, major, minor):
    return GpuDevice(index=0, device_path=path, major=major, minor=minor, uuid="x")


def test_stat_device_numbers_matches_the_reference(tmp_path):
    _mknod(tmp_path / "c", NV_MAJOR, 7)
    (tmp_path / "r").write_text("")
    for name in ("c", "r"):
        assert stat_device_numbers(str(tmp_path / name)) == ref_stat(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        stat_device_numbers(str(tmp_path / "none"))


@pytest.mark.parametrize("change", ["none", "identity", "gone", "not_char"])
def test_probe_device_matches_the_reference(tmp_path, change):
    path = tmp_path / "nvidia0"
    _mknod(path, NV_MAJOR, 0)
    if change == "identity":
        path.unlink()
        _mknod(path, NV_MAJOR, 4)
    elif change == "gone":
        path.unlink()
    elif change == "not_char":
        path.unlink()
        path.write_text("")
    backend = NvidiaDeviceBackend(str(tmp_path), identity=NvmlIdentity(lib=FakeNvml([])))
    got = backend.probe_device(_port_device(str(path), NV_MAJOR, 0))
    want = RealAccelBackend(str(tmp_path)).probe_device(_ref_device(str(path), NV_MAJOR, 0))
    assert got == want
    assert got[0] == (change == "none")


def _hold(path):
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; f = open(sys.argv[1], 'rb'); print('held', "
         "flush=True); sys.stdin.read()", str(path)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    assert child.stdout.readline().strip() == "held"
    return child


def test_busy_detection_finds_a_child_holding_a_node(tmp_path):
    """By path and by rdev, with the reference's answer on the same node: a
    clone of /dev/full (1:7) that a child holds open."""
    full = os.stat("/dev/full").st_rdev
    path = tmp_path / "nvidia0"
    try:
        os.mknod(path, 0o666 | stat.S_IFCHR, full)
    except PermissionError as exc:
        pytest.skip(f"needs mknod: {exc}")
    child = _hold(path)
    try:
        major, minor = os.major(full), os.minor(full)
        by_path = scan_proc_for_device(None, None, path_hint=str(path))
        assert by_path == [child.pid] == ref_scan(None, None, path_hint=str(path))
        by_rdev = scan_proc_for_device(major, minor)
        assert child.pid in by_rdev and child.pid in ref_scan(major, minor)
        backend = NvidiaDeviceBackend(str(tmp_path), identity=NvmlIdentity(lib=FakeNvml([])))
        assert child.pid in backend.running_pids(_port_device(str(path), major, minor))
    finally:
        child.kill()
        child.wait()
    assert scan_proc_for_device(None, None, path_hint=str(path)) == []


def test_fake_backend_lists_marks_dead_and_finds_holders(tmp_path):
    backend = FakeDeviceBackend.create(str(tmp_path / "dev"), 3)
    devices = backend.list_devices()
    assert [(d.index, d.uuid, d.basename) for d in devices] == [
        (i, FakeDeviceBackend.fake_uuid(i), f"nvidia{i}") for i in range(3)]
    assert [c.rel_path for c in devices[0].companions] == list(COMPANIONS)
    assert backend.absent_companions() == {}
    assert backend.probe_device(devices[1]) == (True, "")
    backend.mark_dead("nvidia1")
    assert backend.probe_device(devices[1])[0] is False
    assert len(backend.list_devices()) == 3  # a dead GPU keeps its node
    child = _hold(devices[2].device_path)
    try:
        assert backend.running_pids(devices[2]) == [child.pid]
    finally:
        child.kill()
        child.wait()


def test_fake_backend_without_mknod_uses_regular_files(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise PermissionError(1, "Operation not permitted")

    monkeypatch.setattr(os, "mknod", refuse)
    backend = FakeDeviceBackend.create(str(tmp_path / "dev"), 2)
    devices = backend.list_devices()
    assert [(d.major, d.minor) for d in devices] == [(1, 100), (1, 101)]
    assert [(c.major, c.minor) for c in devices[0].companions] == [(1, 200), (1, 201), (1, 202)]
    assert stat.S_ISREG(os.stat(devices[0].device_path).st_mode)


def test_scan_container_dev_nodes_matches_the_reference(tmp_path):
    from gpumounter_tpu.nsutil.ns import scan_container_dev_nodes as ref_scan_dev
    from gpumounter_tpu_torch.nsutil.ns import scan_container_dev_nodes
    dev = _dev_tree(tmp_path / "dev", [0, 2])
    (dev / "dri").mkdir()
    _mknod(dev / "dri" / "card0", 226, 0)
    (dev / "shm").mkdir()
    (dev / "shm" / "file").write_text("")
    got = sorted(scan_container_dev_nodes(None, str(dev)))
    assert got == sorted(ref_scan_dev(None, str(dev)))
    assert [(r, ma, mi) for r, ma, mi, _ in got] == [
        ("dri/card0", 226, 0), ("nvidia-uvm", 509, 0), ("nvidia-uvm-tools", 509, 1),
        ("nvidia0", NV_MAJOR, 0), ("nvidia2", NV_MAJOR, 2), ("nvidiactl", NV_MAJOR, 255)]
