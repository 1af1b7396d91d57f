"""Device backends: the host's NVIDIA GPUs, and a fake for dry runs.

The counterpart of ``gpumounter_tpu/device/backend.py``. The original
GPUMounter enumerates through NVML (``collector.go:40-79``: nvml.Init,
DeviceGetCount, GetHandleByIndex, MinorNumber, UUID, through the dlopen
shim ``nvml_dl.go:29-36``); ``NvidiaDeviceBackend`` does the same through
ctypes, or reads the driver's procfs instead, and ties each ``/dev/nvidiaN``
node to a GPU by the minor number that stat(2) gives the node. A node name
is not an identity: a sandbox may show two ``nvidiaN`` nodes for one card,
and only the one whose minor the driver reports for a GPU is that GPU.

Busy detection is a /proc/<pid>/fd scan for descriptors on the device
(matched by rdev, so it works across mount namespaces and renamed nodes),
where the original asks NVML for the compute processes (nvml.go:33-52).
"""

from __future__ import annotations

import abc
import ctypes
import json
import os
import re
import stat as statmod
from dataclasses import dataclass

from gpumounter_tpu_torch.device.gpu import (
    CompanionNode,
    GpuDevice,
    stat_device_numbers,
)
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("device")

GPU_NODE_RE = re.compile(r"^nvidia(\d+)$")
#: the control nodes a CUDA process opens besides its GPU's node.
COMPANIONS = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


class IdentityError(RuntimeError):
    """The identity source could not say which GPUs the host has."""


class DeviceBackend(abc.ABC):
    """Enumeration + identity + busy primitives behind one interface."""

    @abc.abstractmethod
    def list_devices(self) -> list[GpuDevice]: ...

    def absent_companions(self) -> dict[str, str]:
        """Companion nodes left out of every GPU's list, each with why."""
        return {}

    def device_by_uuid(self, uuid: str) -> GpuDevice | None:
        for dev in self.list_devices():
            if dev.uuid == uuid:
                return dev
        return None

    def running_pids(self, device: GpuDevice) -> list[int]:
        """PIDs (host view) holding the device node open."""
        return scan_proc_for_device(device.major, device.minor,
                                    path_hint=device.device_path)

    def probe_device(self, device: GpuDevice) -> tuple[bool, str]:
        """(healthy, reason) for one GPU.

        A GPU is dead when its host node vanished, stopped being a
        character device, or changed identity (major:minor moved: the
        driver re-enumerated and this handle now points elsewhere).
        """
        try:
            major, minor, is_char = stat_device_numbers(device.device_path)
        except OSError as exc:
            return False, f"device node stat failed: {exc}"
        if not is_char:
            return False, "device node is no longer a character device"
        if (major, minor) != (device.major, device.minor):
            return False, (f"device identity changed: {major}:{minor} != "
                           f"{device.major}:{device.minor}")
        return True, ""


# --- where a GPU's identity comes from ---


@dataclass(frozen=True)
class GpuIdentity:
    index: int        # NVML index (PCI order)
    minor: int        # the driver's minor number: /dev/nvidia<minor>
    uuid: str         # "GPU-..."
    pci_bus_id: str   # "" where the source cannot say


class CtypesNvml:
    """The NVML calls the backend makes, on ``libnvidia-ml.so.1``
    through ctypes (the original's ``nvml_dl.go`` path; the library that
    ``nvidia-smi`` uses). Tests put a Python object with these methods in
    its place. The library is opened at ``init``, never at import."""

    NVML_SUCCESS = 0
    NVML_ERROR_NOT_SUPPORTED = 3
    # nvmlPciInfo_t (v3): busIdLegacy[16], domain, bus, device,
    # pciDeviceId, pciSubSystemId (unsigned ints), then busId[32].
    _PCI_INFO_SIZE = 16 + 5 * 4 + 32
    _PCI_BUS_ID_AT = 16 + 5 * 4

    def __init__(self, library: str = "libnvidia-ml.so.1"):
        self.library = library
        self._lib = None

    def _check(self, rc: int, what: str) -> None:
        if rc != self.NVML_SUCCESS:
            text = self._lib.nvmlErrorString(rc).decode(errors="replace")
            raise IdentityError(f"NVML {what}: error {rc} ({text})")

    def _handle(self, index: int) -> ctypes.c_void_p:
        handle = ctypes.c_void_p()
        self._check(self._lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)),
                    f"nvmlDeviceGetHandleByIndex({index})")
        return handle

    def init(self) -> None:
        try:
            lib = ctypes.CDLL(self.library)
        except OSError as exc:
            raise IdentityError(f"cannot load {self.library}: {exc}") from exc
        uint_p, handle_p = ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_void_p)
        for name, argtypes in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetCount_v2", [uint_p]),
                ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                ("nvmlDeviceGetMinorNumber", [ctypes.c_void_p, uint_p]),
                ("nvmlDeviceGetUUID", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]),
                ("nvmlDeviceGetPciInfo_v3", [ctypes.c_void_p, ctypes.c_char_p])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.nvmlErrorString.argtypes, lib.nvmlErrorString.restype = [ctypes.c_int], ctypes.c_char_p
        self._lib = lib
        self._check(self._lib.nvmlInit_v2(), "nvmlInit")

    def shutdown(self) -> None:
        self._check(self._lib.nvmlShutdown(), "nvmlShutdown")

    def count(self) -> int:
        n = ctypes.c_uint(0)
        self._check(self._lib.nvmlDeviceGetCount_v2(ctypes.byref(n)),
                    "nvmlDeviceGetCount")
        return n.value

    def minor(self, index: int) -> int:
        m = ctypes.c_uint(0)
        self._check(self._lib.nvmlDeviceGetMinorNumber(
            self._handle(index), ctypes.byref(m)),
            f"nvmlDeviceGetMinorNumber({index})")
        return m.value

    def uuid(self, index: int) -> str:
        buf = ctypes.create_string_buffer(96)
        self._check(self._lib.nvmlDeviceGetUUID(self._handle(index), buf, 96),
                    f"nvmlDeviceGetUUID({index})")
        return buf.value.decode()

    def pci_bus_id(self, index: int) -> str:
        """The PCI bus id, or "" where the driver does not support the
        query (a sandboxed driver may not)."""
        info = ctypes.create_string_buffer(self._PCI_INFO_SIZE)
        rc = self._lib.nvmlDeviceGetPciInfo_v3(self._handle(index), info)
        if rc == self.NVML_ERROR_NOT_SUPPORTED:
            return ""
        self._check(rc, f"nvmlDeviceGetPciInfo({index})")
        raw = info.raw[self._PCI_BUS_ID_AT:self._PCI_BUS_ID_AT + 32]
        return raw.split(b"\0", 1)[0].decode()


class NvmlIdentity:
    """GPUs as NVML reports them, by NVML index."""

    name = "nvml"

    def __init__(self, lib=None, library: str = "libnvidia-ml.so.1"):
        self.lib = lib if lib is not None else CtypesNvml(library)

    def gpus(self) -> list[GpuIdentity]:
        self.lib.init()
        try:
            return [GpuIdentity(index=i, minor=self.lib.minor(i),
                                uuid=self.lib.uuid(i),
                                pci_bus_id=self.lib.pci_bus_id(i))
                    for i in range(self.lib.count())]
        finally:
            self.lib.shutdown()


class ProcfsIdentity:
    """GPUs as the driver's procfs lists them: one directory per PCI
    address under ``/proc/driver/nvidia/gpus``, whose ``information`` file
    holds "GPU UUID" and "Device Minor". procfs has no NVML index; NVML
    numbers GPUs in PCI bus order, so the index is the rank of the address
    in that order."""

    name = "procfs"

    def __init__(self, root: str = "/proc/driver/nvidia/gpus"):
        self.root = root

    def gpus(self) -> list[GpuIdentity]:
        try:
            addresses = sorted(os.listdir(self.root), key=str.lower)
        except OSError as exc:
            raise IdentityError(f"cannot list {self.root}: {exc}") from exc
        out = []
        for index, address in enumerate(addresses):
            path = os.path.join(self.root, address, "information")
            try:
                with open(path) as f:
                    fields = dict(line.split(":", 1) for line in f
                                  if ":" in line)
            except OSError as exc:
                raise IdentityError(f"cannot read {path}: {exc}") from exc
            fields = {k.strip(): v.strip() for k, v in fields.items()}
            try:
                out.append(GpuIdentity(index=index,
                                       minor=int(fields["Device Minor"]),
                                       uuid=fields["GPU UUID"],
                                       pci_bus_id=address))
            except (KeyError, ValueError) as exc:
                raise IdentityError(f"{path}: no {exc}") from exc
        return out


def identity_from_config(cfg):
    if cfg.gpu_identity_source == "nvml":
        return NvmlIdentity(library=cfg.nvml_library)
    if cfg.gpu_identity_source == "procfs":
        return ProcfsIdentity(cfg.nvidia_procfs_dir)
    raise ValueError(f"unknown GPU identity source {cfg.gpu_identity_source!r} "
                     "(want nvml or procfs)")


# --- the host's GPUs ---


@dataclass
class NodeScan:
    """What one look at the device directory found."""

    devices: list[GpuDevice]
    #: nvidiaN nodes tied to no GPU: (name, major, minor, why)
    unbound: list[tuple[str, int, int, str]]
    #: GPUs the identity source lists whose node is not in the directory
    missing: list[GpuIdentity]
    #: companion name -> why it was left out
    absent_companions: dict[str, str]


def _companions(device_dir: str) -> tuple[list[CompanionNode], dict[str, str]]:
    present, absent = [], {}
    for name in COMPANIONS:
        try:
            major, minor, is_char = stat_device_numbers(
                os.path.join(device_dir, name))
        except OSError as exc:
            absent[name] = f"stat failed: {exc.strerror}"
            continue
        if not is_char:
            absent[name] = "not a character device"
        elif (major, minor) == (0, 0):
            absent[name] = "rdev 0:0 names no device"
        else:
            present.append(CompanionNode(name, major, minor))
    return present, absent


class NvidiaDeviceBackend(DeviceBackend):
    """The host's NVIDIA GPUs: ``nvidia[0-9]+`` under ``device_dir``, each
    tied to a GPU of ``identity`` by the minor number stat(2) gives the
    node. Majors and minors come from stat(2); the GPU's UUID, NVML index
    and PCI bus id from ``identity`` (``NvmlIdentity`` or
    ``ProcfsIdentity``). The present companions ride with every GPU."""

    def __init__(self, device_dir: str = "/dev", identity=None):
        self.device_dir = device_dir
        self.identity = identity if identity is not None else NvmlIdentity()

    def scan(self) -> NodeScan:
        gpus = self.identity.gpus()
        by_minor = {g.minor: g for g in gpus}
        companions, absent = _companions(self.device_dir)
        try:
            names = os.listdir(self.device_dir)
        except FileNotFoundError:
            names = []
        nodes = []  # (name, major, minor)
        unbound = []
        for name in sorted(names, key=lambda n: (len(n), n)):
            if not GPU_NODE_RE.match(name):
                continue
            try:
                major, minor, is_char = stat_device_numbers(
                    os.path.join(self.device_dir, name))
            except OSError as exc:
                unbound.append((name, 0, 0, f"stat failed: {exc.strerror}"))
                continue
            if not is_char:
                unbound.append((name, 0, 0, "not a character device"))
            elif minor not in by_minor:
                unbound.append((name, major, minor,
                                f"no GPU has minor {minor}"))
            else:
                nodes.append((name, major, minor))
        devices = []
        for gpu in gpus:
            mine = [n for n in nodes if n[2] == gpu.minor]
            if not mine:
                continue
            # Two nodes with one minor: /dev/nvidia<minor> is the GPU's.
            mine.sort(key=lambda n: n[0] != f"nvidia{gpu.minor}")
            name, major, minor = mine[0]
            unbound.extend((n, ma, mi, f"another node of minor {mi} "
                            f"({name}) is the GPU's") for n, ma, mi in mine[1:])
            devices.append(GpuDevice(
                index=gpu.index, device_path=os.path.join(self.device_dir, name),
                major=major, minor=minor, uuid=gpu.uuid,
                pci_bus_id=gpu.pci_bus_id, companions=list(companions)))
        bound = {d.minor for d in devices}
        missing = [g for g in gpus if g.minor not in bound]
        devices.sort(key=lambda d: d.index)
        return NodeScan(devices, unbound, missing, absent)

    def list_devices(self) -> list[GpuDevice]:
        return self.scan().devices

    def absent_companions(self) -> dict[str, str]:
        return _companions(self.device_dir)[1]


class FakeDeviceBackend(DeviceBackend):
    """A fake GPU inventory over a plain directory (dry runs, tests).

    Layout: <dir>/nvidiaN are the GPU nodes, beside ``nvidiactl``,
    ``nvidia-uvm`` and ``nvidia-uvm-tools``. When the process may mknod,
    they are character devices cloned from /dev/null's rdev, so that the
    whole mount path (grant and mknod into the target) runs for real;
    otherwise regular files whose pseudo major:minor sit in <dir>/meta.json
    (GPU i: 1:(100 + i); the companions 1:200, 1:201, 1:202), so that the
    enumeration runs everywhere. GPU i has the NVML index i and a UUID of
    the real form, "GPU-fa4e0000-0000-0000-0000-<i in 12 hex digits>".
    """

    META = "meta.json"

    def __init__(self, root: str):
        self.root = root

    @staticmethod
    def fake_uuid(index: int) -> str:
        return f"GPU-fa4e0000-0000-0000-0000-{index:012x}"

    @classmethod
    def create(cls, root: str, count: int) -> "FakeDeviceBackend":
        os.makedirs(root, exist_ok=True)
        meta: dict[str, dict] = {}
        null_rdev = None
        try:
            st = os.stat("/dev/null")
            if statmod.S_ISCHR(st.st_mode):
                null_rdev = st.st_rdev
        except OSError:
            pass
        names = [(f"nvidia{i}", 100 + i) for i in range(count)]
        names += [(c, 200 + k) for k, c in enumerate(COMPANIONS)]
        for name, pseudo_minor in names:
            path = os.path.join(root, name)
            if os.path.exists(path):
                continue
            made = False
            if null_rdev is not None:
                try:
                    os.mknod(path, 0o666 | statmod.S_IFCHR, null_rdev)
                    made = True
                except OSError:
                    made = False
            if not made:
                with open(path, "w"):
                    pass
                meta[name] = {"major": 1, "minor": pseudo_minor}
        if meta:
            existing = cls(root)._meta()
            existing.update(meta)
            with open(os.path.join(root, cls.META), "w") as f:
                json.dump(existing, f)
        return cls(root)

    def _meta(self) -> dict:
        path = os.path.join(self.root, self.META)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def _fake_numbers(self, meta: dict, name: str) -> tuple[int, int] | None:
        """(major, minor) of a fake node: stat for character devices, meta
        for regular-file stand-ins; None for a missing node."""
        try:
            major, minor, is_char = stat_device_numbers(
                os.path.join(self.root, name))
        except OSError:
            return None
        if is_char:
            return major, minor
        fake = meta.get(name)
        return None if fake is None else (fake["major"], fake["minor"])

    def _companion_nodes(self, meta: dict) -> list[CompanionNode]:
        out = []
        for name in COMPANIONS:
            numbers = self._fake_numbers(meta, name)
            if numbers is not None:
                out.append(CompanionNode(name, *numbers))
        return out

    def list_devices(self) -> list[GpuDevice]:
        meta = self._meta()
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        companions = self._companion_nodes(meta)
        devices = []
        for name in names:
            m = GPU_NODE_RE.match(name)
            if not m:
                continue
            numbers = self._fake_numbers(meta, name)
            if numbers is None:
                continue
            index = int(m.group(1))
            devices.append(GpuDevice(
                index=index, device_path=os.path.join(self.root, name),
                major=numbers[0], minor=numbers[1],
                uuid=self.fake_uuid(index), companions=list(companions)))
        devices.sort(key=lambda d: d.index)
        return devices

    def absent_companions(self) -> dict[str, str]:
        meta = self._meta()
        return {name: "no fake node" for name in COMPANIONS
                if self._fake_numbers(meta, name) is None}

    def running_pids(self, device: GpuDevice) -> list[int]:
        # Fake nodes cloned from /dev/null share its rdev; an rdev match
        # would report every process holding /dev/null. Match by path only.
        return scan_proc_for_device(None, None, path_hint=device.device_path)

    def mark_dead(self, name: str, dead: bool = True) -> None:
        """Fault injection: flag a fake node (e.g. "nvidia2") dead, so that
        probe_device reports it unhealthy while enumeration still lists it
        (a dead real GPU usually keeps its node)."""
        meta = self._meta()
        meta.setdefault(name, {})["dead"] = dead
        with open(os.path.join(self.root, self.META), "w") as f:
            json.dump(meta, f)

    def probe_device(self, device: GpuDevice) -> tuple[bool, str]:
        if self._meta().get(device.basename, {}).get("dead"):
            return False, "GPU marked dead (fault injection)"
        if not os.path.exists(device.device_path):
            return False, "device node missing"
        return True, ""


def scan_proc_for_device(major: int | None, minor: int | None,
                         path_hint: str = "", proc_root: str = "/proc") -> list[int]:
    """PIDs with an open fd on the given device (by rdev and/or path).

    Matching by st_rdev catches the device whatever path the opener used
    (bind mounts, other mount namespaces); ``path_hint`` matches the fd's
    link target exactly. rdev 0:0 (or None) matches by path only.
    """
    pids: list[int] = []
    want_rdev = None
    if major is not None and minor is not None and (major, minor) != (0, 0):
        want_rdev = os.makedev(major, minor)
    try:
        entries = os.listdir(proc_root)
    except FileNotFoundError:
        return []
    for entry in entries:
        if not entry.isdigit():
            continue
        fd_dir = os.path.join(proc_root, entry, "fd")
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue
        for fd in fds:
            fd_path = os.path.join(fd_dir, fd)
            matched = False
            if want_rdev is not None:
                try:
                    st = os.stat(fd_path)
                    matched = statmod.S_ISCHR(st.st_mode) and st.st_rdev == want_rdev
                except OSError:
                    pass
            if not matched and path_hint:
                try:
                    matched = os.readlink(fd_path) == path_hint
                except OSError:
                    pass
            if matched:
                pids.append(int(entry))
                break
    return pids


def backend_from_config(cfg=None) -> DeviceBackend:
    from gpumounter_tpu_torch.config import Config
    cfg = cfg or Config()
    if cfg.fake_device_dir:
        return FakeDeviceBackend(cfg.fake_device_dir)
    return NvidiaDeviceBackend(cfg.device_dir, identity_from_config(cfg))
