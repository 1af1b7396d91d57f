"""Container cgroup path resolution (kubelet naming, both drivers).

The counterpart of ``gpumounter_tpu/cgroup/naming.py``, and of the
original's ``pkg/util/cgroup/cgroup.go``:
  * CgroupName components -> systemd slice/scope (ToSystemd via runc's
    ExpandSlice, cgroup.go:52-68) or the cgroupfs form (ToCgroupfs, :74-76);
  * pod path = kubepods[/<qos>]/pod<UID>/<containerID> (:86-113);
  * the kubelet's QoS classification (GetPodQOS, :177-237);
  * the driver from CGROUP_DRIVER in {systemd, cgroupfs} (:78-84), or
    sniffed from the filesystem;
  * PIDs from cgroup.procs (:120-141).

The runtime leaf covers containerd (``cri-containerd-<id>.scope``) and
cri-o besides docker (``docker-<id>.scope``, which the original assumes);
the API server's ``status.qosClass`` is preferred when the pod has one.
"""

from __future__ import annotations

import os

from gpumounter_tpu_torch.k8s.types import Pod

# Runtime prefix -> systemd scope prefix. The original hardcodes "docker-"
# (cgroup.go:106); GKE uses containerd.
_RUNTIME_SCOPE_PREFIX = {
    "docker": "docker-",
    "containerd": "cri-containerd-",
    "cri-o": "crio-",
    "": "",
}

SUPPORTED_QOS = ("Guaranteed", "Burstable", "BestEffort")


def detect_cgroup_version(cgroup_root: str = "/sys/fs/cgroup") -> int:
    """2 iff the root is a unified (cgroup2) hierarchy."""
    return 2 if os.path.exists(os.path.join(cgroup_root, "cgroup.controllers")) else 1


def detect_cgroup_driver(cgroup_root: str = "/sys/fs/cgroup") -> str:
    """Best-effort sniff: kubelet's systemd driver creates kubepods.slice.

    The original requires the env var (cgroup.go:78-84 errors on anything
    else); we sniff when CGROUP_DRIVER=auto.
    """
    version = detect_cgroup_version(cgroup_root)
    probe_dirs = [cgroup_root] if version == 2 else [
        os.path.join(cgroup_root, c) for c in ("cpu", "memory", "devices")]
    for d in probe_dirs:
        if os.path.isdir(os.path.join(d, "kubepods.slice")):
            return "systemd"
        if os.path.isdir(os.path.join(d, "kubepods")):
            return "cgroupfs"
    return "systemd"  # modern default (GKE, kubeadm ≥1.22)


def pod_qos_class(pod: Pod) -> str:
    """QoS class; API-server value preferred, kubelet derivation fallback.

    GetPodQOS (cgroup.go:177-237), a copy of the kubelet's
    algorithm over requests/limits of cpu+memory.
    """
    if pod.qos_class in SUPPORTED_QOS:
        return pod.qos_class
    has_any = False
    guaranteed = bool(pod.containers)
    for c in pod.containers:
        res = c.get("resources") or {}
        creq = {k: str(v) for k, v in (res.get("requests") or {}).items()
                if k in ("cpu", "memory")}
        clim = {k: str(v) for k, v in (res.get("limits") or {}).items()
                if k in ("cpu", "memory")}
        if creq or clim:
            has_any = True
        # Guaranteed: every container has cpu+memory limits, and any
        # specified request equals its limit.
        if set(clim) != {"cpu", "memory"}:
            guaranteed = False
        for name, val in creq.items():
            if clim.get(name) != val:
                guaranteed = False
    if not has_any:
        return "BestEffort"
    if guaranteed:
        return "Guaranteed"
    return "Burstable"


def _systemd_escape_uid(uid: str) -> str:
    # kubelet: pod UID dashes become underscores in systemd unit names.
    return uid.replace("-", "_")


def expand_slice(slice_name: str) -> str:
    """systemd slice name → nested path (runc ExpandSlice, used at
    cgroup.go:59-63). "kubepods-burstable-podX.slice" →
    "kubepods.slice/kubepods-burstable.slice/kubepods-burstable-podX.slice".
    """
    if not slice_name.endswith(".slice"):
        raise ValueError(f"not a slice name: {slice_name}")
    if slice_name == "-.slice":
        return ""
    stem = slice_name[:-len(".slice")]
    parts = stem.split("-")
    path = []
    prefix = ""
    for p in parts:
        if not p:
            raise ValueError(f"invalid slice name: {slice_name}")
        prefix = f"{prefix}-{p}" if prefix else p
        path.append(prefix + ".slice")
    return "/".join(path)


def pod_cgroup_relpath(pod: Pod, container_id: str, runtime: str,
                       driver: str) -> str:
    """Container cgroup path relative to the hierarchy root.

    GetCgroupName + driver-specific form (cgroup.go:86-113).
    """
    uid = pod.uid
    if not uid:
        raise ValueError(f"pod {pod.namespace}/{pod.name} has no UID")
    qos = pod_qos_class(pod)
    if driver == "systemd":
        if qos == "Guaranteed":
            slice_name = f"kubepods-pod{_systemd_escape_uid(uid)}.slice"
        else:
            slice_name = (f"kubepods-{qos.lower()}-"
                          f"pod{_systemd_escape_uid(uid)}.slice")
        scope_prefix = _RUNTIME_SCOPE_PREFIX.get(runtime, runtime + "-")
        return f"{expand_slice(slice_name)}/{scope_prefix}{container_id}.scope"
    if driver == "cgroupfs":
        if qos == "Guaranteed":
            return f"kubepods/pod{uid}/{container_id}"
        return f"kubepods/{qos.lower()}/pod{uid}/{container_id}"
    raise ValueError(f"unknown cgroup driver {driver!r} "
                     "(want systemd or cgroupfs)")


def container_cgroup_dir(pod: Pod, container_id: str, runtime: str, *,
                         cgroup_root: str = "/sys/fs/cgroup",
                         driver: str = "auto",
                         version: int | None = None,
                         controller: str = "devices") -> str:
    """Absolute cgroup dir for the container.

    v1: under the named controller hierarchy (the original hardcodes
    /sys/fs/cgroup/devices, cgroup.go:115-118). v2: directly under root.
    """
    if version is None:
        version = detect_cgroup_version(cgroup_root)
    if driver == "auto":
        driver = detect_cgroup_driver(cgroup_root)
    rel = pod_cgroup_relpath(pod, container_id, runtime, driver)
    if version == 2:
        return os.path.join(cgroup_root, rel)
    return os.path.join(cgroup_root, controller, rel)


def get_cgroup_pids(cgroup_dir: str) -> list[int]:
    """PIDs in the cgroup (GetCgroupPIDs, cgroup.go:120-141)."""
    procs = os.path.join(cgroup_dir, "cgroup.procs")
    try:
        with open(procs) as f:
            return [int(line) for line in f.read().split() if line.strip()]
    except FileNotFoundError:
        return []
