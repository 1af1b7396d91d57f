"""Device-node operations inside a container's mount namespace.

The counterpart of ``gpumounter_tpu/nsutil/ns.py``, and of the original's
``pkg/util/namespace/namespace.go``, which runs ``nsenter --target PID
--mount sh -c "mknod -m 666 /dev/nvidiaN c 195 N"`` (:167-177), ``rm``
(:179-189) and ``kill`` (:191-201), and so needs ``sh`` and ``mknod`` inside
the target container. As the reference runs its C++ helper
(``tpumounter-nsexec``), this module runs ``nsutil/nsexec.py`` in a fresh
interpreter (``python -I -S``, the standard library only) through
``subprocess``: it enters the target's mount namespace with setns(2) and
makes the syscalls (mkdir, mknod, chmod, unlink, stat), so the container
needs no binaries and nothing needs a build. The worker never forks
without an exec: a forked copy of a process that serves gRPC runs grpcio's
fork handlers, which abort it (seen on the card's machine), and a copy of a
process with CUDA open costs its pages.

Two modes:
  * pid=None: a plain directory in our own namespace (dry runs, tests);
  * pid=N: the mount namespace of PID N.
"""
from __future__ import annotations

import json
import os
import shutil
import signal as signalmod
import stat as statmod
import subprocess
import sys

from gpumounter_tpu_torch.device.gpu import DEVICE_FILE_MODE, GpuDevice
from gpumounter_tpu_torch.nsutil import nsexec
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("nsutil")


class NamespaceError(RuntimeError):
    pass


def _mount_ns_path(pid: int) -> str:
    return f"/proc/{pid}/ns/mnt"


def _helper_argv(ns_path: str, ops: list) -> list[str]:
    return [sys.executable, "-I", "-S", nsexec.__file__, ns_path, json.dumps(ops)]


def run_in_mount_ns(pid: int, ops: list) -> list:
    """Run `ops` (``nsexec``'s: mknod, unlink, missing) in the mount
    namespace of PID `pid`, in the helper's process; returns each op's
    result. An OSError of an op is raised here with its errno, message and
    file; a failure to enter the namespace, or any other failure, raises
    NamespaceError."""
    proc = subprocess.run(_helper_argv(_mount_ns_path(pid), ops), capture_output=True,
                          text=True, timeout=60)
    try:
        report = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        raise NamespaceError(f"in the mount namespace of PID {pid}: the helper exited "
                             f"{proc.returncode}: {proc.stderr.strip()[-2000:]}") from None
    if proc.returncode == 0 and "results" in report:
        return report["results"]
    if report.get("stage") == "enter":
        raise NamespaceError(f"in the mount namespace of PID {pid}: cannot enter the mount "
                             f"namespace: {report['message']}")
    if report.get("errno", -1) > 0:
        raise OSError(report["errno"], report["strerror"], report["filename"] or None)
    raise NamespaceError(f"in the mount namespace of PID {pid}: {report.get('message')}")


def device_node_path(dev_dir: str, dev: GpuDevice) -> str:
    return os.path.join(dev_dir, dev.basename)


def device_node_exists(path: str, pid: int | None = None) -> bool:
    """Whether the node exists: in the mount namespace of `pid` when given
    (the helper's "missing" op), else in ours. The worker's ProbeGPU asks it
    of a GPU's node in the target's /dev."""
    if pid is None:
        return os.path.exists(path)
    return not run_in_mount_ns(pid, [["missing", [path]]])[0]


def _mknod_here(target_path: str, major: int, minor: int) -> None:
    """Create one char device node, parents included; idempotent."""
    nsexec.mknod_here(target_path, major, minor, DEVICE_FILE_MODE)


def _refusal(target_path, major, minor, source_path, exc) -> NamespaceError:
    return NamespaceError(
        f"mknod {target_path} c {major}:{minor} failed ({exc}) and "
        f"{source_path or 'the source'} is a real device; run the worker with "
        "CAP_MKNOD")


def _mknod_at(target_path: str, major: int, minor: int, source_path: str = "") -> None:
    """Create one char device node in our own namespace (idempotent)."""
    try:
        _mknod_here(target_path, major, minor)
    except OSError as exc:
        # Unprivileged dry runs, fake devices only: a copy of a real GPU's
        # node would read from the device and give a useless regular file,
        # so a real device fails loudly.
        if not (source_path and _is_fake_source(source_path)):
            raise _refusal(target_path, major, minor, source_path, exc) from exc
        logger.debug("mknod unavailable (%s); copying the fake node", exc)
        shutil.copyfile(source_path, target_path)
        os.chmod(target_path, DEVICE_FILE_MODE)


def _is_fake_source(path: str) -> bool:
    """True if `path` is safe to copy: a regular file or a /dev/null clone."""
    try:
        st = os.stat(path)
    except OSError:
        return False
    if statmod.S_ISREG(st.st_mode):
        return True
    if statmod.S_ISCHR(st.st_mode):
        try:
            return st.st_rdev == os.stat("/dev/null").st_rdev
        except OSError:
            return False
    return False


def _node_plan(target_dev_dir: str, devices: list[GpuDevice]) -> list[tuple]:
    """(target path, major, minor, source path) of each GPU's node, then of
    its companions, each companion once."""
    plan, seen = [], set()
    for dev in devices:
        plan.append((device_node_path(target_dev_dir, dev), dev.major, dev.minor,
                     dev.device_path))
        source_root = os.path.dirname(dev.device_path)
        for comp in dev.companions:
            path = os.path.join(target_dev_dir, comp.rel_path)
            if path not in seen:
                seen.add(path)
                plan.append((path, comp.major, comp.minor,
                             os.path.join(source_root, comp.rel_path)))
    return plan


def inject_device_files(target_dev_dir: str, devices: list[GpuDevice],
                        pid: int | None = None) -> list[str]:
    """Create the GPUs' nodes and their companions inside the target
    (AddGPUDeviceFile, namespace.go:167-177; the reference's
    ``inject_device_file`` a GPU at a time), then look for the GPUs'
    nodes where the tenant will: all in one entry into the namespace of
    `pid` when given. Returns the GPU nodes that are not there (a mknod
    into a namespace being torn down)."""
    plan = _node_plan(target_dev_dir, devices)
    gpu_paths = [device_node_path(target_dev_dir, dev) for dev in devices]
    if pid is None:
        for path, major, minor, source in plan:
            _mknod_at(path, major, minor, source_path=source)
        return [p for p in gpu_paths if not os.path.exists(p)]

    ops = [["mknod", path, major, minor, DEVICE_FILE_MODE] for path, major, minor, _ in plan]
    try:
        results = run_in_mount_ns(pid, ops + [["missing", gpu_paths]])
    except OSError as exc:
        node = next((n for n in plan if n[0] == exc.filename), plan[0])
        raise _refusal(node[0], node[1], node[2], node[3], exc) from exc
    return results[-1]


def remove_device_files(target_dev_dir: str, devices: list[GpuDevice],
                        pid: int | None = None) -> None:
    """Remove the GPUs' nodes (RemoveGPUDeviceFile, namespace.go:179-189;
    the reference's ``remove_device_file`` a GPU at a time), in order and
    all in one entry into the namespace of `pid` when given. A node already
    gone is fine. A failure raises OSError naming its file: the nodes
    before it are gone, it and those after are not.

    The companions stay: other GPUs still mounted need them, and they
    grant no GPU once the GPU's node and its cgroup rule are gone."""
    paths = [device_node_path(target_dev_dir, dev) for dev in devices]
    if pid is None:
        for path in paths:
            nsexec.unlink_here(path)
    elif paths:
        run_in_mount_ns(pid, [["unlink", path] for path in paths])


def scan_container_dev_nodes(pid: int | None, dev_dir: str = "/dev",
                             max_nodes: int = 256, max_depth: int = 3,
                             ) -> list[tuple[str, int, int, int]]:
    """(rel_path, major, minor, mode) of every char-device node in the
    target's /dev tree, read through /proc/<pid>/root for a live container
    (no namespace entry needed): the devices the container was started
    with."""
    root = (os.path.join(f"/proc/{pid}/root", dev_dir.lstrip("/"))
            if pid is not None else dev_dir)
    nodes: list[tuple[str, int, int, int]] = []
    base_depth = root.rstrip("/").count("/")
    for dirpath, dirnames, filenames in os.walk(root):
        if dirpath.rstrip("/").count("/") - base_depth >= max_depth:
            dirnames[:] = []
        for name in filenames:
            full = os.path.join(dirpath, name)
            try:
                st = os.lstat(full)
            except OSError:
                continue
            if not statmod.S_ISCHR(st.st_mode):
                continue
            nodes.append((os.path.relpath(full, root), os.major(st.st_rdev),
                          os.minor(st.st_rdev), st.st_mode))
            if len(nodes) >= max_nodes:
                logger.warning("container %s has > %d device nodes; scan truncated",
                               root, max_nodes)
                return nodes
    return nodes


def kill_pids_in_ns(pids: list[int], pid: int | None = None,
                    signal_num: int = signalmod.SIGKILL) -> None:
    """Kill device-holding PIDs (KillRunningGPUProcesses,
    namespace.go:191-201). The PIDs are host-view (the worker runs with
    hostPID), so the kill needs no namespace entry; `pid` names the
    target for the log only."""
    for p in pids:
        try:
            os.kill(p, signal_num)
        except ProcessLookupError:
            pass
    if pids:
        logger.info("killed %s (holders in the target of PID %s)", pids, pid)
