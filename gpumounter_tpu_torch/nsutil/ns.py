"""Device-node operations inside a container's mount namespace.

The counterpart of ``gpumounter_tpu/nsutil/ns.py``, and of the original's
``pkg/util/namespace/namespace.go``, which runs ``nsenter --target PID
--mount sh -c "mknod -m 666 /dev/nvidiaN c 195 N"`` (:167-177), ``rm``
(:179-189) and ``kill`` (:191-201), and so needs ``sh`` and ``mknod`` inside
the target container. The reference enters the namespace with a C++ helper
(``tpumounter-nsexec``); this module needs no build: a forked child enters
the target's mount namespace with setns(2) (``os.setns``), makes the
syscalls (mkdir, mknod, chmod, unlink, stat), and leaves with ``os._exit``.
The child runs nothing else, which keeps a fork from a process with CUDA
and threads safe: it takes no lock another thread may hold.

Two modes:
  * pid=None: a plain directory in our own namespace (dry runs, tests);
  * pid=N: the mount namespace of PID N.
"""

from __future__ import annotations

import os
import shutil
import signal as signalmod
import stat as statmod
import warnings

from gpumounter_tpu_torch.device.gpu import DEVICE_FILE_MODE, GpuDevice
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("nsutil")


class NamespaceError(RuntimeError):
    pass


def run_in_mount_ns(pid: int, fn) -> str:
    """Run `fn()` in a forked child that has entered PID `pid`'s mount
    namespace; returns the string `fn` returns. An OSError of `fn` is
    raised here with its errno and message; a failure to enter the
    namespace, or any other failure of `fn`, raises NamespaceError."""
    ns_fd = os.open(f"/proc/{pid}/ns/mnt", os.O_RDONLY | os.O_CLOEXEC)
    try:
        r, w = os.pipe()
        # Python 3.12 warns on fork in a threaded process: the child could
        # block on a lock another thread held. This child only makes
        # syscalls and _exits, so it takes no such lock.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            child = os.fork()
        if child == 0:  # pragma: no cover — runs in the child
            code = 0
            try:
                os.close(r)
                # A fork handler (gRPC's, say) may have started threads in
                # the child that share its filesystem context, and setns
                # into a mount namespace refuses a shared one (EINVAL).
                os.unshare(os.CLONE_FS)
                os.setns(ns_fd, os.CLONE_NEWNS)
            except OSError as exc:
                os.write(w, f"-1\tcannot enter the mount namespace: {exc}\t".encode())
                os._exit(1)
            try:
                os.write(w, (fn() or "").encode())
            except OSError as exc:
                os.write(w, f"{exc.errno}\t{exc.strerror}\t{exc.filename or ''}".encode())
                code = 1
            except BaseException as exc:  # noqa: BLE001 — reported to the parent
                os.write(w, f"-1\t{type(exc).__name__}: {exc}\t".encode())
                code = 1
            os._exit(code)
        os.close(w)
        with os.fdopen(r, "rb") as f:
            report = f.read().decode(errors="replace")
        _, status = os.waitpid(child, 0)
    finally:
        os.close(ns_fd)
    if os.waitstatus_to_exitcode(status) != 0:
        errno_s, _, rest = report.partition("\t")
        message, _, filename = rest.partition("\t")
        if errno_s and int(errno_s) > 0:
            raise OSError(int(errno_s), message, filename or None)
        raise NamespaceError(f"in the mount namespace of PID {pid}: "
                             f"{message or f'child exited with status {status}'}")
    return report


def device_node_path(dev_dir: str, dev: GpuDevice) -> str:
    return os.path.join(dev_dir, dev.basename)


def _mknod_here(target_path: str, major: int, minor: int) -> None:
    """Create one char device node, parents included; idempotent."""
    if os.path.exists(target_path):
        return
    os.makedirs(os.path.dirname(target_path), exist_ok=True)
    try:
        os.mknod(target_path, DEVICE_FILE_MODE | statmod.S_IFCHR,
                 os.makedev(major, minor))
    except FileExistsError:
        return  # two GPUs injecting one companion: the loser is fine
    os.chmod(target_path, DEVICE_FILE_MODE)  # mknod's mode is umask-masked


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

    def make() -> str:
        for path, major, minor, _ in plan:
            _mknod_here(path, major, minor)
        return "\n".join(p for p in gpu_paths if not os.path.exists(p))

    try:
        missing = run_in_mount_ns(pid, make)
    except OSError as exc:
        node = next((n for n in plan if n[0] == exc.filename), plan[0])
        raise _refusal(node[0], node[1], node[2], node[3], exc) from exc
    return missing.split("\n") if missing else []


def remove_device_file(target_dev_dir: str, dev: GpuDevice,
                       pid: int | None = None) -> None:
    """Remove the GPU's node (RemoveGPUDeviceFile, namespace.go:179-189).

    The companions stay: other GPUs still mounted need them, and they
    grant no GPU once the GPU's node and its cgroup rule are gone."""
    target_path = device_node_path(target_dev_dir, dev)

    def unlink() -> None:
        try:
            os.unlink(target_path)
        except FileNotFoundError:
            pass

    if pid is None:
        unlink()
    else:
        run_in_mount_ns(pid, unlink)


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
