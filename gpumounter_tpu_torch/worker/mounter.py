"""Mount mechanics: the hot-plug of a GPU into a running container.

The counterpart of ``TpuMounter`` in ``gpumounter_tpu/worker/mounter.py``,
and of the original's ``pkg/util/util.go``:

  * ``mount_many`` (MountGPU, util.go:17-71): container -> cgroup path ->
    device permission -> first cgroup PID -> mknod in its namespace;
  * ``unmount`` (UnmountGPU, util.go:73-150): busy gate unless forced ->
    revoke -> remove the node -> kill the holders when forced;
  * ``holder_pids`` (GetPodGPUProcesses, util.go:152-196): cgroup PIDs
    that hold the device;
  * ``can_mount`` (CanMount, util.go:207-226).

Every container of the pod is handled, with docker and containerd IDs;
the batch is granted first, then injected, and a failure anywhere undoes
the whole batch. A ``MountTarget`` can also be a plain directory with no
cgroup or namespace, for dry runs. cgroup v2 needs the eBPF controller,
which is not here yet: a container target on a v2 host raises MountError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gpumounter_tpu_torch.allocator.allocator import MountType
from gpumounter_tpu_torch.cgroup import (
    V2_MISSING,
    V1DeviceController,
    container_cgroup_dir,
    detect_cgroup_driver,
    detect_cgroup_version,
    get_cgroup_pids,
)
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import DeviceBackend, scan_proc_for_device
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.nsutil import ns as nsutil
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.timing import PhaseTimer

logger = get_logger("mounter")


class MountError(RuntimeError):
    pass


class GpuBusyError(MountError):
    """The GPU has live holder processes and force was not set."""


@dataclass
class MountTarget:
    """Where a GPU lands: a container (cgroup + namespace) or a bare dir."""

    dev_dir: str = "/dev"            # device dir in the target's mount ns
    cgroup_dirs: list[str] = field(default_factory=list)
    ns_pid: int | None = None        # PID whose mount namespace we enter; None = ours
    description: str = "local"
    pod: Pod | None = None

    @property
    def has_cgroup(self) -> bool:
        return bool(self.cgroup_dirs)


class GpuMounter:
    def __init__(self, backend: DeviceBackend, cfg=None):
        self.cfg = cfg or Config()
        self.backend = backend
        version = self.cfg.cgroup_version
        self.cgroup_version = (detect_cgroup_version(self.cfg.cgroup_root)
                               if version == "auto" else int(version))
        self.controller = V1DeviceController()

    # --- target resolution (util.go:22-50) ---

    def resolve_target(self, pod: Pod) -> MountTarget:
        ids = pod.container_ids()
        if not ids:
            raise MountError(f"pod {pod.namespace}/{pod.name} has no running containers")
        driver = self.cfg.cgroup_driver
        if driver == "auto":
            driver = detect_cgroup_driver(self.cfg.cgroup_root)
        cgroup_dirs = [container_cgroup_dir(pod, cid, runtime,
                                            cgroup_root=self.cfg.cgroup_root,
                                            driver=driver, version=self.cgroup_version)
                       for _, runtime, cid in ids]
        ns_pid = None
        for cg in cgroup_dirs:
            pids = get_cgroup_pids(cg)
            if pids:
                ns_pid = pids[0]
                break
        if ns_pid is None:
            raise MountError(f"no PIDs found in cgroups of {pod.namespace}/{pod.name} "
                             f"(looked in {cgroup_dirs})")
        return MountTarget(dev_dir="/dev", cgroup_dirs=cgroup_dirs, ns_pid=ns_pid,
                           description=f"{pod.namespace}/{pod.name}", pod=pod)

    # --- busy detection (GetPodGPUProcesses, util.go:152-196) ---

    def holder_pids(self, target: MountTarget, dev: GpuDevice) -> list[int]:
        holders = set(self.backend.running_pids(dev))
        # Holders of the target-side node when it is a distinct path (fake
        # dirs, bind-mounted /dev). For a real GPU the rdev scan already
        # covers every alias.
        injected = nsutil.device_node_path(target.dev_dir, dev)
        if injected != dev.device_path:
            holders.update(scan_proc_for_device(None, None, path_hint=injected))
        if not target.has_cgroup:
            return sorted(holders)
        cgroup_pids: set[int] = set()
        for cg in target.cgroup_dirs:
            cgroup_pids.update(get_cgroup_pids(cg))
        return sorted(p for p in holders if p in cgroup_pids)

    # --- policy gate (CanMount, util.go:207-226) ---

    @staticmethod
    def can_mount(mount_type: MountType, is_entire_mount: bool) -> tuple[bool, str]:
        if mount_type == MountType.UNKNOWN:
            return False, "mount type of pod is unknown; refusing"
        if mount_type == MountType.ENTIRE:
            return False, "pod already holds an entire-mount; no further mounts"
        if mount_type == MountType.SINGLE and is_entire_mount:
            return False, "pod holds single-mounts; entire-mount not allowed"
        return True, ""

    # --- mount (MountGPU, util.go:17-71) ---

    def _check_grantable(self, target: MountTarget) -> None:
        if target.has_cgroup and self.cgroup_version == 2:
            raise MountError(f"{target.description}: {V2_MISSING}")

    def mount_many(self, target: MountTarget, devices: list[GpuDevice]) -> dict:
        """Grant, then inject, a batch of GPUs, all or nothing: a failure
        revokes every rule granted and removes every node injected, then
        raises MountError. Returns the phase timings (ms)."""
        if not devices:
            return {}
        self._check_grantable(target)
        timer = PhaseTimer()
        granted: list[tuple[str, GpuDevice]] = []
        injected: list[GpuDevice] = []
        uuids = ",".join(d.uuid for d in devices)
        try:
            with timer.phase("cgroup_grant"):
                for cg in target.cgroup_dirs:
                    for dev in devices:
                        self.controller.grant(cg, dev)
                        granted.append((cg, dev))
            with timer.phase("device_inject"):
                injected.extend(devices)  # before: a half-made batch is undone too
                missing = nsutil.inject_device_files(target.dev_dir, devices,
                                                     pid=target.ns_pid)
                if missing:
                    raise MountError(f"injected node(s) {missing} not visible in "
                                     f"{target.description} after mknod")
        except Exception as exc:
            self._rollback_batch(target, granted, injected)
            if isinstance(exc, MountError):
                raise
            # One type for every lower-layer failure (CgroupError,
            # NamespaceError, OSError), so that the caller's rollback of the
            # scheduler's books fires on one exception type.
            raise MountError(f"mount of {uuids} into {target.description}: {exc}") from exc
        summary = timer.summary_ms()
        logger.info("mounted %d GPU(s) [%s] into %s (%s)", len(devices), uuids,
                    target.description, summary)
        return summary

    def _rollback_batch(self, target: MountTarget,
                        granted: list[tuple[str, GpuDevice]],
                        injected: list[GpuDevice]) -> None:
        """Undo a failed batch: kill whatever opened an injected node in the
        meantime (a revoke only gates later opens), remove the nodes,
        revoke the rules. Each undo step that fails is logged and the rest
        still run; the caller raises the failure that started it."""
        holders: set[int] = set()
        for dev in injected:
            try:
                holders.update(self.holder_pids(target, dev))
            except Exception as exc:  # noqa: BLE001 — the undo goes on
                logger.error("rollback holder scan of %s failed: %s", dev.uuid, exc)
        for dev in injected:
            try:
                nsutil.remove_device_file(target.dev_dir, dev, pid=target.ns_pid)
            except Exception as exc:  # noqa: BLE001 — the undo goes on
                logger.error("rollback node removal of %s failed: %s", dev.uuid, exc)
        for cg, dev in granted:
            try:
                self.controller.revoke(cg, dev)
            except Exception as exc:  # noqa: BLE001 — the undo goes on
                logger.error("grant rollback of %s on %s failed: %s; the container "
                             "keeps kernel access to the GPU", dev.uuid, cg, exc)
        if holders:
            logger.warning("rollback killing %d holder PID(s): %s", len(holders),
                           sorted(holders))
            nsutil.kill_pids_in_ns(sorted(holders), pid=target.ns_pid)

    # --- unmount (UnmountGPU, util.go:73-150) ---

    def unmount(self, target: MountTarget, dev: GpuDevice, force: bool = False) -> dict:
        timer = PhaseTimer()
        with timer.phase("busy_check"):
            holders = self.holder_pids(target, dev)
        if holders and not force:
            raise GpuBusyError(f"{dev.device_path} held by PIDs {holders} in "
                               f"{target.description}; use force")
        self._check_grantable(target)
        try:
            with timer.phase("cgroup_revoke"):
                for cg in target.cgroup_dirs:
                    self.controller.revoke(cg, dev)
            with timer.phase("device_remove"):
                nsutil.remove_device_file(target.dev_dir, dev, pid=target.ns_pid)
            if force and holders:
                with timer.phase("kill_holders"):
                    nsutil.kill_pids_in_ns(holders, pid=target.ns_pid)
        except MountError:
            raise
        except Exception as exc:
            raise MountError(f"unmount of {dev.uuid} from {target.description}: "
                             f"{exc}") from exc
        summary = timer.summary_ms()
        logger.info("unmounted %s from %s (%s)", dev, target.description, summary)
        return summary

