"""cgroup-v1 device controller: devices.allow / devices.deny writes.

The counterpart of ``gpumounter_tpu/cgroup/v1.py``, and of the original's
AddGPUDevicePermission / RemoveGPUDevicePermission (cgroup.go:143-169),
which run ``sh -c "echo 'c 195:<minor> rw' > .../devices.allow|deny"``
with major 195 written in. Here: direct file writes, no shell, and the
major:minor that stat(2) gave the node.
"""

from __future__ import annotations

import os

from gpumounter_tpu_torch.device.gpu import DEVICE_CGROUP_PERMISSION, GpuDevice
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("cgroup.v1")


class CgroupError(RuntimeError):
    pass


class V1DeviceController:
    """Grant/revoke char-device access on a v1 ``devices`` controller dir."""

    def __init__(self, permission: str = DEVICE_CGROUP_PERMISSION):
        self.permission = permission

    def rule(self, major: int, minor: int) -> str:
        return f"c {major}:{minor} {self.permission}"

    def _write(self, cgroup_dir: str, filename: str, rule: str) -> None:
        path = os.path.join(cgroup_dir, filename)
        try:
            with open(path, "w") as f:
                f.write(rule)
        except OSError as exc:
            raise CgroupError(f"write {rule!r} to {path}: {exc}") from exc
        logger.debug("cgroup v1: %s <- %r", path, rule)

    def grant(self, cgroup_dir: str, dev: GpuDevice) -> None:
        self._write(cgroup_dir, "devices.allow", self.rule(dev.major, dev.minor))
        for comp in dev.companions:
            self._write(cgroup_dir, "devices.allow", self.rule(comp.major, comp.minor))

    def revoke(self, cgroup_dir: str, dev: GpuDevice) -> None:
        # Only the GPU's node is denied. The companions stay allowed: other
        # GPUs still mounted need them, and alone they grant no GPU.
        self._write(cgroup_dir, "devices.deny", self.rule(dev.major, dev.minor))
