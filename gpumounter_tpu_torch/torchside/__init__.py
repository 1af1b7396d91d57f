"""The tenant's side of a hot-mount, for a PyTorch process on CUDA.

The control plane puts a GPU's device node and cgroup grant into a running
pod; the tenant's process then has to see the device and carry its state
onto it. CUDA enumerates devices once per process, at its first
initialisation (``cuInit``), and reads ``CUDA_VISIBLE_DEVICES`` only then;
PyTorch caches the count from then on. So a new ``/dev/nvidiaN`` is not
visible to a running process that has touched CUDA, and no in-process
rebuild exists: the tenant packs its state, hands over to a new process
image that sees the new device set (``handoff``: save, then exec, same PID
and container), and the new image waits for the devices and restores.
"""

from gpumounter_tpu_torch.torchside.visibility import (
    gpus_visible_in_dev,
    handoff,
    refresh_devices,
    reinit_distributed,
    set_visibility_env,
    wait_for_gpus,
)
from gpumounter_tpu_torch.torchside.resume import (
    HotResumable,
    load_optimizer_state,
    optimizer_state_tree,
)
from gpumounter_tpu_torch.torchside.heal import (
    chip_replacement,
    watch_chip_replacements,
)
from gpumounter_tpu_torch.torchside.migrate import (
    migration_signal,
    watch_migration,
)
from gpumounter_tpu_torch.torchside.telemetry import (
    TenantTelemetry,
    disruption_marker,
    watch_disruptions,
)

__all__ = [
    "chip_replacement",
    "disruption_marker",
    "gpus_visible_in_dev",
    "handoff",
    "load_optimizer_state",
    "migration_signal",
    "optimizer_state_tree",
    "refresh_devices",
    "reinit_distributed",
    "set_visibility_env",
    "wait_for_gpus",
    "watch_chip_replacements",
    "watch_disruptions",
    "watch_migration",
    "HotResumable",
    "TenantTelemetry",
]
