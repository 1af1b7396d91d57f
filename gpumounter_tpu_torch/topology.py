"""GPU topology: an accelerator type and a GPU count → hosts of GPUs.

The counterpart of what the reference's multichip dryrun takes from its TPU
slice table (``SliceTopology``, ``lookup``): how many hosts a job spans and
how many accelerators each holds, so that a mesh puts the hosts on "data"
and the accelerators of a host on "model", where tensor parallelism's
per-block reductions stay on the host's fastest links.

A GPU topology is some hosts of ``gpus_per_host`` GPUs each. Inside a host
every pair of GPUs is joined by NVSwitch; between hosts runs the network.
The H100 node, accelerator type ``nvidia-h100-80gb``, holds 8 GPUs. Two
sources define it: GKE's A3 machine type ``a3-highgpu-8g`` (8 H100 80GB a
VM, under the node label ``cloud.google.com/gke-accelerator:
nvidia-h100-80gb``) and NVIDIA's DGX H100 / HGX H100 8-GPU board (8 GPUs on
four NVSwitch chips).
"""

from __future__ import annotations

from dataclasses import dataclass

#: GPUs a host of each accelerator type holds.
GPUS_PER_HOST = {"nvidia-h100-80gb": 8}


class TopologyError(ValueError):
    pass


@dataclass(frozen=True)
class GpuTopology:
    """A job's GPUs laid out on hosts: num_hosts hosts of gpus_per_host."""

    accel_type: str
    num_hosts: int
    gpus_per_host: int

    @property
    def total_gpus(self) -> int:
        return self.num_hosts * self.gpus_per_host

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """(num_hosts, gpus_per_host): hosts on "data", the GPUs of a host
        on "model"."""
        return self.num_hosts, self.gpus_per_host

    @property
    def mesh_axes(self) -> tuple[str, str]:
        return "data", "model"


def lookup(accel_type: str, n_gpus: int) -> GpuTopology:
    """The layout of n_gpus GPUs of `accel_type` (a GKE accelerator label,
    e.g. "nvidia-h100-80gb"): whole hosts, or one host when n_gpus fits in
    one. Raises TopologyError for an unknown type, or a count that is
    neither a whole number of hosts nor fits inside one host."""
    norm = accel_type.strip().lower()
    if norm not in GPUS_PER_HOST:
        raise TopologyError(f"unknown accelerator type {accel_type!r}; one of "
                            f"{sorted(GPUS_PER_HOST)}")
    per_host = GPUS_PER_HOST[norm]
    if n_gpus < 1:
        raise TopologyError(f"{n_gpus} GPUs of {norm}: a job holds at least one")
    if n_gpus <= per_host:
        return GpuTopology(norm, 1, n_gpus)
    if n_gpus % per_host:
        raise TopologyError(f"{n_gpus} GPUs of {norm} are not a whole number of hosts of "
                            f"{per_host}")
    return GpuTopology(norm, n_gpus // per_host, per_host)
