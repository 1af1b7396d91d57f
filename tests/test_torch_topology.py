"""The port's GPU topology plan (``gpumounter_tpu_torch/topology.py``).

The counterpart of what the reference's dryrun takes from its TPU slice
table (``master/topology.py``'s ``lookup``): the H100 node holds 8 GPUs
(GKE's a3-highgpu-8g, NVIDIA's HGX H100 8-GPU board), and a mesh puts the
hosts on "data" and a host's GPUs on "model".
"""

from __future__ import annotations

import pytest

from gpumounter_tpu_torch.topology import GpuTopology, TopologyError, lookup


@pytest.mark.parametrize("n, hosts, per_host", [(1, 1, 1), (4, 1, 4), (8, 1, 8), (16, 2, 8),
                                                 (64, 8, 8)])
def test_h100_hosts_hold_eight_gpus(n, hosts, per_host):
    plan = lookup("nvidia-h100-80gb", n)
    assert plan == GpuTopology("nvidia-h100-80gb", hosts, per_host)
    assert plan.total_gpus == n
    assert plan.mesh_shape == (hosts, per_host)
    assert plan.mesh_axes == ("data", "model")


def test_the_dryrun_stretch_is_two_hosts_on_data():
    """The reference's v5litepod-16 stretch, on H100s: 2 hosts of 8."""
    plan = lookup(" NVIDIA-H100-80GB ", 16)
    assert (plan.num_hosts, plan.gpus_per_host, plan.total_gpus) == (2, 8, 16)
    assert dict(zip(plan.mesh_axes, plan.mesh_shape)) == {"data": 2, "model": 8}


@pytest.mark.parametrize("n", [12, 20, 9, 0, -8])
def test_a_count_that_is_not_whole_hosts_is_refused_naming_it(n):
    with pytest.raises(TopologyError, match=rf"^{n} GPUs of nvidia-h100-80gb"):
        lookup("nvidia-h100-80gb", n)


def test_an_unknown_accelerator_is_refused():
    with pytest.raises(TopologyError, match="unknown accelerator type 'tpu-v5-lite-podslice'"):
        lookup("tpu-v5-lite-podslice", 16)
    assert issubclass(TopologyError, ValueError)
