"""The one-node hot-mount on a GPU host: the live ``NvidiaDeviceBackend``
and the worker's flows over it (steps 1-3 of ``chip_smoke.py``'s phase 10,
without the tenant child). Imports no JAX. These need the card and skip
elsewhere. On the card:

    python -m pytest tests/test_torch_mount_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import stat
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.device.backend import NvidiaDeviceBackend
from gpumounter_tpu_torch.entry import (busy_health_check, has_cap_mknod, inventory_check,
                                        make_identity, mount_check, pick_identity)
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its driver's /dev/nvidia* nodes")
    torch.zeros(1, device="cuda")  # this process now holds the GPU open
    return torch.device("cuda")


@pytest.fixture
def tmpfs_dir():
    """A directory on a tmpfs, as a container's /dev is (the checkout's
    filesystem may refuse device nodes)."""
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm tmpfs for the target directory")
    path = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_inventory_matches_nvidia_smi_and_stat(cuda):
    inv = inventory_check(pick_identity())
    scan = inv["scan"]
    assert len(scan.devices) == torch.cuda.device_count() and not scan.missing
    for dev in scan.devices:
        assert dev.uuid.startswith("GPU-")
        assert stat.S_ISCHR(os.stat(dev.device_path).st_mode)
    # Every nvidia[0-9]+ node is a GPU's or is reported as no device.
    nodes = {n for n in os.listdir("/dev") if n.startswith("nvidia") and n[6:].isdigit()}
    assert nodes == {d.basename for d in scan.devices} | {u[0] for u in scan.unbound}


def test_this_process_holds_the_gpu_and_it_is_healthy(cuda):
    identity = pick_identity()
    scan = inventory_check(identity)["scan"]
    backend = NvidiaDeviceBackend("/dev", make_identity(identity))
    report = busy_health_check(backend, scan.devices[0])
    assert os.getpid() in report["holders"] and report["scan_ms"] > 0


def test_add_then_remove_on_the_live_backend(cuda, tmpfs_dir, tmp_path):
    # The target's cgroup: a stand-in directory of the v1 files, with no
    # process in it. This process holds the GPU open; with no cgroup the
    # bare target would count it as a holder, and remove_gpu would answer
    # GPUBusy.
    cgroup = tmp_path / "cgroup"
    cgroup.mkdir()
    for name in ("cgroup.procs", "devices.allow", "devices.deny"):
        (cgroup / name).write_text("")
    seen = []

    def on_mounted(uuids, target):
        seen.append((uuids, gpus_visible_in_dev(target)))

    report = mount_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                         cgroup_dirs=[str(cgroup)], identity=pick_identity(),
                         fake_gpus=2, repeats=1,
                         on_mounted=on_mounted)
    live = report["live"]
    if has_cap_mknod():
        assert live["case"] == "round-trip" and len(live["uuids"]) == 1
        assert seen == [(live["uuids"], 1)]
        assert gpus_visible_in_dev(tmpfs_dir) == 0  # removed again
        rules = (cgroup / "devices.deny").read_text()
        assert rules.startswith("c ") and rules.endswith(" rw")  # the revoke's rule
    else:
        assert live["case"] == "refused" and "CAP_MKNOD" in live["refusal"]
        assert seen == []
    assert report["fake"][2]["case"] == "round-trip"
