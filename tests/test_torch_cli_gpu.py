"""The operator's verbs against the live stack on a GPU host:
``entry.cli_check`` on the live ``NvidiaDeviceBackend``, phase 22 of
``chip_smoke.py`` without its tenant child: each verb ``python -m
gpumounter_tpu_torch.cli`` in a process of its own, `devices` naming CUDA's
UUID with this process among its holders, `add` mounting the card's GPU,
every exit code the expected one. Imports no JAX. It needs the card and
skips elsewhere. On the card:

    python -m pytest tests/test_torch_cli_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import cli_check, has_cap_mknod
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev

pytestmark = pytest.mark.gpu


@pytest.fixture
def tmpfs_dir():
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm tmpfs for the target directory")
    path = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_cli_check_on_the_card(tmpfs_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its /dev/nvidia* nodes")
    torch.ones(1, device="cuda")  # this process holds the card, as the script does
    identity = "procfs" if os.path.isdir("/proc/driver/nvidia/gpus") else "nvml"
    seen = []
    report = cli_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(), identity=identity,
                       repeats=2, on_mounted=lambda uuids, target: seen.append(
                           gpus_visible_in_dev(target)))
    c = report["live"]
    assert report["fake"] is None
    assert c["devices"]["uuid"] == f"GPU-{torch.cuda.get_device_properties(0).uuid}"
    assert os.getpid() in c["devices"]["holder_pids"] and c["devices"]["major"] == 195
    assert (c["probe"]["gpus"], c["probe"]["identity_source"]) == (1, identity)
    if has_cap_mknod():
        assert seen == [1] and len(c["uuids"]) == 1 and c["refusal"] is None
        assert c["capacity"]["fleet"]["held"] == 1
    else:
        assert "CAP_MKNOD" in c["refusal"] and seen == []


def test_cli_check_refuses_the_card_without_a_gpu_host():
    """On a host without CUDA the entry point raises, and never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_check("cuda")
