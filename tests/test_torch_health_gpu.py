"""Health and recovery on a GPU host: ``entry.health_check`` on the live
``NvidiaDeviceBackend`` through the master over gRPC, phase 18 (a)-(c) of
``chip_smoke.py``: the operator's quarantine and the pull's drain of the warm
pool, the canary over ProbeGPU while this process holds the card, the
canary of a vanished node, the scorer's quarantine and rehabilitation over
the mount path's breaker, and a worker's death evacuated by the recovery
controller. Imports no JAX. It needs the card and skips elsewhere. On the
card:

    python -m pytest tests/test_torch_health_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import has_cap_mknod, health_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its /dev/nvidia* nodes")
    torch.zeros(1, device="cuda")  # this process now holds the GPU open
    return torch.device("cuda")


@pytest.fixture
def tmpfs_dir():
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm tmpfs for the target directory")
    path = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_health_check_on_the_card(cuda, tmpfs_dir):
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the canary's adds are refused")
    held = []

    def before_canary():
        """This process works on the card while the canary probes it."""
        x = torch.randn(1024, 1024, device="cuda")
        held.append((x @ x).sum().item())
        return {"held": True}

    report = health_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                          before_canary=before_canary)
    h = report["live"]
    assert report["fake"] is None and held
    chip = h["manual"]["clean"]["probe"]["chips"][0]
    assert chip["healthy"] and chip["holder_count"] >= 1
    lost = h["manual"]["vanished"]["probe"]["chips"][0]
    assert not lost["healthy"] and "injected device node vanished" in lost["reason"]
    assert h["manual"]["drained"] == 1
    assert h["scored"]["states"][:2] == ["suspect", "quarantined"]
    assert h["scored"]["states"][-1] == "healthy"
    assert h["death"]["released"] and "evacuated" in h["death"]["release_refused"]
    assert h["death"]["evacuation_ms"] < 30_000


def test_health_check_refuses_the_card_without_a_gpu_host():
    """On a host without CUDA the entry point raises, and never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        health_check("cuda")
