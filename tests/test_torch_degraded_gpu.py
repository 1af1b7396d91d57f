"""The master's store through an API outage on a GPU host:
``entry.degraded_check`` on the live ``NvidiaDeviceBackend`` through the
master over gRPC, phase 15 (a)-(d) of ``chip_smoke.py``: the healthy round
trips through the store, a write partition around a live remove (the writes
and the release deferred, the add refused; healed, the flush), a read
partition around a live add (stale reads, the add refused at the pod read;
healed, the GPU mounted), and the costs. Imports no JAX. These need the
card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_degraded_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import degraded_check, has_cap_mknod
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev

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


def test_degraded_check_on_the_card(cuda, tmpfs_dir, tmp_path):
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the live adds are refused")
    seen = []
    report = degraded_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(), repeats=2,
                            queue_root=str(tmp_path),
                            on_healed=lambda uuids, d: seen.append(gpus_visible_in_dev(d)))
    live = report["live"]
    assert report["fake"] is None and seen == [1]
    assert len(live["healthy"]["add_ms"]) == 2
    assert live["writes"]["deferred"] == 4 and live["writes"]["flush"] == {"applied": 3,
                                                                           "lost_cas": 1}
    assert live["writes"]["refused"][0] == 500 and live["reads"]["refused"][0] == 500
    assert live["reads"]["stale_reads"] == 1 and live["reads"]["worker_calls"] == 0


def test_degraded_check_without_cap_mknod_raises(cuda):
    if has_cap_mknod():
        pytest.skip("this host has CAP_MKNOD: the check runs")
    with pytest.raises(RuntimeError, match="CAP_MKNOD"):
        degraded_check("cuda")
