"""Sharded masters and the warm pool on a GPU host: ``entry.shard_pool_check``
on the live ``NvidiaDeviceBackend`` through the master over gRPC, phase 16
(a)-(c) of ``chip_smoke.py``: a pooled live add against a cold one (the
replica's epoch in the worker's ledger), two replicas (the 307 and the
proxied batch), and a stale owner fenced by the worker. Imports no JAX.
These need the card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_shard_pool_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import has_cap_mknod, shard_pool_check
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


def test_shard_pool_check_on_the_card(cuda, tmpfs_dir, tmp_path):
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the live adds are refused")
    seen = []
    report = shard_pool_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(), repeats=2,
                              ledger_root=str(tmp_path),
                              on_pooled=lambda uuids, d: seen.append(gpus_visible_in_dev(d)))
    live = report["live"]
    assert report["fake"] is None and seen == [1]
    assert live["pool"]["epoch"] >= 1 and live["pool"]["ledger_epoch"] == live["pool"]["epoch"]
    assert len(live["pool"]["warm"]) == len(live["pool"]["cold"]) == 2
    assert live["replicas"]["forwarded"] == "NotOwner"
    assert len(live["replicas"]["proxied_ms"]) == 2
    stale = live["stale"]
    assert stale["fresh_epoch"] == stale["stale_epoch"] + 1 == stale["ledger_epoch"]
    assert "fenced by worker" in stale["fenced"]


def test_shard_pool_check_without_cap_mknod_raises(cuda):
    if has_cap_mknod():
        pytest.skip("this host has CAP_MKNOD: the check runs")
    with pytest.raises(RuntimeError, match="CAP_MKNOD"):
        shard_pool_check("cuda")
