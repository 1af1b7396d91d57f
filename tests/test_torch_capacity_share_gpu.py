"""The capacity plane and a metered share on a GPU host:
``entry.capacity_share_check`` on the live ``NvidiaDeviceBackend`` through
the master and the worker over gRPC, phase 20 (a)-(e) of ``chip_smoke.py``:
the card's GPU free in /capacity, booked by POST /shares and mounted by
AddGPU with its share policy (the books, the ledger's share record and the
policy engine's entry agree), held in /capacity, a second add refused with
its ``capacity.reject`` verdict, re-granted on the books alone (the worker
keeps the first weight, as the reference's) and released. Imports no JAX.
It needs the card and skips elsewhere. On the card:

    python -m pytest tests/test_torch_capacity_share_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import (SHARE, SHARE_REGRANT_WEIGHT, capacity_share_check,
                                        has_cap_mknod)

pytestmark = pytest.mark.gpu


@pytest.fixture
def tmpfs_dir():
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm tmpfs for the target directory")
    path = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_capacity_share_check_on_the_card(tmpfs_dir, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its /dev/nvidia* nodes")
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the share's add is refused")
    report = capacity_share_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                                  ledger_root=str(tmp_path))
    f = report["live"]
    assert report["fake"] is None
    assert f["inventory"]["index"] == 0.0 and f["freed"] == f["inventory"]["free"]
    (uuid, books), = f["ledgers"]["books"].items()
    assert books == [SHARE["weight"], SHARE["rate_budget"]]
    assert f["ledgers"]["ledger"] == f["ledgers"]["engine"] == {uuid: books}
    assert f["regrant"] == {"books": {uuid: [SHARE_REGRANT_WEIGHT, SHARE["rate_budget"]]},
                            "ledger": {uuid: books}, "engine": {uuid: books}}
    assert f["rejection"]["cause"] == "exhaustion"


def test_capacity_share_check_refuses_the_card_without_a_gpu_host():
    """On a host without CUDA the entry point raises, and never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        capacity_share_check("cuda")
