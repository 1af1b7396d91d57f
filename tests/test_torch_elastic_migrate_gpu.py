"""The elastic controller and the live migration on a GPU host:
``entry.elastic_migrate_check`` on the live ``NvidiaDeviceBackend`` through
the master over gRPC, phase 19 (a)-(c) of ``chip_smoke.py``: an intent
converged and healed over ProbeGPU, a tenant process at each end of a
migration with the checkpoint (its logits' sha256 equal after the restore),
and a rollback. Imports no JAX. It needs the card and skips elsewhere. On
the card:

    python -m pytest tests/test_torch_elastic_migrate_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import MIGRATE_TENANT_CPU, elastic_migrate_check, has_cap_mknod

pytestmark = pytest.mark.gpu

#: the tenants' model on the card: the CPU check's at a head dim flash_fwd
#: takes (32), its tokens on the GPU
TENANT = {"model": dict(MIGRATE_TENANT_CPU["model"], d_model=128, max_len=256),
          "tokens": [2, 256]}


@pytest.fixture
def tmpfs_dir():
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm tmpfs for the target directory")
    path = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_elastic_migrate_check_on_the_card(tmpfs_dir, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its /dev/nvidia* nodes")
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the heal's and the migration's adds are refused")
    report = elastic_migrate_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                                   ledger_root=str(tmp_path), tenant=TENANT)
    f = report["live"]
    assert report["fake"] is None
    assert f["heal"]["outcome"]["healed"] == 1 and f["heal"]["marker"]["generation"] == 1
    m = f["migration"]
    assert m["source"]["sha256"] == m["destination"]["sha256"]
    assert m["launches"] == 2 * TENANT["model"]["n_layers"]
    assert f["rollback"]["books"]["tenant-destination"] == [f["heal"]["uuid"]]
    assert (f["defrag"]["status"], f["defrag"]["moves"]) == ("completed", 0)


def test_elastic_migrate_check_refuses_the_card_without_a_gpu_host():
    """On a host without CUDA the entry point raises, and never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        elastic_migrate_check("cuda")
