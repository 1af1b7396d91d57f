"""The autoscaler on a GPU host: ``entry.autoscale_check`` on the live
``NvidiaDeviceBackend`` through the master and the worker over gRPC, phase
21 of ``chip_smoke.py`` with the CPU's stand-in tenant
(``entry.autoscale_tenant_cpu``, its curve known) in place of the tenant
process: the card's GPU mounted and declared, the curve found again from
the four windows the tenant published, the rule's holds on the held GPU,
the pause and the resume. Imports no JAX. It needs the card and skips
elsewhere. On the card:

    python -m pytest tests/test_torch_autoscale_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import (AUTOSCALE_CPU_CURVE, autoscale_check,
                                        autoscale_tenant_cpu, has_cap_mknod)

pytestmark = pytest.mark.gpu


@pytest.fixture
def tmpfs_dir():
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm tmpfs for the target directory")
    path = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_autoscale_check_on_the_card(tmpfs_dir, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its /dev/nvidia* nodes")
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the tenant's add is refused")
    report = autoscale_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                             ledger_root=str(tmp_path), on_mounted=autoscale_tenant_cpu)
    f = report["live"]
    assert report["fake"] is None and len(f["uuids"]) == 1
    assert f["fit"]["verdict"] == "ok" and f["fit"]["samples"] == 4
    assert f["fit"]["r_max"] == pytest.approx(AUTOSCALE_CPU_CURVE["r_max"], rel=1e-9)
    assert [e["reason"] for e in f["evaluate"]] == f["expected"] == ["hysteresis", "infeasible"]
    assert {k: v[0] for k, v in f["pause"].items()} == {
        "pause": 200, "paused": 409, "resume": 200, "resumed": 200}


def test_autoscale_check_refuses_the_card_without_a_gpu_host():
    """On a host without CUDA the entry point raises, and never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autoscale_check("cuda")
