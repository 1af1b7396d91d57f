"""The fleet planes on a GPU host: ``entry.fleet_check`` on the live
``NvidiaDeviceBackend`` through the master over gRPC, phase 17 (a)-(d) of
``chip_smoke.py``: live adds traced, a tenant publishing to the worker's ops
port while the GPU is mounted, the collection over CollectTelemetry, the
reads under the read token (/fleet, /tenants, /slo, /metrics, the assembled
/trace/<id>), the scopes, and the scrape of a worker without the RPC.
Imports no JAX. These need the card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_fleet_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import fleet_check, has_cap_mknod
from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry
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


def test_fleet_check_on_the_card(cuda, tmpfs_dir):
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the live adds are refused")
    seen = []

    def on_mounted(uuids, dev_dir, url, token):
        """A tenant in this process: two forward-sized steps on the GPU the
        worker mounted, published with the mutate token."""
        seen.append(gpus_visible_in_dev(dev_dir))
        tel = TenantTelemetry("default/fleet-gpu-test", pod="tenant-fleet", token=token)
        x = torch.randn(1024, 1024, device="cuda")
        for _ in range(2):
            with tel.step(tokens=1024.0):
                (x @ x).sum().item()
        assert tel.publish(url)
        return {"tenant": tel.tenant, "steps": 2}

    report = fleet_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(), repeats=2,
                         on_mounted=on_mounted)
    live = report["live"]
    assert report["fake"] is None and seen == [1]
    assert live["node"]["mode"] == "rpc" and live["exemplar"] in live["trace_ids"]
    assert live["tenant_seen"]["steps"] == 2
    assert live["trace"]["remote_spans"] > 0
    assert live["scopes"]["read_on_add"] == live["scopes"]["read_on_tenant_post"] == 401
    assert set(live["scopes"]["no_token"].values()) == {401}
    assert live["scrape"]["mode"] == "scrape" and live["scrape"]["spans"] == 0


def test_fleet_check_without_cap_mknod_raises(cuda):
    if has_cap_mknod():
        pytest.skip("this host has CAP_MKNOD: the check runs")
    with pytest.raises(RuntimeError, match="CAP_MKNOD"):
        fleet_check("cuda")
