"""Tracing, the audit trail and failpoints on a GPU host: ``entry.obs_check``
on the live ``NvidiaDeviceBackend`` through the master over gRPC, phase 13
(a) and (b) of ``chip_smoke.py``: traced round trips of the live GPU (each
request's trace id, its spans and parents, no open span, the audit records
and the timeline under the id, the Events) and the injected faults, each
ending with the GPU addable again. Imports no JAX. These need the card and
skip elsewhere. On the card:

    python -m pytest tests/test_torch_obs_gpu.py -q -m gpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import ADD_TRACE, has_cap_mknod, obs_check
from gpumounter_tpu_torch.obs import trace

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


def _stand_in_cgroup(tmp_path):
    cgroup = tmp_path / "cgroup"
    cgroup.mkdir()
    for name in ("cgroup.procs", "devices.allow", "devices.deny"):
        (cgroup / name).write_text("")
    return [str(cgroup)]


def test_obs_check_on_the_card(cuda, tmpfs_dir, tmp_path):
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the live add is refused: obs_check runs on the fake host")
    report = obs_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                       cgroup_dirs=_stand_in_cgroup(tmp_path), fake_gpus=8, repeats=2)
    live = report["live"]
    assert report["fake"] is None  # every flow ran on the live GPU
    rt = live["round_trip"]
    assert len(rt["trace_ids"]) == len(rt["add_ms"]) == 2
    assert sorted(rt["span_ms"]) == sorted(ADD_TRACE)
    assert rt["events"] == ["GPUMounted", "GPUUnmounted"]
    assert 0 < min(rt["worker_share"]) and max(rt["worker_share"]) <= 1
    ag = live["after_grant"]
    assert ag["status"] == 500 and ag["outcomes"]["http.add"] == ["http 500"]
    # the stand-in's devices.deny, emptied before the fault, holds the
    # rollback's revoke of the GPU's rule
    assert ag["revoke"][0].startswith("the stand-in's devices.deny holds 'c 195:")
    assert live["dropped_call"]["retries"] == 1 and live["dropped_call"]["status"] == 200
    assert live["slice_admission"]["status"] == 500
    assert report["two_gpu_mknod"]["status"] == 500
    assert trace.TRACER.open_spans() == []
    assert report["costs"]["fire_ns"] > 0
