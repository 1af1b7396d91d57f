"""The master's flows over HTTP on a GPU host: ``entry.master_check`` on the
live ``NvidiaDeviceBackend``, and a tenant child on the UUID that the HTTP
add mounted, running ``flash_fwd`` (phase 11 of ``chip_smoke.py`` at a small
shape); ``entry.slice_check``'s slice of 1 on the live backend, whose tenant
re-forms its process group from the plan and all-reduces over NCCL. Imports
no JAX. These need the card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_master_gpu.py -q -m gpu
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from gpumounter_tpu_torch.entry import has_cap_mknod, master_check, slice_check
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The tenant: CUDA's device 0 must be the GPU the HTTP add mounted; one
# flash_fwd launch at a small causal shape, against the plain attention.
CHILD = r"""
import json, torch
from gpumounter_tpu_torch.ops.flash_attention import (attention_plain, flash_attention,
                                                      flash_attention_kernel)
torch.cuda.init()
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(1, 4, 256, 64, device="cuda", generator=g, dtype=torch.bfloat16)
           for _ in range(3))
out = flash_attention(q, k, v, causal=True)
want = attention_plain(q.float(), k.float(), v.float(), causal=True)
print(json.dumps({"uuid": "GPU-" + str(torch.cuda.get_device_properties(0).uuid),
                  "count": torch.cuda.device_count(),
                  "launches": flash_attention_kernel.launches,
                  "max_abs_err": (out.float() - want).abs().max().item()}))
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and its driver's /dev/nvidia* nodes")
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


def test_master_check_on_the_card(cuda, tmpfs_dir, tmp_path):
    seen = []
    report = master_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                          cgroup_dirs=_stand_in_cgroup(tmp_path), fake_gpus=8, repeats=2,
                          on_mounted=lambda uuids, d: seen.append((uuids,
                                                                    gpus_visible_in_dev(d))))
    live = report["live"]
    assert live["case"] == ("round-trip" if has_cap_mknod() else "refused")
    if live["case"] == "round-trip":
        assert len(seen) == 1 and seen[0][1] == 1 and seen[0][0] == live["uuids"]
    assert report["live_errors"]["insufficient"][0] == 500
    assert [report["live_errors"][k][0] for k in ("no pod", "unknown uuid", "no token")] == \
        [404, 400, 401]
    assert sorted(report["fake"]) == [1, 8]
    assert all(len(f["add_ms"]) == len(f["remove_ms"]) == 2 for f in report["fake"].values())


def test_a_tenant_child_on_the_mounted_uuid_runs_flash_fwd(cuda, tmpfs_dir, tmp_path):
    if not has_cap_mknod():
        pytest.skip("without CAP_MKNOD the HTTP add is refused and nothing is mounted")
    children = []

    def on_mounted(uuids, dev_dir):
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": uuids[0], "PYTHONPATH": REPO}
        out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                             timeout=600, env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr[-4000:]
        children.append((uuids[0], json.loads(out.stdout.strip().splitlines()[-1])))

    master_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                 cgroup_dirs=_stand_in_cgroup(tmp_path), fake_gpus=1, repeats=1,
                 on_mounted=on_mounted)
    ((uuid, child),) = children
    assert child["uuid"] == uuid and child["count"] == 1
    assert child["launches"] == 1
    assert child["max_abs_err"] < 2e-2  # bf16 output against the f32 plain version


# The slice's tenant: only the plan's env (and the port of the test) tells it
# its world; one NCCL all-reduce of a CUDA tensor, then one flash_fwd launch.
SLICE_CHILD = r"""
import json, os, sys, torch
import torch.distributed as dist
from gpumounter_tpu_torch.ops.flash_attention import flash_attention, flash_attention_kernel
from gpumounter_tpu_torch.torchside.visibility import reinit_distributed
torch.cuda.set_device(0)
rank = int(os.environ["NODE_RANK"]) * int(os.environ["NPROC_PER_NODE"])
reinit_distributed(f"{os.environ['MASTER_ADDR']}:{sys.argv[1]}", int(os.environ["WORLD_SIZE"]),
                   rank)
value = torch.full((2,), float(rank + 1), device="cuda")
dist.all_reduce(value)
backends = dist.get_backend_config()
dist.destroy_process_group()
q = torch.randn(1, 4, 256, 64, device="cuda", dtype=torch.bfloat16)
flash_attention(q, q, q, causal=True)
print(json.dumps({"uuid": "GPU-" + str(torch.cuda.get_device_properties(0).uuid),
                  "sum": value.tolist(), "backends": backends,
                  "launches": flash_attention_kernel.launches}))
"""


def test_slice_check_on_the_card(cuda, tmpfs_dir, tmp_path):
    import socket
    children = []

    def on_mounted(plan, uuids, dev_dir):
        assert gpus_visible_in_dev(dev_dir) == 1
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env.update(plan["workers"][0]["env"], CUDA_VISIBLE_DEVICES=uuids[0], PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", SLICE_CHILD, str(port)], capture_output=True,
                             text=True, timeout=600, env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr[-4000:]
        children.append((uuids[0], json.loads(out.stdout.strip().splitlines()[-1])))

    report = slice_check("cuda", dev_dir=tmpfs_dir, ns_pid=os.getpid(),
                         cgroup_dirs=_stand_in_cgroup(tmp_path), repeats=1,
                         on_mounted=on_mounted)
    live = report["live"]
    assert live["case"] == ("round-trip" if has_cap_mknod() else "refused")
    if live["case"] == "round-trip":
        ((uuid, child),) = children
        assert child["uuid"] == uuid and child["sum"] == [1.0, 1.0]
        assert "cuda:nccl" in child["backends"] and child["launches"] == 1
        assert live["plan"]["workers"][0]["env"]["MASTER_ADDR"] == "127.0.0.1"
    assert report["rollback"]["status"] == 503
    assert report["batch"]["by_result"] == {"Success": 8, "PodNotFound": 1}
