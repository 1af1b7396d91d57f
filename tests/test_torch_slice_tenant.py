"""The tenant's half of a slice: a 2 x 1 plan, two processes, one world.

The counterpart of the reference's slow-marked
``tests/test_distributed_slice.py``. The master's plan
(``master/slice_ops.topology_plan``) gives each worker its env; two real OS
processes each start with only their worker's env (no other distributed
variable), re-form the process group from it
(``torchside.visibility.reinit_distributed`` at MASTER_ADDR and a port of
the test's, world WORLD_SIZE, rank NODE_RANK x NPROC_PER_NODE) over gloo on
the CPU, and all-reduce: the sum must be every rank's rank + 1, and each
process must have read exactly the plan's variables.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

from gpumounter_tpu_torch.master.slice_ops import SliceTarget, topology_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: what torch.distributed and torchrun read: the children get these from the
#: plan only
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "NNODES", "NODE_RANK", "NPROC_PER_NODE",
            "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "ACCELERATOR_TYPE")

CHILD = r"""
import json, os, sys
import torch
import torch.distributed as dist
from gpumounter_tpu_torch.torchside.visibility import reinit_distributed

names, port = json.loads(sys.argv[1]), sys.argv[2]
read = {k: os.environ[k] for k in names if k in os.environ}
world, per_node = int(os.environ["WORLD_SIZE"]), int(os.environ["NPROC_PER_NODE"])
rank = int(os.environ["NODE_RANK"]) * per_node
reinit_distributed(f"{os.environ['MASTER_ADDR']}:{port}", world, rank)
value = torch.full((3,), float(rank + 1))
dist.all_reduce(value)
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "sum": value.tolist(), "read": read}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_processes_form_one_world_from_the_plan():
    targets = [SliceTarget("default", f"rank-{i}") for i in range(2)]
    plan = topology_plan(targets, ["host-0", "host-1"], ["127.0.0.1", "127.0.0.1"], 1)
    port = str(_free_port())
    base = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    base["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, json.dumps(DIST_ENV), port],
                              env={**base, **worker["env"]}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO)
             for worker in plan["workers"]]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    assert [o["rank"] for o in outs] == [0, 1]
    for out, worker in zip(outs, plan["workers"]):
        assert out["world"] == 2 and out["sum"] == [3.0, 3.0, 3.0]
        assert out["read"] == worker["env"]
    assert plan["workers"][1]["env"] == {"NODE_RANK": "1", "MASTER_ADDR": "127.0.0.1",
                                         "NNODES": "2", "NPROC_PER_NODE": "1",
                                         "WORLD_SIZE": "2"}
