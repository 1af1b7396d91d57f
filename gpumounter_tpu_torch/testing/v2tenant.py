"""A tenant process for checks of the cgroup v2 device controller on a real
kernel (``entry.cgroup_v2_check``, ``tests/test_torch_ebpf_kernel.py``).

``serve(spec, workload)`` moves this process into the cgroup ``spec["cgroup"]``
(a write of its PID to cgroup.procs), prints ``{"ready": pid}``, then
answers one JSON line for each line on stdin:

  * ``open``: {"open": {path: "ok" or the errno name}} for each of
    ``spec["paths"]``, each opened read-write and closed. The kernel's
    device program decides at open(2): EPERM is a deny; an admitted node
    with no driver behind it answers ENXIO or ENODEV;
  * ``run``: {"run": workload()} (null without a workload);
  * ``exit``: returns.

``check_cgroup`` names the cgroup a check makes for its tenant, after
removing those that checks which died left behind.

Run alone: ``python -m gpumounter_tpu_torch.testing.v2tenant SPEC_JSON`` (no
workload; imports no torch).
"""

from __future__ import annotations

import errno
import json
import os
import re
import sys

#: what open(2) of a device node answers once the device program admits it
ADMITTED = frozenset({"ok", "ENXIO", "ENODEV"})
#: the cgroups the checks make (``check_cgroup``), with their process's pid
_CHECK_CGROUP = re.compile(r"tpumounter-(?:v2-check|kernel-test)-(\d+)")


def try_open(path: str) -> str:
    try:
        os.close(os.open(path, os.O_RDWR))
    except OSError as exc:
        return errno.errorcode.get(exc.errno, str(exc.errno))
    return "ok"


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def check_cgroup(cgroup2_root: str, tag: str) -> str:
    """The path of this process's check cgroup, ``tpumounter-<tag>-<pid>``
    under `cgroup2_root` (not made here). First removes the check cgroups
    there whose process has died: one killed between its mkdir and rmdir
    leaves its cgroup in the host's hierarchy."""
    for name in os.listdir(cgroup2_root):
        m = _CHECK_CGROUP.fullmatch(name)
        if m and not _alive(int(m.group(1))):
            try:
                os.rmdir(os.path.join(cgroup2_root, name))
            except OSError:
                pass  # a process still in it
    return os.path.join(cgroup2_root, f"tpumounter-{tag}-{os.getpid()}")


def serve(spec: dict, workload=None) -> None:
    with open(os.path.join(spec["cgroup"], "cgroup.procs"), "w") as f:
        f.write(str(os.getpid()))
    print(json.dumps({"ready": os.getpid()}), flush=True)
    for line in sys.stdin:
        command = line.strip()
        if command == "open":
            print(json.dumps({"open": {p: try_open(p) for p in spec["paths"]}}), flush=True)
        elif command == "run":
            print(json.dumps({"run": workload() if workload is not None else None}), flush=True)
        elif command == "exit":
            return
        else:
            raise ValueError(f"unknown command {command!r}")


if __name__ == "__main__":
    serve(json.loads(sys.argv[1]))
