"""The namespace helper: enter a process's mount namespace and run a list of
device-node operations there, in a process of its own.

The counterpart of the reference's C++ helper ``tpumounter-nsexec``
(``native/nsexec.cpp``), and of the original's ``nsenter --target PID
--mount sh -c "mknod ..."`` (``namespace.go:167-189``). ``nsutil.ns`` runs
it as ``python -I -S nsexec.py /proc/PID/ns/mnt OPS`` through
``subprocess``: a fresh, single-threaded interpreter that imports nothing
but the standard library,
so setns(2) into a mount namespace is allowed (it refuses a process whose
threads share its filesystem context), and nothing of the worker (CUDA,
gRPC's threads and their fork handlers) is copied into it. The worker never
forks without an exec: grpcio's fork handlers, run in a child of a process
that serves gRPC, abort it.

OPS is a JSON list; each op is one of
  ["mknod", path, major, minor, mode]  a char device, parents included;
                                       idempotent
  ["unlink", path]                     absent is fine
  ["missing", [path, ...]]             the paths that do not exist
and its result (null, or the list for "missing") goes to stdout as
{"results": [...]}. A failure prints {"stage": "enter" | "op", "errno",
"strerror", "filename", "message"} and exits 1.
"""

import json
import os
import stat
import sys


def mknod_here(path: str, major: int, minor: int, mode: int) -> None:
    """Create one char device node, parents included; idempotent. The mode
    is set again after mknod, whose mode the umask masks."""
    if os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        os.mknod(path, mode | stat.S_IFCHR, os.makedev(major, minor))
    except FileExistsError:
        return  # two GPUs injecting one companion: the loser is fine
    os.chmod(path, mode)


def unlink_here(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def run_ops(ops: list) -> list:
    results = []
    for op in ops:
        if op[0] == "mknod":
            results.append(mknod_here(*op[1:]))
        elif op[0] == "unlink":
            results.append(unlink_here(op[1]))
        elif op[0] == "missing":
            results.append([p for p in op[1] if not os.path.exists(p)])
        else:
            raise ValueError(f"unknown op {op[0]!r}")
    return results


def _fail(stage: str, exc: BaseException) -> None:
    errno = getattr(exc, "errno", None)
    print(json.dumps({"stage": stage, "errno": errno if isinstance(errno, int) else -1,
                      "strerror": getattr(exc, "strerror", None) or str(exc),
                      "filename": getattr(exc, "filename", None) or "",
                      "message": f"{type(exc).__name__}: {exc}"}))
    sys.exit(1)


def main(argv: list[str]) -> None:
    ns_path, ops = argv[1], json.loads(argv[2])
    try:
        fd = os.open(ns_path, os.O_RDONLY | os.O_CLOEXEC)
        os.setns(fd, os.CLONE_NEWNS)
        os.close(fd)
    except OSError as exc:
        _fail("enter", exc)
    try:
        results = run_ops(ops)
    except Exception as exc:  # noqa: BLE001 — reported to the caller
        _fail("op", exc)
    print(json.dumps({"results": results}))


if __name__ == "__main__":
    main(sys.argv)
