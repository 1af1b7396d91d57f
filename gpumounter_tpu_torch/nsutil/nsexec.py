"""The namespace helper's plain version, and the node operations of the
``pid=None`` mode.

The namespace helper is ``native/nsexec.cpp``, compiled (``native``):
``nsutil.ns`` execs it as ``gpumounter-nsexec /proc/PID/ns/mnt OP...``, one
exec a batch. This module is its plain version: ``main`` takes the same argv
(``python -I -S nsexec.py /proc/PID/ns/mnt OP...``), runs the same ops and
prints the same report, and tests hold the compiled helper against it;
nothing on the mount path runs it. ``mknod_here`` and ``unlink_here`` are
also what ``nsutil.ns`` does in its own namespace (``pid=None``).

Each op is a list, and :func:`encode_ops` writes it as argv:
  ["mknod", path, major, minor, mode]  mknod PATH MAJOR MINOR MODE-OCTAL
                                       a char device, missing parents made
                                       0755; idempotent
  ["unlink", path]                     unlink PATH; absent is fine
  ["missing", [path, ...]]             missing N PATH...; the paths that do
                                       not exist
Each op's result (null, or the list for "missing") goes to stdout as
{"results": [...]}. A failure prints {"stage": "enter" | "op", "errno",
"strerror", "filename", "message"} and exits 1; a malformed argv prints the
usage on stderr and exits 2.
"""

import json
import os
import re
import stat
import sys

USAGE = ("usage: nsexec.py NS_PATH [mknod PATH MAJOR MINOR MODE | unlink PATH | "
         "missing N PATH...]...")


def _mkdir_parents(path: str) -> None:
    """Each missing parent directory of `path`, mode 0755, from the top."""
    for i in range(1, len(path)):
        if path[i] == "/":
            try:
                os.mkdir(path[:i], 0o755)
            except FileExistsError:
                pass


def mknod_here(path: str, major: int, minor: int, mode: int) -> None:
    """Create one char device node, parents included; idempotent. The mode
    is set again after mknod, whose mode the umask masks."""
    if os.path.exists(path):
        return
    _mkdir_parents(path)
    try:
        os.mknod(path, mode | stat.S_IFCHR, os.makedev(major, minor))
    except FileExistsError:
        return  # two GPUs injecting one companion: the loser is fine
    except OSError as exc:  # os.mknod's error names no file
        raise OSError(exc.errno, exc.strerror, path) from None
    os.chmod(path, mode)


def unlink_here(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def encode_ops(ops: list) -> list[str]:
    """The helper's argv after the namespace path."""
    args = []
    for op in ops:
        if op[0] == "mknod":
            _, path, major, minor, mode = op
            args += ["mknod", path, str(major), str(minor), format(mode, "o")]
        elif op[0] == "unlink":
            args += ["unlink", op[1]]
        elif op[0] == "missing":
            args += ["missing", str(len(op[1])), *op[1]]
        else:
            raise ValueError(f"unknown op {op[0]!r}")
    return args


def _number(text: str, base: int, limit: int) -> int:
    """Digits of `base` only, at most `limit`."""
    if not re.fullmatch(f"[0-{base - 1}]+", text) or int(text, base) > limit:
        raise ValueError(f"bad number {text!r}")
    return int(text, base)


def decode_ops(args: list[str]) -> list:
    """:func:`encode_ops`'s inverse; ValueError on a malformed argv, as the
    compiled helper refuses it."""
    ops, i = [], 0
    while i < len(args):
        if args[i] == "mknod" and i + 5 <= len(args):
            ops.append(["mknod", args[i + 1], _number(args[i + 2], 10, 0xFFFFFFFF),
                        _number(args[i + 3], 10, 0xFFFFFFFF), _number(args[i + 4], 8, 0o7777)])
            i += 5
        elif args[i] == "unlink" and i + 2 <= len(args):
            ops.append(["unlink", args[i + 1]])
            i += 2
        elif args[i] == "missing" and i + 2 <= len(args):
            n = _number(args[i + 1], 10, len(args) - i - 2)
            ops.append(["missing", args[i + 2:i + 2 + n]])
            i += 2 + n
        else:
            raise ValueError(f"bad op {args[i]!r}")
    return ops


def _fail(stage: str, what: str, filename: str, exc: OSError) -> None:
    print(json.dumps({"stage": stage, "errno": exc.errno, "strerror": exc.strerror,
                      "filename": filename,
                      "message": f"{what} {filename}: {exc.strerror}"}))
    sys.exit(1)


def main(argv: list[str]) -> None:
    try:
        if len(argv) < 2:
            raise ValueError("no namespace path")
        ns_path, ops = argv[1], decode_ops(argv[2:])
    except ValueError as exc:
        print(f"nsexec.py: {exc}\n{USAGE}", file=sys.stderr)
        sys.exit(2)
    try:
        fd = os.open(ns_path, os.O_RDONLY | os.O_CLOEXEC)
    except OSError as exc:
        _fail("enter", "open", ns_path, exc)
    try:
        os.setns(fd, os.CLONE_NEWNS)
    except OSError as exc:
        _fail("enter", "setns", ns_path, exc)
    os.close(fd)
    results = []
    for op in ops:
        try:
            if op[0] == "mknod":
                results.append(mknod_here(*op[1:]))
            elif op[0] == "unlink":
                results.append(unlink_here(op[1]))
            else:
                results.append([p for p in op[1] if not os.path.exists(p)])
        except OSError as exc:
            _fail("op", op[0], exc.filename or "", exc)
    print(json.dumps({"results": results}))


if __name__ == "__main__":
    main(sys.argv)
