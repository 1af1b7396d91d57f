"""The port's native layer: the namespace helper and the /proc holder scan,
compiled from C++ and bound with ctypes.

The counterpart of ``gpumounter_tpu/native.py`` and the reference's
``native/``. Two artifacts, each built from a source beside this file by the
host C++ compiler (``CXX``, else ``g++`` on PATH) into
``gpumounter_tpu_torch/_build/`` at first use:

  ``gpumounter-nsexec-<hash>``        from ``nsexec.cpp``: enters a mount
                                      namespace and makes the device nodes
                                      (``nsutil.ns`` execs it);
  ``libgpumounter_native-<hash>.so``  from ``gpumounter_native.cpp``:
                                      ``gpm_scan_device_holders``, the /proc
                                      scan of the busy check.

The hash covers the source and the flags, so an edited source is rebuilt and
an unchanged one is used as it is; a build writes to a temporary name and
renames it, so processes that build at once never see half an artifact.
``TPUMOUNTER_NSEXEC`` and ``TPUMOUNTER_NATIVE_LIB`` (``Config.nsexec_bin``,
``Config.native_lib``) name prebuilt artifacts instead, as the worker image
does; a named path that does not exist raises.

There is no fallback, where the reference quietly goes on in Python: a
failed build, load or exec raises :class:`NativeError` with the compiler's
output or the loader's reason. This module imports the standard library and
the config only, so the mount path and the CLI import without torch, numpy
or grpc.
"""

from __future__ import annotations

import ctypes
import errno
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from gpumounter_tpu_torch.config import Config

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / "_build"
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror")
#: kind -> (source, flags beside CXX_FLAGS, artifact's stem, suffix, Config field)
ARTIFACTS = {
    "nsexec": ("nsexec.cpp", (), "gpumounter-nsexec", "", "nsexec_bin"),
    "native_lib": ("gpumounter_native.cpp", ("-shared", "-fPIC"), "libgpumounter_native",
                   ".so", "native_lib"),
}


class NativeError(RuntimeError):
    """The native layer could not be built, found, loaded or run."""


def _configured(kind: str) -> str:
    """The prebuilt path that the environment names for `kind`, or "": the
    Config field's own variable, read without building a whole Config on
    every namespace entry."""
    return Config.__dataclass_fields__[ARTIFACTS[kind][4]].default_factory()


def compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise NativeError(f"no C++ compiler {cxx!r} to build the native layer: set CXX or "
                          "put g++ on PATH")
    return found


def flags(kind: str) -> tuple[str, ...]:
    return CXX_FLAGS + ARTIFACTS[kind][1]


def compile_command(kind: str, output: Path) -> list[str]:
    return [compiler(), *flags(kind), "-o", str(output), str(SOURCE_DIR / ARTIFACTS[kind][0])]


def artifact_path(kind: str, build_dir: Path | None = None) -> Path:
    """Where the artifact built from `kind`'s source lives: its name hashes
    the flags and the source."""
    source, _, stem, suffix, _ = ARTIFACTS[kind]
    digest = hashlib.sha256(" ".join(flags(kind)).encode())
    digest.update((SOURCE_DIR / source).read_bytes())
    return (build_dir or BUILD_DIR) / f"{stem}-{digest.hexdigest()[:16]}{suffix}"


_build_lock = threading.Lock()


def build(kinds=tuple(ARTIFACTS), build_dir: Path | None = None) -> dict[str, Path]:
    """Compile every named artifact that is missing, all at once; returns
    each one's path. Raises NativeError with the compiler's output when a
    compile fails."""
    build_dir = build_dir or BUILD_DIR
    with _build_lock:
        build_dir.mkdir(parents=True, exist_ok=True)
        paths = {kind: artifact_path(kind, build_dir) for kind in kinds}
        todo = [(kind, out, out.with_name(f"{out.name}.{os.getpid()}.tmp"))
                for kind, out in paths.items() if not out.exists()]
        commands = [(compile_command(kind, tmp), out, tmp) for kind, out, tmp in todo]
        running = [(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), cmd, out, tmp) for cmd, out, tmp in commands]
        failures = []
        for proc, cmd, out, tmp in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{' '.join(cmd)} exited {proc.returncode}:\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half an artifact
    if failures:
        raise NativeError("native layer build failed:\n" + "\n".join(failures))
    return paths


@functools.cache
def _built(kind: str, build_dir: Path) -> Path:
    return build([kind], build_dir)[kind]


def _path(kind: str) -> str:
    configured = _configured(kind)
    if not configured:
        return str(_built(kind, BUILD_DIR))
    if not os.path.exists(configured):
        raise NativeError(f"the native layer's {ARTIFACTS[kind][4]} is set to {configured}, "
                          "which does not exist")
    return configured


def helper_path() -> str:
    """The namespace helper to exec: the configured one, else the one built
    from ``nsexec.cpp`` (built now if missing)."""
    return _path("nsexec")


@functools.cache
def _load(path: str) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        raise NativeError(f"cannot load the native library {path}: {exc}") from exc
    lib.gpm_scan_device_holders.restype = ctypes.c_int
    lib.gpm_scan_device_holders.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    return lib


def library() -> ctypes.CDLL:
    """The native library, loaded from the configured path, else built from
    ``gpumounter_native.cpp`` (built now if missing)."""
    return _load(_path("native_lib"))


def status() -> dict:
    """Each artifact's path and whether it is there, without building
    anything: ``nsexec``, ``nsexec_built``, ``native_lib``,
    ``native_lib_built``."""
    report = {}
    for kind in ARTIFACTS:
        path = _configured(kind) or str(artifact_path(kind))
        report[kind] = path
        report[f"{kind}_built"] = os.path.exists(path)
    return report


def scan_device_holders(major: int | None, minor: int | None, path_hint: str = "",
                        proc_root: str = "/proc") -> list[int]:
    """PIDs with an open fd on the device: by rdev when `major` and `minor`
    are given and not 0:0, and by the fd's exact link target `path_hint`.
    A `proc_root` that does not exist holds no holders."""
    lib = library()
    capacity = 256
    while True:
        buf = (ctypes.c_int32 * capacity)()
        n = lib.gpm_scan_device_holders(
            -1 if major is None else major, -1 if minor is None else minor,
            os.fsencode(path_hint), os.fsencode(proc_root), buf, capacity)
        if n == -errno.ENOENT:
            return []
        if n < 0:
            raise OSError(-n, os.strerror(-n), proc_root)
        if n <= capacity:
            return list(buf[:n])
        capacity = n
