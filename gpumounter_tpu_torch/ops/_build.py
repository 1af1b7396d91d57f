"""Build the port's CUDA kernels and load them with ctypes.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` into a plain-C shared
library ``lib<name>-<hash>.so`` under ``gpumounter_tpu_torch/_build/``. The
hash covers the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Nothing here includes PyTorch's headers,
which keeps a build to seconds. A build happens at first use, from the
sources in the checkout alone; :func:`build` compiles several sources at
once, one ``nvcc`` each, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def nvcc_command(source: Path, output: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(output), str(source)]


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes (``#include
    "..."``), directly or through another of them."""
    found, todo = set(), [CSRC / f"{name}.cu"]
    while todo:
        src = todo.pop()
        if src in found or not src.exists():
            continue
        found.add(src)
        todo += [src.parent / inc for inc in _LOCAL_INCLUDE.findall(src.read_text())]
    return sorted(found)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: its name
    hashes the flags, the source and the headers it includes, so editing a
    header rebuilds only the libraries that include it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every named source whose library is missing, all at once.

    Raises RuntimeError naming the command when nvcc is missing or fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = []
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
        if not os.path.exists(cmd[0]):
            raise RuntimeError(f"nvcc not found; tried: {' '.join(cmd)}")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((proc, cmd, tmp, out))
    failures = []
    for proc, cmd, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{' '.join(cmd)} exited {proc.returncode}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
