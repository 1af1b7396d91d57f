"""Rules of the PyTorch port as a package: what it imports, where it runs,
how its kernels are built."""

from __future__ import annotations

import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from gpumounter_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "gpumounter_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "gpumounter_tpu"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_grpc(path):
    """No module imports grpc by name: it loads through
    ``utils/lazy_grpc.py`` when a channel or server is built, so the mount
    path and the master's app, which need no gRPC, import without it
    (``tests/test_torch_daemons.py`` checks the modules loaded)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not [n for n in names if n.split(".")[0] == "grpc"], \
            f"{path.name}:{node.lineno} imports {names}"


CGROUP_V2_MODULES = ["gpumounter_tpu_torch.utils.metrics", "gpumounter_tpu_torch.cgroup.ebpf",
                     "gpumounter_tpu_torch.cgroup.policy", "gpumounter_tpu_torch.cgroup",
                     "gpumounter_tpu_torch.worker.mounter"]


def test_the_cgroup_v2_modules_load_no_jax_and_nothing_of_the_jax_package():
    """The eBPF controller, the policy engine and the metrics registry are
    the port's own copies (the reference's import no JAX either): the
    import guard above covers their files, and a fresh interpreter that
    imports them holds no module of JAX or of gpumounter_tpu."""
    import subprocess
    import sys
    for module in CGROUP_V2_MODULES:
        path = REPO / (module.replace(".", "/") + ".py")
        assert (path if path.exists() else path.with_suffix("") / "__init__.py") in PORT_FILES
    code = ("import importlib, sys\n"
            "for m in sys.argv[1:]:\n    importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'gpumounter_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code, *CGROUP_V2_MODULES], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


OBS_FILES = sorted([*(REPO / "gpumounter_tpu_torch/faults").glob("*.py"),
                    *(REPO / "gpumounter_tpu_torch/obs").glob("*.py")])


#: the fleet planes' modules, which also read the config and the device-access
#: table (``cgroup/ebpf.py``, standard library only), as the reference's
#: ``obs/fleet.py`` and ``obs/slo.py`` do
FLEET_PLANE_FILES = {"fleet.py", "slo.py", "tenants.py", "assembly.py"}


@pytest.mark.parametrize("path", OBS_FILES, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_faults_and_obs_import_only_the_stdlib_and_utils(path):
    """The failpoints and the trace, audit and flight stores are on the mount
    path: the standard library, the port's utils/ and each other only, as
    in the reference. The fleet planes may also import the config and the
    device-access table's module."""
    import sys
    allowed = ("gpumounter_tpu_torch.utils", "gpumounter_tpu_torch.faults",
               "gpumounter_tpu_torch.obs")
    if path.parent.name == "obs" and path.name in FLEET_PLANE_FILES:
        allowed += ("gpumounter_tpu_torch.config", "gpumounter_tpu_torch.cgroup.ebpf")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top in sys.stdlib_module_names or name.startswith(allowed), \
                f"{path.name}:{node.lineno} imports {name}"


#: the elastic reconciler and the migration machine, and what each may import
#: besides the standard library: as in the reference, the worker's calls go
#: through the messages of ``rpc/api.py`` and the mounts through the slice
#: coordinator, so neither reaches grpc, torch or the worker's machinery
CONTROLLER_FILES = {
    "elastic/reconciler.py": ("config", "utils", "k8s", "store", "elastic", "migrate", "faults",
                              "obs", "rpc.api", "master.shard", "master.slice_ops"),
    "migrate/orchestrator.py": ("config", "utils", "k8s", "store", "elastic", "migrate",
                                "faults", "obs", "rpc.api", "master.shard",
                                "master.slice_ops"),
}
STORE_FILES = sorted(p for p in [*(REPO / "gpumounter_tpu_torch/store").glob("*.py"),
                                 *(REPO / "gpumounter_tpu_torch/elastic").glob("*.py"),
                                 *(REPO / "gpumounter_tpu_torch/migrate").glob("*.py"),
                                 REPO / "gpumounter_tpu_torch/k8s/health.py"]
                     if f"{p.parent.name}/{p.name}" not in CONTROLLER_FILES)


@pytest.mark.parametrize("path", STORE_FILES, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_the_store_and_degraded_mode_import_only_the_stdlib_config_utils_and_k8s(path):
    """The master's store, ApiHealth, intents and journals: the standard
    library, the port's config, utils/ and k8s/, and each other only, as in
    the reference; so the mount path, which imports k8s/, still imports
    without grpc."""
    import sys
    allowed = tuple(f"gpumounter_tpu_torch.{m}" for m in
                    ("config", "utils", "k8s", "store", "elastic", "migrate"))
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in sys.stdlib_module_names or name.startswith(allowed), \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("rel", list(CONTROLLER_FILES))
def test_the_reconciler_and_the_machine_import_only_the_control_planes_modules(rel):
    import sys
    allowed = tuple(f"gpumounter_tpu_torch.{m}" for m in CONTROLLER_FILES[rel])
    path = REPO / "gpumounter_tpu_torch" / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            # `from pkg import module` names the module
            names = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in sys.stdlib_module_names or name.startswith(allowed), \
                f"{rel}:{node.lineno} imports {name}"


#: the modules of sharding and the warm pool, and what each may import
#: besides the standard library: as in the reference, none reaches grpc,
#: torch or the worker's mount machinery
SHARD_POOL_FILES = {
    "utils/locks.py": (),
    "rpc/http_failover.py": ("utils",),
    "master/shard.py": ("config", "k8s", "utils"),
    "allocator/pool.py": ("config", "faults", "k8s", "utils", "allocator"),
}


@pytest.mark.parametrize("rel", list(SHARD_POOL_FILES))
def test_the_shard_and_pool_modules_import_only_the_stdlib_and_the_ports_basics(rel):
    import sys
    allowed = tuple(f"gpumounter_tpu_torch.{m}" for m in SHARD_POOL_FILES[rel])
    path = REPO / "gpumounter_tpu_torch" / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in sys.stdlib_module_names or (
                allowed and name.startswith(allowed)), f"{rel}:{node.lineno} imports {name}"


def test_banned_names_match_exactly():
    assert _banned("gpumounter_tpu") and _banned("gpumounter_tpu.ops")
    assert _banned("jax.numpy") and _banned("jaxlib")
    assert not _banned("gpumounter_tpu_torch.ops")


def test_entry_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default device works")
    from gpumounter_tpu_torch.entry import entry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_build_targets_sm_90a(tmp_path):
    cmd = _build.nvcc_command(_build.CSRC / "flash_fwd.cu", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert cmd[-1].endswith("flash_fwd.cu")


def test_build_output_is_gitignored():
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    ignored = (REPO / ".gitignore").read_text().split()
    assert rel in ignored


def test_library_path_follows_the_source():
    path = _build.library_path("flash_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert _build.library_path("flash_fwd") == path  # stable across calls


def test_missing_nvcc_names_the_command(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="/nonexistent/bin/nvcc .*sm_90a"):
        _build.build(["flash_fwd"])


def test_library_path_hashes_only_the_headers_a_source_includes(monkeypatch, tmp_path):
    """Editing a header rebuilds the libraries that include it, directly or
    through another header, and no other."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "x.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "y.cuh"\n')
    (tmp_path / "c.cu").write_text("// includes nothing local\n")
    (tmp_path / "x.cuh").write_text('#pragma once\n  #  include "z.cuh"\n')
    (tmp_path / "y.cuh").write_text("#pragma once\n")
    (tmp_path / "z.cuh").write_text("#pragma once\n")
    assert [p.name for p in _build.sources("a")] == ["a.cu", "x.cuh", "z.cuh"]
    before = {name: _build.library_path(name) for name in "abc"}

    (tmp_path / "z.cuh").write_text("#pragma once\n// edited\n")
    after = {name: _build.library_path(name) for name in "abc"}
    assert after["a"] != before["a"]  # through x.cuh
    assert after["b"] == before["b"] and after["c"] == before["c"]

    (tmp_path / "y.cuh").write_text("#pragma once\n// edited\n")
    assert _build.library_path("b") != before["b"]
    assert _build.library_path("a") == after["a"]
    assert _build.library_path("c") == before["c"]


def test_flash_fwd_hashes_the_hopper_header():
    assert {p.name for p in _build.sources("flash_fwd")} == {"flash_fwd.cu", "hopper.cuh"}
    assert {p.name for p in _build.sources("flash_bwd")} == {"flash_bwd.cu", "hopper.cuh"}
    assert {p.name for p in _build.sources("flash_decode")} == {"flash_decode.cu", "hopper.cuh"}


def test_ptxas_report_names_every_kernel_instance():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 2 barriers, 128 bytes smem"
        for name, regs, spill in (
            ("_ZN12_GLOBAL__N_12tc22flash_decode_tc_kernelILi128ELi8EEEvNS_6ParamsE", 76, 0),
            # The merge kernel is not a *_kernel entry and is left out.
            ("_ZN12_GLOBAL__N_118flash_decode_mergeI13__nv_bfloat16Li128EEEvNS_6ParamsE", 40, 0),
            ("_ZN12_GLOBAL__N_13f3223flash_decode_f32_kernelILi64ELi1EEEvNS_6ParamsE", 128, 8),
            ("_ZN12_GLOBAL__N_12tc19flash_fwd_tc_kernelILi128ELb1EEEvNS0_6ParamsE", 168, 0)))
    lines = smoke._ptxas_lines(log)
    assert lines == [
        "ptxas flash_decode_tc_kernel<128, 8>: 76 registers, spill stores 0 B, spill loads 0 B",
        "ptxas flash_decode_f32_kernel<64, 1>: 128 registers, spill stores 8 B, spill loads 8 B",
        "ptxas flash_fwd_tc_kernel<128, 1>: 168 registers, spill stores 0 B, spill loads 0 B"]
    # Only the wgmma instances are held to no spills.
    assert [bool(smoke._PTXAS_NO_SPILL.match(line)) for line in lines] == [True, False, True]


def _run_chip_smoke(cwd, env=None):
    import subprocess
    import sys
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_chip_smoke_alone_exits_non_zero_and_says_why(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it must fail and print no result: it names the missing
    package and exits 2."""
    import os
    import shutil
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_chip_smoke(tmp_path, env)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout == ""
    assert "gpumounter_tpu_torch is not beside this script" in out.stderr


def test_chip_smoke_without_cuda_exits_1_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _run_chip_smoke(REPO)
    assert out.returncode == 1 and out.stdout == ""
    assert "no CUDA device" in out.stderr
