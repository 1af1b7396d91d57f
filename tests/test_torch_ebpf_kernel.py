"""The cgroup v2 device controller on the kernel itself.

Gated: each test skips, naming the errno, unless this process is root, a
cgroup2 hierarchy and a bpffs mount under tmp_path, and a BPF map's
creation and a device program's load succeed (``ebpf.kernel_probe``).
Where they do:

  * the port's program, attached to a child cgroup, decides a tenant's
    opens of mknod'd char nodes (``testing/v2tenant.py``) as the
    interpreter decides them, round after round, the policy map's tokens
    spent down to a deny and the telemetry counts equal: EPERM is a deny,
    ENXIO/ENODEV on a node with no driver is an admit;
  * ``entry.cgroup_v2_check("cpu")`` runs ``V2DeviceController``'s grant
    and revoke round trip there: the tenant denied, admitted, denied again,
    runc's program ids from ``prog_query`` the same before and after, the
    grant restored by a restarted controller from the bpffs pins;
  * on bpffs the port's pins and journal land where the reference's temporary
    pin (``-ours.new``: bpffs refuses a dot) does not.

Run alone: ``python -m pytest tests/test_torch_ebpf_kernel.py -q`` (as
root, on an x86_64 Linux host).
"""

from __future__ import annotations

import json
import os
import stat as statmod
import subprocess
import sys

import pytest

from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu_torch import entry
from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.cgroup.policy import interpret_device_program
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.testing.v2tenant import ADMITTED, check_cgroup

CHAR = ebpf.BPF_DEVCG_DEV_CHAR
RW = ebpf.BPF_DEVCG_ACC_READ | ebpf.BPF_DEVCG_ACC_WRITE
# (name, major, minor): the tenant's /dev for the verdict test
# (a pts node with no pty behind it answers EIO: not used)
NODES = [("null", 1, 3), ("zero", 1, 5), ("fuse", 10, 229), ("nvidia0", 195, 0),
         ("nvidia1", 195, 1), ("nvidia2", 195, 2), ("nvidia-uvm", 511, 0), ("any507", 507, 9)]


@pytest.fixture()
def kernel(tmp_path):
    """The cgroup2 and bpffs mounts; skips, naming why, where the host
    gives no real bpf(2) and cgroup2."""
    if os.geteuid() != 0:
        pytest.skip("not root: a cgroup2 mount and bpf(2) need it")
    probe = ebpf.kernel_probe(str(tmp_path))
    mounted = [str(tmp_path / name) for name in ("bpffs", "cgroup2")
               if probe[f"{name}_mount"] == "ok"]
    try:
        refused = {k: v for k, v in probe.items() if v != "ok"}
        if refused:
            pytest.skip(f"the kernel refuses: {refused}")
        yield tmp_path
    finally:
        for target in mounted:
            ebpf.unmount(target)


@pytest.fixture()
def cgroup(kernel):
    """A child cgroup of the host's hierarchy, removed after the test (and
    by the next run's ``check_cgroup`` if this process dies first)."""
    path = check_cgroup(str(kernel / "cgroup2"), "kernel-test")
    fd = None
    try:
        os.mkdir(path)
        fd = os.open(path, os.O_RDONLY | os.O_DIRECTORY)
        yield path, fd
    finally:
        if fd is not None:
            os.close(fd)
        if os.path.isdir(path):
            os.rmdir(path)


class _Tenant:
    """A tenant process in the cgroup, opening the nodes on request."""

    def __init__(self, cgroup_dir: str, paths: list[str]):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gpumounter_tpu_torch.testing.v2tenant",
             json.dumps({"cgroup": cgroup_dir, "paths": paths})],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        assert "ready" in json.loads(self.proc.stdout.readline())

    def open(self) -> dict:
        self.proc.stdin.write("open\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())["open"]

    def close(self) -> int:
        self.proc.stdin.write("exit\n")
        self.proc.stdin.flush()
        return self.proc.wait(timeout=60)


def _nodes(root) -> list[str]:
    os.makedirs(root)
    paths = []
    for name, major, minor in NODES:
        path = os.path.join(root, name)
        os.mknod(path, 0o666 | statmod.S_IFCHR, os.makedev(major, minor))
        paths.append(path)
    return paths


@pytest.mark.parametrize("maps", [False, True], ids=["static", "maps"])
def test_the_kernel_decides_as_the_interpreter(kernel, cgroup, maps):
    cg_dir, cg_fd = cgroup
    rules = list(ebpf.DEFAULT_CONTAINER_RULES) + [ebpf.DeviceRule("c", 10, 229, "r"),
                                                  ebpf.DeviceRule("c", 507, None, "rw")]
    state: dict[int, dict[int, int]] = {}
    fds = []
    if maps:
        tfd, pfd = ebpf.map_create(), ebpf.map_create(name="tpum_policy")
        fds += [tfd, pfd]
        key = ebpf.telemetry_key
        state[tfd] = {key(195, m): 0 for m in range(3)}
        state[pfd] = {key(195, 0): ebpf.policy_value(50, 2), key(195, 1): ebpf.policy_value(0),
                      key(195, 2): ebpf.policy_value(10, 0)}
        for fd, table in state.items():
            for k, v in table.items():
                ebpf.map_update(fd, k, v)
        prog = ebpf.build_device_program(rules, telemetry_map_fd=tfd, policy_map_fd=pfd)
    else:
        rules.append(ebpf.DeviceRule("c", 195, 0, "rw"))
        prog = ebpf.build_device_program(rules)
    prog_fd = ebpf.prog_load(prog)
    fds.append(prog_fd)
    paths = _nodes(kernel / "dev")
    tenant = None
    try:
        ebpf.prog_attach(cg_fd, prog_fd)
        tenant = _Tenant(cg_dir, paths)
        for _ in range(3):
            got = tenant.open()
            want = [interpret_device_program(prog, state, CHAR, RW, major, minor)
                    for _, major, minor in NODES]
            assert [int(got[p] in ADMITTED) for p in paths] == want, got
            assert {got[p] for p in paths} <= ADMITTED | {"EPERM"}
            for fd, table in state.items():
                assert {k: ebpf.map_lookup(fd, k) for k in table} == table
        if maps:  # the metered GPU spent its 2 tokens, then was denied
            assert state[pfd][ebpf.telemetry_key(195, 0)] == ebpf.policy_value(50, 0)
            assert state[tfd] == {ebpf.telemetry_key(195, m): 3 for m in range(3)}
        assert tenant.close() == 0
        tenant = None
        ebpf.prog_detach(cg_fd, prog_fd)
        assert ebpf.prog_query(cg_fd) == []
    finally:
        if tenant is not None:
            tenant.proc.kill()
            tenant.proc.wait()
        for fd in fds:
            os.close(fd)


def test_a_grant_and_revoke_round_trip_on_the_kernel():
    """The check the card's smoke run makes, on this host's kernel."""
    if os.geteuid() != 0:
        pytest.skip("not root: a cgroup2 mount and bpf(2) need it")
    report = entry.cgroup_v2_check("cpu")
    if report["branch"] != "kernel":
        pytest.skip(f"the kernel refuses: {report['probe']}")
    flow = report["kernel"]
    gpu = report["gpu"].device_path
    assert (flow["before"][gpu], flow["granted"][gpu], flow["after"][gpu]) == \
        ("EPERM", "ENXIO", "EPERM")
    assert flow["ids_after"] == flow["ids_before"] != flow["ids_granted"]
    assert list(flow["restored"].values()) == [[(195, 0)]]
    assert flow["pins_left"] == [] and flow["tenant_exit"] == 0
    for stub in report["stub"].values():
        assert stub["granted"] == [1, 1, 1] and stub["revoked"] == [0, 0, 0]


def test_the_ports_pins_land_on_bpffs_where_the_references_do_not(kernel, cgroup):
    cg_dir, cg_fd = cgroup
    runc = ebpf.prog_load(ebpf.build_device_program(ebpf.DEFAULT_CONTAINER_RULES))
    ebpf.prog_attach(cg_fd, runc)
    journals = {}
    try:
        for name, mod, dev in (
                ("port", ebpf, GpuDevice(0, "/dev/nvidia0", 195, 0, "GPU-0")),
                ("reference", ref_ebpf, TpuDevice(0, "/dev/nvidia0", 195, 0, "GPU-0"))):
            pins = kernel / "bpffs" / name
            ctl = mod.V2DeviceController(pin_dir=str(pins), state_dir=str(kernel / name))
            try:
                ctl.grant(cg_dir, dev)
                journals[name] = (len(os.listdir(kernel / name)),
                                  sorted(p.split("-", 1)[1] for p in os.listdir(pins)))
                ctl.revoke(cg_dir, dev)
            finally:
                ctl.close()
            assert ebpf.prog_query(cg_fd) == [_prog_id(runc)]
    finally:
        ebpf.prog_detach(cg_fd, runc)
        os.close(runc)
    want_pins = ["orig-0", "ours"] + (["pmap"] if ebpf.probe_map_support() else [])
    assert journals["port"] == (1, want_pins)
    assert journals["reference"] == (0, ["orig-0"])


def _prog_id(fd: int) -> int:
    """A program's id from /proc/self/fdinfo."""
    with open(f"/proc/self/fdinfo/{fd}") as f:
        for line in f:
            if line.startswith("prog_id:"):
                return int(line.split()[1])
    raise RuntimeError(f"fd {fd} is not a BPF program")

