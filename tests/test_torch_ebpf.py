"""The cgroup-v2 device controller against the reference's
(``gpumounter_tpu/cgroup/ebpf.py``), on the CPU.

  * ``build_device_program`` gives the reference's bytes for seeded random
    rule lists (wildcards, each type, access subsets), with and without the
    telemetry and policy maps;
  * the port's interpreter and the reference's give the same verdict and
    leave the same map state after every access of a sweep over type,
    access, major and minor, a metered GPU's tokens taken down to zero;
  * ``V2DeviceController``'s state machine: each scenario runs on both
    packages, each over its own ``FakeBpf`` (``gpumounter_tpu_torch/testing/bpf.py``), and
    what they leave (attached programs, map contents, pins, journal JSON,
    the controller's views, the swap and map-grant counters) must be equal
    after every step. The scenarios are the reference's own
    (``tests/test_ebpf_persistence.py``, ``tests/test_cgroup.py:137-391``,
    ``tests/test_vchip.py:600-800``) with NVIDIA devices: a GPU's grant
    group is its node and the rw rules of nvidiactl, nvidia-uvm and
    nvidia-uvm-tools.

No test here issues bpf(2): the kernel is stubbed in every controller test
(``tests/test_torch_ebpf_kernel.py`` runs the real one where it may).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.cgroup import policy as ref_policy
from gpumounter_tpu.device.tpu import CompanionNode as RefCompanion
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu_torch.cgroup import ebpf, policy
from gpumounter_tpu_torch.device.gpu import CompanionNode, GpuDevice
from gpumounter_tpu_torch.testing.bpf import FakeBpf
from gpumounter_tpu_torch.testing.v2tenant import check_cgroup
from gpumounter_tpu_torch.utils.metrics import REGISTRY

UVM_MAJOR = 511  # nvidia-uvm's major is dynamic: any number the host gave it
COMPANIONS = (("nvidiactl", 195, 255), ("nvidia-uvm", UVM_MAJOR, 0),
              ("nvidia-uvm-tools", UVM_MAJOR, 1))


def _ref_device(i: int) -> TpuDevice:
    return TpuDevice(index=i, device_path=f"/dev/nvidia{i}", major=195, minor=i,
                     uuid=f"GPU-{i}", companions=[RefCompanion(*c) for c in COMPANIONS])


def _port_device(i: int) -> GpuDevice:
    return GpuDevice(index=i, device_path=f"/dev/nvidia{i}", major=195, minor=i,
                     uuid=f"GPU-{i}", companions=[CompanionNode(*c) for c in COMPANIONS])


PACKAGES = {
    "reference": SimpleNamespace(ebpf=ref_ebpf, policy=ref_policy, device=_ref_device),
    "port": SimpleNamespace(ebpf=ebpf, policy=policy, device=_port_device),
}


@pytest.fixture(autouse=True)
def _fresh_globals():
    """The telemetry tables, the policy engines and the registries are
    process globals, shared with whatever else runs in this process."""
    def reset():
        for pkg in PACKAGES.values():
            pkg.ebpf.DEVICE_TELEMETRY.reset()
            pkg.ebpf.DEVICE_TELEMETRY._readers.clear()
            pkg.policy.POLICY_ENGINE.reset()
        REGISTRY.reset_all()
    reset()
    yield
    reset()


# --- the program's bytes ---

def _random_rules(rng) -> list[tuple]:
    rules = []
    for _ in range(int(rng.integers(0, 12))):
        rules.append((str(rng.choice(["c", "b", "a"])),
                      None if rng.random() < 0.3 else int(rng.integers(0, 4096)),
                      None if rng.random() < 0.3 else int(rng.integers(0, 1 << 20)),
                      "".join(ch for ch in "rwm" if rng.random() < 0.6)))
    return rules


@pytest.mark.parametrize("seed", range(50))
def test_program_bytes_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    rules = _random_rules(rng)
    telemetry_fd = int(rng.integers(3, 1 << 16)) if seed % 2 else None
    policy_fd = int(rng.integers(3, 1 << 16)) if seed % 3 else None
    got = ebpf.build_device_program([ebpf.DeviceRule(*r) for r in rules], telemetry_fd,
                                    policy_fd)
    want = ref_ebpf.build_device_program([ref_ebpf.DeviceRule(*r) for r in rules],
                                         telemetry_fd, policy_fd)
    assert got == want
    assert len(got) % ebpf.INSN_SIZE == 0


def test_constants_defaults_and_the_grant_rule_equal_the_reference():
    names = [n for n in dir(ref_ebpf) if n.isupper() and isinstance(getattr(ref_ebpf, n), int)]
    assert names and {n: getattr(ebpf, n) for n in names} == \
        {n: getattr(ref_ebpf, n) for n in names}
    assert [tuple(vars(r).values()) for r in ebpf.DEFAULT_CONTAINER_RULES] == \
        [tuple(vars(r).values()) for r in ref_ebpf.DEFAULT_CONTAINER_RULES]
    assert vars(ebpf.device_rule(_port_device(3))) == vars(ref_ebpf.device_rule(_ref_device(3)))
    assert ebpf.insn_ld_imm64(9, 0xFFFFFFFF_80000001) == \
        ref_ebpf.insn_ld_imm64(9, 0xFFFFFFFF_80000001)
    for args in [(1, 2), (0xFFFFFFFF, 0xFFFFFFFF), (195, 255)]:
        assert ebpf.telemetry_key(*args) == ref_ebpf.telemetry_key(*args)
    for weight, tokens in [(0, ebpf.POLICY_UNMETERED), (60, 128), (0xFFFF, 0)]:
        value = ebpf.policy_value(weight, tokens)
        assert value == ref_ebpf.policy_value(weight, tokens)
        assert (ebpf.policy_weight(value), ebpf.policy_tokens(value)) == (weight, tokens)


# --- the interpreter ---

RW = ebpf.BPF_DEVCG_ACC_READ | ebpf.BPF_DEVCG_ACC_WRITE
SWEEP = [(t, a, maj, mi) for t in (ebpf.BPF_DEVCG_DEV_BLOCK, ebpf.BPF_DEVCG_DEV_CHAR)
         for a in range(1, 8)
         for maj, mi in [(195, 0), (195, 1), (195, 2), (195, 255), (UVM_MAJOR, 0),
                         (UVM_MAJOR, 1), (1, 3), (136, 42), (10, 229), (8, 0)]]
TELEMETRY_FD, POLICY_FD = 11, 12


@pytest.mark.parametrize("maps", ["none", "telemetry", "policy", "both"])
def test_interpreters_agree_access_by_access(maps):
    """Base rules hold fuse (rw) and GPU 1 (read only); on the map paths
    GPU 0 is metered at 3 tokens, so the sweep spends them down to a deny,
    GPU 2 is throttled (0 tokens) and the companions are unmetered."""
    tfd = TELEMETRY_FD if maps in ("telemetry", "both") else None
    pfd = POLICY_FD if maps in ("policy", "both") else None
    rules = list(ebpf.DEFAULT_CONTAINER_RULES) + [
        ebpf.DeviceRule("c", 10, 229, "rw"), ebpf.DeviceRule("c", 195, 1, "r")]
    if pfd is None:
        rules.append(ebpf.device_rule(_port_device(0)))
    prog = ebpf.build_device_program(rules, tfd, pfd)
    state: dict[int, dict[int, int]] = {}
    if tfd is not None:
        state[tfd] = {ebpf.telemetry_key(195, m): 0 for m in (0, 1, 2)}
    if pfd is not None:
        state[pfd] = {ebpf.telemetry_key(195, 0): ebpf.policy_value(50, 3),
                      ebpf.telemetry_key(195, 2): ebpf.policy_value(10, 0)}
        for _, major, minor in COMPANIONS:
            state[pfd][ebpf.telemetry_key(major, minor)] = ebpf.policy_value(0)
    got_maps = {fd: dict(table) for fd, table in state.items()}
    want_maps = {fd: dict(table) for fd, table in state.items()}
    verdicts = []
    for access in SWEEP:
        got = policy.interpret_device_program(prog, got_maps, *access)
        want = ref_policy.interpret_device_program(prog, want_maps, *access)
        assert (got, got_maps) == (want, want_maps), access
        verdicts.append(got)
    # The expectations of tests/test_cgroup.py:286-326, on these rules.
    by_access = dict(zip(SWEEP, verdicts))
    char = ebpf.BPF_DEVCG_DEV_CHAR
    assert by_access[(char, RW, 1, 3)] == by_access[(char, RW, 136, 42)] == 1
    assert by_access[(char, RW, 10, 229)] == 1
    assert by_access[(char, ebpf.BPF_DEVCG_ACC_READ, 195, 1)] == 1
    assert by_access[(char, RW, 195, 1)] == 0  # wider than its rule
    assert by_access[(ebpf.BPF_DEVCG_DEV_BLOCK, ebpf.BPF_DEVCG_ACC_MKNOD, 8, 0)] == 1
    assert by_access[(ebpf.BPF_DEVCG_DEV_BLOCK, ebpf.BPF_DEVCG_ACC_WRITE, 8, 0)] == 0
    if pfd is not None:
        assert got_maps[pfd][ebpf.telemetry_key(195, 0)] == ebpf.policy_value(50, 0)
        assert by_access[(char, RW, 195, 2)] == 0  # throttled, mknod-any too
        assert by_access[(char, ebpf.BPF_DEVCG_ACC_MKNOD, 195, 2)] == 0
        assert by_access[(char, RW, UVM_MAJOR, 1)] == 1
    else:
        assert by_access[(char, RW, 195, 0)] == 1
        assert by_access[(char, RW, 195, 2)] == 0
    if tfd is not None:
        # every one of the 14 accesses of each seeded GPU counted, denied too
        assert got_maps[tfd] == {ebpf.telemetry_key(195, m): 14 for m in (0, 1, 2)}


@pytest.mark.parametrize("prog, why", [
    (ebpf.insn(0x25), "unknown opcode"),
    (ebpf.insn(ebpf.OP_MOV64_IMM, dst=0, imm=1), "fell off end"),
    (ebpf.insn(0x05, off=-1) * 2, "unknown opcode"),
])
def test_interpreters_refuse_alike(prog, why):
    for interpret in (policy.interpret_device_program, ref_policy.interpret_device_program):
        with pytest.raises(ValueError, match=why):
            interpret(prog, {}, 2, RW, 1, 3)


# --- the bpf(2) wrappers ---

def test_bpf_attr_padded_to_full_union_size(monkeypatch):
    """The kernel writes output fields past the input ones (query.revision,
    8 bytes at offset 56, from Linux 6.3): every attr handed to it is
    BPF_ATTR_SIZE long. A fake syscall writes where Linux 6.18 writes."""
    seen = {}

    def fake_syscall(nr, cmd, buf, size):
        seen.update(nr=nr, cmd=cmd, size=size)
        ctypes.memmove(ctypes.addressof(ctypes.cast(buf, ctypes.POINTER(ctypes.c_char)).contents)
                       + 56, (ctypes.c_uint64 * 1)(2), 8)
        buf[24:28] = (0).to_bytes(4, "little")
        return 0

    monkeypatch.setattr(ebpf, "_libc", SimpleNamespace(syscall=fake_syscall))
    monkeypatch.setattr(ebpf.platform, "machine", lambda: "x86_64")
    assert ebpf.prog_query(123) == []
    assert seen == {"nr": ebpf.SYS_BPF, "cmd": ebpf.BPF_PROG_QUERY, "size": 256}
    assert ebpf.BPF_ATTR_SIZE == ref_ebpf.BPF_ATTR_SIZE


@pytest.mark.parametrize("machine", ["aarch64", "ppc64le"])
def test_another_machine_issues_no_bpf_syscall(monkeypatch, machine):
    """SYS_BPF is x86_64's number: elsewhere the wrappers raise, naming
    the machine, and the map probe answers False."""
    monkeypatch.setattr(ebpf, "_libc", SimpleNamespace(
        syscall=lambda *a: pytest.fail(f"syscall {a} issued on {machine}")))
    monkeypatch.setattr(ebpf.platform, "machine", lambda: machine)
    for call in (lambda: ebpf.prog_query(3), lambda: ebpf.map_create(),
                 lambda: ebpf.prog_load(ebpf.build_device_program([]))):
        with pytest.raises(ebpf.UnsupportedMachineError, match=machine):
            call()
    assert ebpf.probe_map_support() is False


# --- the controller's state machine ---

class _Run:
    """One package's run of a scenario."""

    def __init__(self, pkg, kernel: FakeBpf, root, cgroups: dict[str, str]):
        self.pkg, self.kernel, self.root, self.cg = pkg, kernel, str(root), cgroups
        self.controllers = []
        self.steps = []
        self.swaps0 = pkg.ebpf.PROGRAM_SWAPS.get()
        self.grants0 = pkg.ebpf.MAP_GRANTS.get()

    def controller(self, pin_dir=None):
        ctl = self.pkg.ebpf.V2DeviceController(
            pin_dir=pin_dir or os.path.join(self.root, "bpffs"),
            state_dir=os.path.join(self.root, "state"))
        self.controllers.append(ctl)
        return ctl

    def dev(self, i: int):
        return self.pkg.device(i)

    def call(self, fn, *args, **kwargs):
        """fn's outcome: "ok", or the exception's type and message."""
        try:
            fn(*args, **kwargs)
            return "ok"
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            return (type(exc).__name__, str(exc))

    def step(self, tag, ctl, outcome="ok"):
        seen = self.kernel.observe(ctl, self.root, self.cg)
        seen.update(swaps=self.pkg.ebpf.PROGRAM_SWAPS.get() - self.swaps0,
                    map_grants=self.pkg.ebpf.MAP_GRANTS.get() - self.grants0,
                    outcome=outcome)
        self.steps.append((tag, seen))
        return seen


def _run_both(tmp_path, scenario, maps: bool):
    """The scenario on each package over a FakeBpf of its own; the cgroup
    directories are the same paths for both, so that journals and pin names
    compare as they are. Returns the port's steps."""
    runs = {}
    for name, pkg in PACKAGES.items():
        cg_root = tmp_path / "cgroups"
        shutil.rmtree(cg_root, ignore_errors=True)
        cgroups = {}
        for cg in ("a", "b"):
            os.makedirs(cg_root / cg)
            cgroups[cg] = os.path.realpath(cg_root / cg)
        kernel = FakeBpf(maps=maps)
        kernel.preattach(cgroups["a"], 7)  # runc's programs
        kernel.preattach(cgroups["b"], 8)
        run = _Run(pkg, kernel, tmp_path / name, cgroups)
        with kernel.installed(pkg.ebpf):
            try:
                scenario(run)
            finally:
                for ctl in run.controllers:
                    ctl.close()
        runs[name] = run.steps
    assert [t for t, _ in runs["port"]] == [t for t, _ in runs["reference"]]
    for (tag, got), (_, want) in zip(runs["port"], runs["reference"]):
        assert got == want, tag
    return runs["port"]


def grant_restart_revoke(r):
    a = r.cg["a"]
    ctl_a = r.controller()
    r.step("grant 0", ctl_a, r.call(ctl_a.grant, a, r.dev(0)))
    r.step("grant 1", ctl_a, r.call(ctl_a.grant, a, r.dev(1)))
    ctl_b = r.controller()  # a restarted worker
    r.step("restored", ctl_b)
    r.step("revoke 0", ctl_b, r.call(ctl_b.revoke, a, r.dev(0)))
    r.step("revoke 1", ctl_b, r.call(ctl_b.revoke, a, r.dev(1)))


def corrupt_journal(r):
    os.makedirs(os.path.join(r.root, "state"))
    with open(os.path.join(r.root, "state", "deadbeef.json"), "w") as f:
        f.write("{not json")
    r.step("dropped", r.controller())


def unrestorable_state(r):
    ctl_a = r.controller()
    r.step("grant", ctl_a, r.call(ctl_a.grant, r.cg["a"], r.dev(0)))
    os.rmdir(r.cg["a"])  # the container went while the worker was down
    r.step("restart", r.controller())


def gc_dead_cgroups(r):
    ctl = r.controller()
    r.call(ctl.grant, r.cg["a"], r.dev(0))
    r.step("granted", ctl, r.call(ctl.grant, r.cg["b"], r.dev(1)))
    r.step("gc, both alive", ctl, ctl.gc_dead_cgroups())
    os.rmdir(r.cg["a"])
    r.step("gc, a dead", ctl, [os.path.basename(p) for p in ctl.gc_dead_cgroups()])
    r.step("revoke b", ctl, r.call(ctl.revoke, r.cg["b"], r.dev(1)))


def without_bpffs(r):
    ctl = r.controller(pin_dir="/proc/no/such/dir")
    r.step("pinning", ctl, ctl._pinning)
    r.step("grant", ctl, r.call(ctl.grant_many, r.cg["a"], [r.dev(0), r.dev(1)]))
    r.step("revoke", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(0)))
    r.step("revoke last", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(1)))


def query_refused(r):
    ctl = r.controller()
    r.kernel.fail_query.add(r.cg["a"])
    r.step("refused", ctl, r.call(ctl.grant, r.cg["a"], r.dev(0)))
    r.step("other cgroup", ctl, r.call(ctl.grant, r.cg["b"], r.dev(0)))


def batch_unwound(r):
    """A batch whose grant fails leaves the grants as they were: on the map
    path a map update fails, on the legacy path our new program's attach is
    refused. A first grant whose attach is refused leaves no state."""
    ctl = r.controller()
    r.step("grant 0", ctl, r.call(ctl.grant, r.cg["a"], r.dev(0)))
    if r.kernel.maps_supported:
        r.kernel.fail_update = 1
    else:
        r.kernel.fail_attach.add(r.kernel.next_id)
    r.step("batch 1-2 fails", ctl, r.call(ctl.grant_many, r.cg["a"], [r.dev(1), r.dev(2)]))
    r.kernel.fail_update = None
    r.kernel.fail_attach = {r.kernel.next_id}
    r.step("first grant on b fails", ctl, r.call(ctl.grant, r.cg["b"], r.dev(0)))
    r.kernel.fail_attach.clear()
    r.step("batch again", ctl, r.call(ctl.grant_many, r.cg["a"], [r.dev(1), r.dev(2)]))


def restore_kept_for_retry(r):
    ctl = r.controller()
    r.step("grant", ctl, r.call(ctl.grant, r.cg["a"], r.dev(0)))
    r.kernel.fail_attach.add(7)
    r.step("revoke, restore refused", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(0)))
    r.kernel.fail_attach.clear()
    r.step("revoke again", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(0)))


def companion_groups(r):
    """Two GPUs share the companions: revoking one keeps them for the
    other; the last revoke takes them away (on the map path, their keys go
    from the map) and restores runc's program."""
    ctl = r.controller()
    r.step("grant 0 1", ctl, r.call(ctl.grant_many, r.cg["a"], [r.dev(0), r.dev(1)],
                                    base_rules=[r.pkg.ebpf.DeviceRule("c", 10, 229, "rw")],
                                    tenant="ml/trainer"))
    r.step("revoke 0", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(0)))
    r.step("revoke 1", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(1)))
    r.step("untracked revoke", ctl, r.call(ctl.revoke, r.cg["a"], r.dev(1)))


def warm_regrant(r):
    """tests/test_vchip.py:691: one program load at the first grant; every
    grant, re-weight and revoke after it is a map write."""
    ctl = r.controller()
    a = r.cg["a"]
    r.step("grant 0 metered", ctl, r.call(ctl.grant, a, r.dev(0), tenant="default/prefill",
                                          policy={"GPU-0": (60, 128)}))
    r.step("re-grant 0", ctl, r.call(ctl.grant, a, r.dev(0), tenant="default/prefill",
                                     policy={"GPU-0": (40, 128)}))
    r.step("grant 1 whole", ctl, r.call(ctl.grant, a, r.dev(1), tenant="default/prefill"))
    r.step("re-weight 0", ctl, r.call(ctl.update_policy, a, r.dev(0), weight=75, tokens=32))
    r.step("re-weight 2 (not granted)", ctl,
           r.call(ctl.update_policy, a, r.dev(2), weight=1))
    r.step("revoke 0", ctl, r.call(ctl.revoke, a, r.dev(0)))


def orphans(r):
    """tests/test_vchip.py:746: an entry no grant refers to is reported,
    then collected; the grant's own entries stay."""
    ctl = r.controller()
    r.step("grant", ctl, r.call(ctl.grant, r.cg["a"], r.dev(0), policy={"GPU-0": (50, 0)}))
    st = ctl._state[r.cg["a"]]
    r.kernel.map_objs[r.kernel.fd2map[st.policy_fd]][r.pkg.ebpf.telemetry_key(99, 99)] = \
        r.pkg.ebpf.policy_value(10, 10)
    r.step("stray entry", ctl)
    r.step("gc", ctl, ctl.gc_policy_orphans())


def policy_map_restart(r):
    """tests/test_vchip.py:770: a restarted controller opens the pinned
    policy map (the one the attached program reads), swaps nothing, and a
    warm re-grant after it is still a map write."""
    ctl_a = r.controller()
    r.step("grant", ctl_a, r.call(ctl_a.grant, r.cg["a"], r.dev(0), tenant="ns/pod",
                                  policy={"GPU-0": (60, 8)}))
    ctl_b = r.controller()
    r.step("restored", ctl_b)
    r.step("re-grant", ctl_b, r.call(ctl_b.grant, r.cg["a"], r.dev(0), tenant="ns/pod",
                                     policy={"GPU-0": (45, 8)}))
    r.step("revoke", ctl_b, r.call(ctl_b.revoke, r.cg["a"], r.dev(0)))


LEGACY = [grant_restart_revoke, corrupt_journal, unrestorable_state, gc_dead_cgroups,
          without_bpffs, query_refused, batch_unwound, restore_kept_for_retry,
          companion_groups]
MAP_PATH = [grant_restart_revoke, gc_dead_cgroups, batch_unwound, restore_kept_for_retry,
            companion_groups, warm_regrant, orphans, policy_map_restart]


@pytest.mark.parametrize("scenario", LEGACY, ids=lambda s: s.__name__)
def test_legacy_path_matches_the_reference(tmp_path, scenario):
    _run_both(tmp_path, scenario, maps=False)


@pytest.mark.parametrize("scenario", MAP_PATH, ids=lambda s: s.__name__)
def test_map_path_matches_the_reference(tmp_path, scenario):
    _run_both(tmp_path, scenario, maps=True)


def test_legacy_grant_restart_revoke_restores_the_original_exactly(tmp_path):
    """tests/test_ebpf_persistence.py:97's expectations, on the port's run."""
    steps = dict(_run_both(tmp_path, grant_restart_revoke, maps=False))
    granted = steps["grant 1"]
    assert [d[0] for d in granted["attached"]["a"]] == ["ours"]
    assert granted["swaps"] == 2 and len(granted["journals"]) == 1
    assert any(p.endswith("-orig-0") for p in granted["pins"])
    assert any(p.endswith("-ours") for p in granted["pins"])
    assert steps["restored"]["grants"] == {"a": [(195, 0), (195, 1)]}
    done = steps["revoke 1"]
    assert done["attached"]["a"] == [("orig", 7)]
    assert done["pins"] == [] and done["journals"] == {} and done["tracked"] == []


def test_companion_keys_go_with_the_last_group_on_the_map_path(tmp_path):
    steps = dict(_run_both(tmp_path, companion_groups, maps=True))
    key = ebpf.telemetry_key
    comps = {key(major, minor) for _, major, minor in COMPANIONS}
    assert set(steps["grant 0 1"]["policy_maps"]["a"]) == {key(195, 0), key(195, 1)} | comps
    assert set(steps["revoke 0"]["policy_maps"]["a"]) == {key(195, 1)} | comps
    last = steps["revoke 1"]
    assert last["policy_maps"] == {} and last["attached"]["a"] == [("orig", 7)]
    assert last["swaps"] == 1 and last["map_grants"] == 4


def test_a_failed_batch_and_a_failed_first_grant_leave_no_trace(tmp_path):
    for maps in (False, True):
        steps = dict(_run_both(tmp_path / str(maps), batch_unwound, maps=maps))
        before, failed = steps["grant 0"], steps["batch 1-2 fails"]
        assert failed["outcome"][0] == "BpfError"
        assert (failed["grants"], failed["policy_maps"]) == (before["grants"],
                                                             before["policy_maps"])
        first = steps["first grant on b fails"]
        assert first["outcome"][0] == "BpfError"
        assert first["attached"]["b"] == [("orig", 8)] and "b" not in first["tracked"]
        assert steps["batch again"]["grants"]["a"] == [(195, 0), (195, 1), (195, 2)]


def test_warm_regrants_swap_nothing(tmp_path):
    steps = dict(_run_both(tmp_path, warm_regrant, maps=True))
    assert [steps[t]["swaps"] for t in steps] == [1] * len(steps)
    assert steps["re-weight 0"]["policy_maps"]["a"][ebpf.telemetry_key(195, 0)] == \
        ebpf.policy_value(75, 32)
    assert steps["re-weight 2 (not granted)"]["outcome"][0] == "BpfError"


def test_pins_take_names_that_bpffs_accepts(tmp_path):
    """bpffs refuses a name with a dot (EPERM). The reference's temporary
    pin "-ours.new" is refused there, so it journals nothing and a
    restarted controller restores nothing; the port's "-ours-new" pins, and
    a restart restores the grant (on the kernel itself:
    tests/test_torch_ebpf_kernel.py)."""
    seen = {}
    for name, pkg in PACKAGES.items():
        cg = os.path.realpath(tmp_path / name / "cgroup")
        os.makedirs(cg)
        kernel = FakeBpf(bpffs_names=True)
        kernel.preattach(cg, 7)
        with kernel.installed(pkg.ebpf):
            dirs = dict(pin_dir=str(tmp_path / name / "bpffs"),
                        state_dir=str(tmp_path / name / "state"))
            ctl = pkg.ebpf.V2DeviceController(**dirs)
            ctl.grant(cg, pkg.device(0))
            restarted = pkg.ebpf.V2DeviceController(**dirs)
            seen[name] = (len(os.listdir(dirs["state_dir"])),
                          sorted(p.split("-", 1)[1] for p in os.listdir(dirs["pin_dir"])),
                          restarted.enumerate_grants())
            ctl.close()
            restarted.close()
    assert seen["port"][:2] == (1, ["orig-0", "ours"])
    assert list(seen["port"][2].values()) == [{(195, 0)}]
    assert seen["reference"] == (0, ["orig-0"], {})  # a pin left with no journal


def test_a_check_cgroup_left_by_a_dead_process_is_removed(tmp_path):
    """A check killed between its cgroup's mkdir and rmdir leaves it in the
    host's hierarchy; the next check's ``check_cgroup`` removes it, and no
    cgroup of a live process or of another name."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    names = [f"tpumounter-kernel-test-{dead.pid}", f"tpumounter-v2-check-{dead.pid}",
             f"tpumounter-v2-check-{os.getppid()}", f"tpumounter-other-{dead.pid}"]
    for name in names:
        os.mkdir(tmp_path / name)
    path = check_cgroup(str(tmp_path), "kernel-test")
    assert path == str(tmp_path / f"tpumounter-kernel-test-{os.getpid()}")
    assert sorted(os.listdir(tmp_path)) == sorted(names[2:])
