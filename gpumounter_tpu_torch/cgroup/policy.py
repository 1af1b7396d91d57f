"""The userspace half of the grants that carry a policy.

The counterpart of ``gpumounter_tpu/cgroup/policy.py``. The kernel half is
in ``cgroup/ebpf.py``: grants are policy-map entries that a
BPF_PROG_TYPE_CGROUP_DEVICE program consults (a token-bucket admit or deny,
``_policy_block``). Where that kernel path does not exist (cgroup v1 hosts,
fake device backends, kernels without CAP_BPF) two pieces keep the books:

  * ``interpret_device_program``: an interpreter of exactly the bytecode
    ``build_device_program`` emits, over dict-backed maps that it mutates
    as the kernel would (the XADD token decrement included). Tests hold the
    kernel's decision procedure and the engine below to each other with it,
    admit for admit and end state for end state;
  * ``UserspacePolicyEngine``: the same procedure (miss -> static rules,
    UNMETERED -> admit, tokens > 0 -> admit and take one, tokens == 0 ->
    deny) over an in-process table keyed by scope (a cgroup dir or a
    tenant), consulted a mount-path operation rather than a device access.
"""

from __future__ import annotations

import struct

from gpumounter_tpu_torch.cgroup.ebpf import (
    BPF_FUNC_map_lookup_elem,
    BPF_PSEUDO_MAP_FD,
    POLICY_UNMETERED,
    policy_tokens,
    policy_value,
    policy_weight,
    telemetry_key,
)
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.metrics import REGISTRY

THROTTLES = REGISTRY.counter(
    "tpumounter_vchip_throttled_total",
    "Device-access admits denied by an exhausted share token budget "
    "(userspace policy engine; the in-kernel path denies silently and "
    "is observed via the telemetry attempt counters instead)")

_U64 = 0xFFFFFFFFFFFFFFFF


def _u64(v: int) -> int:
    return v & _U64 if v >= 0 else (v + (1 << 64)) & _U64


def interpret_device_program(prog: bytes, maps: dict[int, dict[int, int]], dev_type: int,
                             access: int, major: int, minor: int,
                             max_steps: int = 100_000) -> int:
    """Run a device program over dict-backed maps; returns r0 (1 allow, 0
    deny). `maps` is keyed by the map fd in the program's ld_imm64
    relocations, and is mutated as the kernel mutates the real maps
    (telemetry counts bumped, tokens taken)."""
    regs: dict[int, object] = {i: 0 for i in range(11)}
    ctx = {0: ((access << 16) | dev_type) & 0xFFFFFFFF, 4: major & 0xFFFFFFFF,
           8: minor & 0xFFFFFFFF}
    regs[1] = ("ctx",)
    regs[10] = ("fp",)
    stack: dict[int, int] = {}
    insns = [struct.unpack("<BBhi", prog[i:i + 8]) for i in range(0, len(prog), 8)]
    pc = 0
    steps = 0
    while pc < len(insns):
        steps += 1
        if steps > max_steps:
            raise ValueError("runaway device program")
        op, regbyte, off, imm = insns[pc]
        dst, src = regbyte & 0xF, regbyte >> 4
        if op == 0x61:        # LDX_MEM_W
            ptr = regs[src]
            if ptr != ("ctx",):
                raise ValueError(f"LDX_W from non-ctx pointer {ptr!r}")
            regs[dst] = ctx[off]
        elif op == 0x79:      # LDX_MEM_DW (a map value)
            ptr = regs[src]
            if not (isinstance(ptr, tuple) and ptr[0] == "val"):
                raise ValueError(f"LDX_DW from non-value pointer {ptr!r}")
            _, fd, key = ptr
            regs[dst] = maps[fd][key]
        elif op == 0x7B:      # STX_MEM_DW (to the stack)
            if regs[dst] != ("fp",):
                raise ValueError("STX_DW to non-stack pointer")
            stack[off] = _u64(regs[src])  # type: ignore[arg-type]
        elif op == 0x18:      # LD_IMM64 (two slots)
            imm_hi = insns[pc + 1][3]
            value = (imm & 0xFFFFFFFF) | ((imm_hi & 0xFFFFFFFF) << 32)
            regs[dst] = ("map", value & 0xFFFFFFFF) if src == BPF_PSEUDO_MAP_FD else value
            pc += 1
        elif op == 0xB7:      # MOV64_IMM
            regs[dst] = _u64(imm)
        elif op == 0xBF:      # MOV64_REG
            regs[dst] = regs[src]
        elif op == 0x07:      # ADD64_IMM
            if regs[dst] == ("fp",):
                regs[dst] = ("fp+", off, imm)
            else:
                regs[dst] = _u64(regs[dst] + imm)  # type: ignore[operator]
        elif op == 0x57:      # AND64_IMM (sign-extended)
            regs[dst] = regs[dst] & _u64(imm)  # type: ignore[operator]
        elif op == 0x4F:      # OR64_REG
            regs[dst] = _u64(regs[dst] | regs[src])  # type: ignore[operator]
        elif op == 0x67:      # LSH64_IMM
            regs[dst] = _u64(regs[dst] << imm)  # type: ignore[operator]
        elif op == 0x77:      # RSH64_IMM
            regs[dst] = regs[dst] >> imm  # type: ignore[operator]
        elif op == 0x55:      # JNE_IMM
            if regs[dst] != _u64(imm):
                pc += off
        elif op == 0x15:      # JEQ_IMM
            if regs[dst] == _u64(imm):
                pc += off
        elif op == 0x1D:      # JEQ_REG
            if regs[dst] == regs[src]:
                pc += off
        elif op == 0x85:      # CALL
            if imm != BPF_FUNC_map_lookup_elem:
                raise ValueError(f"unsupported helper {imm}")
            mreg, kreg = regs[1], regs[2]
            if not (isinstance(mreg, tuple) and mreg[0] == "map"):
                raise ValueError("lookup r1 is not a map pointer")
            if not (isinstance(kreg, tuple) and kreg[0] == "fp+"):
                raise ValueError("lookup r2 is not a stack pointer")
            key = stack[kreg[2]]
            fd = mreg[1]
            table = maps.setdefault(fd, {})
            regs[0] = ("val", fd, key) if key in table else 0
            for clobbered in (1, 2, 3, 4, 5):
                regs[clobbered] = ("scratch",)
        elif op == 0xDB:      # XADD_DW
            ptr = regs[dst]
            if not (isinstance(ptr, tuple) and ptr[0] == "val"):
                raise ValueError("XADD to non-value pointer")
            _, fd, key = ptr
            maps[fd][key] = _u64(maps[fd][key] + regs[src])  # type: ignore[operator]
        elif op == 0x95:      # EXIT
            return int(regs[0])  # type: ignore[arg-type]
        else:
            raise ValueError(f"unknown opcode {op:#x}")
        pc += 1
    raise ValueError("fell off end of device program")


class UserspacePolicyEngine:
    """An in-process policy table with the in-kernel map's admit and deny,
    for environments without one.

    Scopes are opaque strings (a cgroup dir on v1 hosts, "ns/pod" on fake
    backends); entries are the packed values the kernel map holds, so the
    two compare value for value. `admit` returns None on a miss: the caller
    falls through to its static access control, as the program does.

    `enforce=False` makes a bookkeeper that admits everything: the negative
    control, whose decisions must diverge from the interpreter's."""

    def __init__(self, enforce: bool = True):
        self.enforce = enforce
        self._mu = OrderedLock("cgroup.policy_engine")
        self._tables: dict[str, dict[int, int]] = {}

    def set_policy(self, scope: str, major: int, minor: int, weight: int,
                   tokens: int = POLICY_UNMETERED) -> None:
        with self._mu:
            table = self._tables.setdefault(scope, {})
            table[telemetry_key(major, minor)] = policy_value(weight, tokens)

    def clear_policy(self, scope: str, major: int, minor: int) -> None:
        with self._mu:
            table = self._tables.get(scope)
            if table is not None:
                table.pop(telemetry_key(major, minor), None)
                if not table:
                    self._tables.pop(scope, None)

    def drop_scope(self, scope: str) -> None:
        with self._mu:
            self._tables.pop(scope, None)

    def entries(self, scope: str) -> dict[int, int]:
        with self._mu:
            return dict(self._tables.get(scope, {}))

    def scopes(self) -> list[str]:
        with self._mu:
            return list(self._tables)

    def admit(self, scope: str, major: int, minor: int) -> bool | None:
        """None: no entry (static rules decide); True: admitted (one token
        taken unless unmetered); False: throttled."""
        key = telemetry_key(major, minor)
        with self._mu:
            table = self._tables.get(scope)
            if table is None or key not in table:
                return None
            value = table[key]
            tokens = policy_tokens(value)
            if tokens == POLICY_UNMETERED:
                return True
            if tokens == 0:
                if not self.enforce:
                    return True
                THROTTLES.inc()
                return False
            table[key] = value - 1
            return True

    def refill(self, scope: str, major: int, minor: int, tokens: int) -> None:
        """Set the budget again, keeping the entry's weight (the write the
        kernel path makes with update_policy)."""
        key = telemetry_key(major, minor)
        with self._mu:
            table = self._tables.get(scope)
            if table is None or key not in table:
                return
            table[key] = policy_value(policy_weight(table[key]), tokens)

    def reset(self) -> None:
        with self._mu:
            self._tables.clear()


POLICY_ENGINE = UserspacePolicyEngine()
