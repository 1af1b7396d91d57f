"""cgroup-v2 device access control through BPF_PROG_TYPE_CGROUP_DEVICE.

The counterpart of ``gpumounter_tpu/cgroup/ebpf.py``. The original
GPUMounter is cgroup-v1 only (``cgroup.go:115-118``): it writes
``devices.allow``. On cgroup v2 there is no such file; device access is
decided by eBPF programs attached to the cgroup with attach type
BPF_CGROUP_DEVICE.

With BPF_F_ALLOW_MULTI *every* attached program must return 1 for an access
to pass (the kernel ANDs them), so a GPU cannot be granted by attaching one
more program: the runtime's own program (runc attaches one per container)
would still deny it. The controller **replaces** it:

  1. On a cgroup's first grant, query its attached device programs and take
     an fd to each (the fd keeps the program alive after its detach).
  2. Attach our program: runc's default container rules, the pod's own
     GPUs and the nodes its /dev was started with, and the hot-granted set.
  3. Detach the originals.
  4. When the last hot grant is revoked, re-attach the originals from the
     saved fds and detach ours: an exact restore.

Where the kernel can create BPF maps, the hot grants live in a per-cgroup
policy map that the program consults, so the program is loaded once per
cgroup and every later grant or revoke is a map write; elsewhere each batch
loads a program carrying every rule.

Everything speaks bpf(2) through ctypes (no libbpf), and the program is
assembled here. Its logic is runc's for v2 containers:

    r2 = ctx->access_type & 0xFFFF      ; device type (1=block, 2=char)
    r3 = ctx->access_type >> 16         ; access bits (1=mknod,2=read,4=write)
    r4 = ctx->major
    r5 = ctx->minor
    for each rule:
        type/major/minor mismatch -> next
        requested access not a subset of rule access -> next
        return 1
    return 0

``SYS_BPF`` is x86_64's number; on any other machine the wrappers raise
``UnsupportedMachineError``, naming the machine, and issue no syscall.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import json
import os
import platform
import struct
import threading
from dataclasses import dataclass, field

from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY, _fmt_labels

logger = get_logger("cgroup.ebpf")

# --- kernel ABI constants (linux/bpf.h) ---

SYS_BPF = 321  # x86_64
SYS_BPF_MACHINE = "x86_64"
BPF_MAP_CREATE = 0
BPF_MAP_LOOKUP_ELEM = 1
BPF_MAP_UPDATE_ELEM = 2
BPF_MAP_DELETE_ELEM = 3
BPF_MAP_GET_NEXT_KEY = 4
BPF_PROG_LOAD = 5
BPF_OBJ_PIN = 6
BPF_OBJ_GET = 7
BPF_PROG_ATTACH = 8
BPF_PROG_DETACH = 9
BPF_PROG_GET_FD_BY_ID = 13
BPF_PROG_QUERY = 16

BPF_MAP_TYPE_HASH = 1
BPF_NOEXIST = 1        # map_update flag: create only, keep existing value
BPF_PSEUDO_MAP_FD = 1  # ld_imm64 src marking the imm as a map fd
BPF_FUNC_map_lookup_elem = 1

BPF_PROG_TYPE_CGROUP_DEVICE = 15
BPF_CGROUP_DEVICE = 6
BPF_F_ALLOW_MULTI = 2

BPF_DEVCG_DEV_BLOCK = 1
BPF_DEVCG_DEV_CHAR = 2
BPF_DEVCG_ACC_MKNOD = 1
BPF_DEVCG_ACC_READ = 2
BPF_DEVCG_ACC_WRITE = 4

# --- instruction opcodes ---

OP_LDX_MEM_W = 0x61   # dst = *(u32 *)(src + off)
OP_LDX_MEM_DW = 0x79  # dst = *(u64 *)(src + off)
OP_STX_MEM_DW = 0x7B  # *(u64 *)(dst + off) = src
OP_LD_IMM64 = 0x18    # 16-byte: dst = imm64 (src=BPF_PSEUDO_MAP_FD -> map)
OP_MOV64_IMM = 0xB7
OP_MOV64_REG = 0xBF
OP_ADD64_IMM = 0x07
OP_AND64_IMM = 0x57
OP_OR64_REG = 0x4F
OP_LSH64_IMM = 0x67
OP_RSH64_IMM = 0x77
OP_JNE_IMM = 0x55
OP_JEQ_IMM = 0x15
OP_JEQ_REG = 0x1D
OP_CALL = 0x85
OP_EXIT = 0x95
OP_XADD_DW = 0xDB     # lock *(u64 *)(dst + off) += src

INSN_SIZE = 8


def insn(op: int, dst: int = 0, src: int = 0, off: int = 0, imm: int = 0) -> bytes:
    return struct.pack("<BBhi", op, (src << 4) | dst, off, imm)


def insn_ld_imm64(dst: int, imm: int, src: int = 0) -> bytes:
    """The one 16-byte instruction: dst = a 64-bit immediate. With
    src=BPF_PSEUDO_MAP_FD the verifier turns imm (a map fd) into a map
    pointer at load time."""
    lo = imm & 0xFFFFFFFF
    hi = (imm >> 32) & 0xFFFFFFFF
    lo = lo - (1 << 32) if lo >= 1 << 31 else lo
    hi = hi - (1 << 32) if hi >= 1 << 31 else hi
    return (struct.pack("<BBhi", OP_LD_IMM64, (src << 4) | dst, 0, lo)
            + struct.pack("<BBhi", 0, 0, 0, hi))


_ACCESS_BITS = {"r": BPF_DEVCG_ACC_READ, "w": BPF_DEVCG_ACC_WRITE, "m": BPF_DEVCG_ACC_MKNOD}
_TYPE_BITS = {"c": BPF_DEVCG_DEV_CHAR, "b": BPF_DEVCG_DEV_BLOCK, "a": 0}


@dataclass(frozen=True)
class DeviceRule:
    """One allow-list entry: type 'c'/'b'/'a' (any), major/minor (None =
    any), access a subset of "rwm"."""
    type: str
    major: int | None
    minor: int | None
    access: str

    def access_mask(self) -> int:
        mask = 0
        for ch in self.access:
            mask |= _ACCESS_BITS[ch]
        return mask


# runc's default AllowedDevices for a container: our program keeps them, so
# the container's ordinary /dev works as before.
DEFAULT_CONTAINER_RULES: tuple[DeviceRule, ...] = (
    DeviceRule("c", None, None, "m"),     # mknod any char device
    DeviceRule("b", None, None, "m"),     # mknod any block device
    DeviceRule("c", 1, 3, "rwm"),         # /dev/null
    DeviceRule("c", 1, 5, "rwm"),         # /dev/zero
    DeviceRule("c", 1, 7, "rwm"),         # /dev/full
    DeviceRule("c", 1, 8, "rwm"),         # /dev/random
    DeviceRule("c", 1, 9, "rwm"),         # /dev/urandom
    DeviceRule("c", 5, 0, "rwm"),         # /dev/tty
    DeviceRule("c", 5, 1, "rwm"),         # /dev/console
    DeviceRule("c", 5, 2, "rwm"),         # /dev/ptmx
    DeviceRule("c", 136, None, "rwm"),    # /dev/pts/*
    DeviceRule("c", 10, 200, "rwm"),      # /dev/net/tun
)


def device_rule(dev: GpuDevice, access: str = "rw") -> DeviceRule:
    return DeviceRule("c", dev.major, dev.minor, access)


def telemetry_key(major: int, minor: int) -> int:
    """The map key of one device, (major << 32) | minor: what the program
    computes and what the reader looks up."""
    return ((major & 0xFFFFFFFF) << 32) | (minor & 0xFFFFFFFF)


def _telemetry_block(map_fd: int) -> bytes:
    """A preamble that counts every access attempt in a per-cgroup hash
    map: key (major << 32) | minor, value a u64 bumped by an atomic add.
    It runs before the decision, so denied attempts count too. The
    controller seeds the keys at grant time (a lookup miss is skipped), and
    a reader reads the map with lookups: no program swap reads or resets
    the counts."""
    out = bytearray()
    out += insn(OP_MOV64_REG, dst=6, src=1)            # save ctx (r1 dies at call)
    out += insn(OP_LDX_MEM_W, dst=4, src=1, off=4)     # major
    out += insn(OP_LDX_MEM_W, dst=5, src=1, off=8)     # minor
    out += insn(OP_LSH64_IMM, dst=4, imm=32)
    out += insn(OP_OR64_REG, dst=4, src=5)             # r4 = key
    out += insn(OP_STX_MEM_DW, dst=10, src=4, off=-8)  # key -> stack
    out += insn_ld_imm64(dst=1, imm=map_fd, src=BPF_PSEUDO_MAP_FD)
    out += insn(OP_MOV64_REG, dst=2, src=10)
    out += insn(OP_ADD64_IMM, dst=2, imm=-8)           # r2 = &key
    out += insn(OP_CALL, imm=BPF_FUNC_map_lookup_elem)
    out += insn(OP_JEQ_IMM, dst=0, off=2, imm=0)       # not seeded: skip
    out += insn(OP_MOV64_IMM, dst=1, imm=1)
    out += insn(OP_XADD_DW, dst=0, src=1, off=0)       # lock (*value)++
    out += insn(OP_MOV64_REG, dst=1, src=6)            # restore ctx
    return bytes(out)


# --- grants that carry a policy ---
#
# On the map path a grant is one u64 entry in a per-cgroup BPF hash map,
# keyed as the telemetry map ((major << 32) | minor). The value packs the
# share's policy:
#
#     bits 48..63  QoS weight   (u16; advisory, read by the scheduler)
#     bits 32..47  reserved (0)
#     bits  0..31  token budget (u32 admits left, decremented in the kernel
#                                a check; POLICY_UNMETERED is never
#                                decremented)
#
# The program's policy block looks the key up: an entry with tokens left
# admits (and takes one), tokens == 0 denies, and a miss falls through to
# the static rules (base + defaults). So grant, re-grant, re-weight and
# revoke are map writes, and the program is loaded once per cgroup. The
# budget is refilled from userspace.

POLICY_UNMETERED = 0xFFFFFFFF  # token field sentinel: admit, never decrement


def policy_value(weight: int, tokens: int = POLICY_UNMETERED) -> int:
    """Pack one share's (QoS weight, token budget) into a map value."""
    return ((weight & 0xFFFF) << 48) | (tokens & 0xFFFFFFFF)


def policy_weight(value: int) -> int:
    return (value >> 48) & 0xFFFF


def policy_tokens(value: int) -> int:
    return value & 0xFFFFFFFF


def _policy_block(map_fd: int) -> bytes:
    """The in-kernel admit or deny with its token bucket, before the static
    rules. It saves and restores ctx, so it follows the telemetry block
    (which then counts denied attempts too).

    The device key's policy-map entry decides:
      miss                  -> fall through to the static rules
      tokens == UNMETERED   -> allow, no decrement
      tokens >  0           -> allow, atomically take one token
      tokens == 0           -> deny (throttled)

    A present entry governs the device, so not even the mknod-any default
    admits a throttled GPU. The decrement is approximate under concurrency
    (two CPUs can both see tokens == 1); the refiller re-clamps."""
    out = bytearray()
    out += insn(OP_MOV64_REG, dst=6, src=1)            # save ctx
    out += insn(OP_LDX_MEM_W, dst=4, src=1, off=4)     # major
    out += insn(OP_LDX_MEM_W, dst=5, src=1, off=8)     # minor
    out += insn(OP_LSH64_IMM, dst=4, imm=32)
    out += insn(OP_OR64_REG, dst=4, src=5)             # r4 = key
    out += insn(OP_STX_MEM_DW, dst=10, src=4, off=-8)  # key -> stack
    out += insn_ld_imm64(dst=1, imm=map_fd, src=BPF_PSEUDO_MAP_FD)
    out += insn(OP_MOV64_REG, dst=2, src=10)
    out += insn(OP_ADD64_IMM, dst=2, imm=-8)           # r2 = &key
    out += insn(OP_CALL, imm=BPF_FUNC_map_lookup_elem)
    out += insn(OP_JEQ_IMM, dst=0, off=14, imm=0)      # miss: static rules
    out += insn(OP_LDX_MEM_DW, dst=7, src=0, off=0)    # r7 = value
    out += insn(OP_MOV64_REG, dst=8, src=7)
    out += insn(OP_LSH64_IMM, dst=8, imm=32)
    out += insn(OP_RSH64_IMM, dst=8, imm=32)           # r8 = tokens
    out += insn_ld_imm64(dst=9, imm=POLICY_UNMETERED)
    out += insn(OP_JEQ_REG, dst=8, src=9, off=5)       # unmetered: allow
    out += insn(OP_JNE_IMM, dst=8, off=2, imm=0)       # tokens left: consume
    out += insn(OP_MOV64_IMM, dst=0, imm=0)            # throttled: deny
    out += insn(OP_EXIT)
    out += insn(OP_MOV64_IMM, dst=1, imm=-1)
    out += insn(OP_XADD_DW, dst=0, src=1, off=0)       # lock tokens--
    out += insn(OP_MOV64_IMM, dst=0, imm=1)            # allow
    out += insn(OP_EXIT)
    out += insn(OP_MOV64_REG, dst=1, src=6)            # miss path: restore ctx
    return bytes(out)


def build_device_program(rules: list[DeviceRule] | tuple[DeviceRule, ...],
                         telemetry_map_fd: int | None = None,
                         policy_map_fd: int | None = None) -> bytes:
    """Assemble the allow-list program; returns the raw bpf_insn bytes.

    With `telemetry_map_fd` the program also counts every access attempt in
    that map (_telemetry_block); allow and deny are unchanged. With
    `policy_map_fd` the granted devices are admitted by their policy-map
    entries (_policy_block) before the static rules, so `rules` need only
    carry the base and default set."""
    out = bytearray()
    if telemetry_map_fd is not None:
        out += _telemetry_block(telemetry_map_fd)
    if policy_map_fd is not None:
        out += _policy_block(policy_map_fd)
    # prologue: unpack ctx (r1) into r2=type, r3=access, r4=major, r5=minor
    out += insn(OP_LDX_MEM_W, dst=2, src=1, off=0)
    out += insn(OP_MOV64_REG, dst=3, src=2)
    out += insn(OP_RSH64_IMM, dst=3, imm=16)
    out += insn(OP_AND64_IMM, dst=2, imm=0xFFFF)
    out += insn(OP_LDX_MEM_W, dst=4, src=1, off=4)
    out += insn(OP_LDX_MEM_W, dst=5, src=1, off=8)

    for rule in rules:
        checks: list[tuple[int, int]] = []  # (reg, expected) for the JNE guards
        type_bits = _TYPE_BITS[rule.type]
        if type_bits:
            checks.append((2, type_bits))
        if rule.major is not None:
            checks.append((4, rule.major))
        if rule.minor is not None:
            checks.append((5, rule.minor))
        # the block's tail after its guards:
        #   mov r6, r3; and r6, ~mask; jne r6,0,+2; mov r0,1; exit
        tail_len = 5
        # each guard jumps past the rest of this rule's block
        for i, (reg, expected) in enumerate(checks):
            remaining = (len(checks) - i - 1) + tail_len
            out += insn(OP_JNE_IMM, dst=reg, off=remaining, imm=expected)
        inv_mask = (~rule.access_mask()) & 0xFFFFFFFF
        inv_imm = inv_mask - (1 << 32) if inv_mask >= 1 << 31 else inv_mask  # signed imm32
        out += insn(OP_MOV64_REG, dst=6, src=3)
        out += insn(OP_AND64_IMM, dst=6, imm=inv_imm)
        out += insn(OP_JNE_IMM, dst=6, off=2, imm=0)
        out += insn(OP_MOV64_IMM, dst=0, imm=1)
        out += insn(OP_EXIT)

    out += insn(OP_MOV64_IMM, dst=0, imm=0)
    out += insn(OP_EXIT)
    return bytes(out)


# --- bpf(2) through ctypes ---

_libc = ctypes.CDLL(None, use_errno=True)

# The attr of bpf(2) is a union into which the kernel also WRITES output
# fields at fixed offsets: BPF_PROG_QUERY writes query.prog_cnt (offset 24),
# query.attach_flags (12) and, from Linux 6.3, query.revision (8 bytes at
# 56), whatever size the caller declared. A buffer sized to the input fields
# alone lets the kernel write past it (heap corruption, seen on a 6.18
# kernel). So every call hands the kernel a buffer at least as large as its
# union bpf_attr; a zero tail is legal (bpf_check_uarg_tail_zero).
BPF_ATTR_SIZE = 256  # > sizeof(union bpf_attr) on any current kernel


class BpfError(OSError):
    pass


class UnsupportedMachineError(BpfError):
    """bpf(2)'s syscall number is known here for x86_64 only."""


def _bpf(cmd: int, attr: bytes) -> tuple[int, bytes]:
    """bpf(2) with a full-size zero-padded attr; returns (ret, attr_out).

    ret < 0 is a failure whose errno the caller reads with
    ctypes.get_errno(); attr_out is the attr after the call, for the fields
    the kernel wrote. Raises UnsupportedMachineError, without a syscall, on
    a machine other than x86_64."""
    machine = platform.machine()
    if machine != SYS_BPF_MACHINE:
        raise UnsupportedMachineError(
            errno.ENOSYS, f"bpf(2): this machine is {machine!r}; the syscall number here "
                          f"({SYS_BPF}) is {SYS_BPF_MACHINE}'s, so no syscall was issued")
    assert len(attr) <= BPF_ATTR_SIZE
    buf = ctypes.create_string_buffer(attr.ljust(BPF_ATTR_SIZE, b"\x00"), BPF_ATTR_SIZE)
    ret = _libc.syscall(SYS_BPF, cmd, buf, BPF_ATTR_SIZE)
    return ret, buf.raw


def _raise(what: str) -> None:
    err = ctypes.get_errno()
    raise BpfError(err, f"{what}: {os.strerror(err)}")


def prog_load(insns: bytes, name: str = "tpumounter_dev") -> int:
    """Load a CGROUP_DEVICE program; returns its fd."""
    insn_buf = ctypes.create_string_buffer(insns, len(insns))
    license_buf = ctypes.create_string_buffer(b"Apache-2.0\x00")
    log_buf = ctypes.create_string_buffer(65536)
    attr = struct.pack(
        "<II Q Q II Q II 16s",
        BPF_PROG_TYPE_CGROUP_DEVICE,
        len(insns) // INSN_SIZE,
        ctypes.addressof(insn_buf),
        ctypes.addressof(license_buf),
        1,                       # log_level
        len(log_buf),            # log_size
        ctypes.addressof(log_buf),
        0,                       # kern_version
        0,                       # prog_flags
        name.encode()[:15],
    )
    fd, _ = _bpf(BPF_PROG_LOAD, attr)
    if fd < 0:
        err = ctypes.get_errno()
        log = log_buf.value.decode(errors="replace").strip()
        raise BpfError(err, f"BPF_PROG_LOAD: {os.strerror(err)}"
                            + (f"; verifier: {log}" if log else ""))
    return fd


def _attach_attr(target_fd: int, attach_fd: int, flags: int = 0, replace_fd: int = 0) -> bytes:
    return struct.pack("<IIIII", target_fd, attach_fd, BPF_CGROUP_DEVICE, flags, replace_fd)


def prog_attach(cgroup_fd: int, prog_fd: int, flags: int = BPF_F_ALLOW_MULTI) -> None:
    ret, _ = _bpf(BPF_PROG_ATTACH, _attach_attr(cgroup_fd, prog_fd, flags))
    if ret < 0:
        _raise("BPF_PROG_ATTACH")


def prog_detach(cgroup_fd: int, prog_fd: int) -> None:
    ret, _ = _bpf(BPF_PROG_DETACH, _attach_attr(cgroup_fd, prog_fd))
    if ret < 0:
        _raise("BPF_PROG_DETACH")


_QUERY_FMT = "<IIII Q I"


def prog_query(cgroup_fd: int, max_progs: int = 64) -> list[int]:
    """The ids of the device programs attached to the cgroup itself."""
    ids = (ctypes.c_uint32 * max_progs)()
    attr = struct.pack(_QUERY_FMT, cgroup_fd, BPF_CGROUP_DEVICE, 0, 0,
                       ctypes.addressof(ids), max_progs)
    ret, out = _bpf(BPF_PROG_QUERY, attr)
    if ret < 0:
        _raise("BPF_PROG_QUERY")
    count = struct.unpack(_QUERY_FMT, out[:struct.calcsize(_QUERY_FMT)])[5]
    return [ids[i] for i in range(count)]


def prog_get_fd_by_id(prog_id: int) -> int:
    fd, _ = _bpf(BPF_PROG_GET_FD_BY_ID, struct.pack("<II", prog_id, 0))
    if fd < 0:
        _raise(f"BPF_PROG_GET_FD_BY_ID({prog_id})")
    return fd


def obj_pin(path: str, bpf_fd: int) -> None:
    """Pin a program or map to bpffs, so it outlives this process."""
    pathname = ctypes.create_string_buffer(path.encode())
    ret, _ = _bpf(BPF_OBJ_PIN, struct.pack("<QI", ctypes.addressof(pathname), bpf_fd))
    if ret < 0:
        _raise(f"BPF_OBJ_PIN({path})")


def obj_get(path: str) -> int:
    """Open a pinned object again; returns a new fd."""
    pathname = ctypes.create_string_buffer(path.encode())
    fd, _ = _bpf(BPF_OBJ_GET, struct.pack("<QI", ctypes.addressof(pathname), 0))
    if fd < 0:
        _raise(f"BPF_OBJ_GET({path})")
    return fd


# --- maps ---
#
# The map-op layout of union bpf_attr: map_fd at offset 0, then the 8-byte
# aligned key, value-or-next_key and flags.

_MAP_OP_FMT = "<I4xQQQ"


def map_create(key_size: int = 8, value_size: int = 8, max_entries: int = 1024,
               name: str = "tpum_telemetry") -> int:
    """Create a BPF_MAP_TYPE_HASH; returns its fd. Raises BpfError where
    maps are unavailable (no CAP_BPF / CAP_SYS_ADMIN, seccomp, an old
    kernel)."""
    attr = struct.pack("<IIIIIII16s", BPF_MAP_TYPE_HASH, key_size, value_size,
                       max_entries, 0, 0, 0, name.encode()[:15])
    fd, _ = _bpf(BPF_MAP_CREATE, attr)
    if fd < 0:
        _raise("BPF_MAP_CREATE")
    return fd


def map_lookup(map_fd: int, key: int) -> int | None:
    """The u64 value of a u64 key, or None when absent. A pure read."""
    key_buf = ctypes.create_string_buffer(struct.pack("<Q", key), 8)
    val_buf = ctypes.create_string_buffer(8)
    attr = struct.pack(_MAP_OP_FMT, map_fd, ctypes.addressof(key_buf),
                       ctypes.addressof(val_buf), 0)
    ret, _ = _bpf(BPF_MAP_LOOKUP_ELEM, attr)
    if ret < 0:
        return None
    return struct.unpack("<Q", val_buf.raw)[0]


def map_update(map_fd: int, key: int, value: int = 0, flags: int = 0) -> None:
    key_buf = ctypes.create_string_buffer(struct.pack("<Q", key), 8)
    val_buf = ctypes.create_string_buffer(struct.pack("<Q", value), 8)
    attr = struct.pack(_MAP_OP_FMT, map_fd, ctypes.addressof(key_buf),
                       ctypes.addressof(val_buf), flags)
    ret, _ = _bpf(BPF_MAP_UPDATE_ELEM, attr)
    if ret < 0:
        err = ctypes.get_errno()
        if flags & BPF_NOEXIST and err == errno.EEXIST:  # already seeded
            return
        raise BpfError(err, f"BPF_MAP_UPDATE_ELEM: {os.strerror(err)}")


def map_delete(map_fd: int, key: int) -> None:
    """Remove a u64 key. ENOENT is not an error: a revoke of an entry
    already gone (a replay, a double revoke) is idempotent."""
    key_buf = ctypes.create_string_buffer(struct.pack("<Q", key), 8)
    attr = struct.pack(_MAP_OP_FMT, map_fd, ctypes.addressof(key_buf), 0, 0)
    ret, _ = _bpf(BPF_MAP_DELETE_ELEM, attr)
    if ret < 0:
        err = ctypes.get_errno()
        if err == errno.ENOENT:
            return
        raise BpfError(err, f"BPF_MAP_DELETE_ELEM: {os.strerror(err)}")


def map_keys(map_fd: int, limit: int = 4096) -> list[int]:
    """Every u64 key of the map (BPF_MAP_GET_NEXT_KEY)."""
    keys: list[int] = []
    key_buf = ctypes.create_string_buffer(8)
    next_buf = ctypes.create_string_buffer(8)
    # the first call, with no key, gives the first key
    have_cursor = False
    while len(keys) < limit:
        attr = struct.pack(_MAP_OP_FMT, map_fd,
                           ctypes.addressof(key_buf) if have_cursor else 0,
                           ctypes.addressof(next_buf), 0)
        ret, _ = _bpf(BPF_MAP_GET_NEXT_KEY, attr)
        if ret < 0:
            break  # ENOENT: the end
        key = struct.unpack("<Q", next_buf.raw)[0]
        keys.append(key)
        key_buf = ctypes.create_string_buffer(next_buf.raw, 8)
        have_cursor = True
    return keys


def probe_map_support() -> bool:
    """Can this kernel, at this privilege, create BPF maps?"""
    try:
        fd = map_create(max_entries=1)
    except BpfError:
        return False
    os.close(fd)
    return True


# --- what the kernel allows: bpf(2), and the cgroup2 and bpffs mounts ---

MNT_DETACH = 2  # umount2 flag: detach now, free once nothing uses the mount


def errno_name(err: int) -> str:
    return errno.errorcode.get(err, str(err))


def mount(fstype: str, target: str) -> str:
    """mount(2) of a `fstype` ("cgroup2" or "bpf") at `target`: "ok", or
    the errno's name."""
    source = "bpf" if fstype == "bpf" else "none"
    if _libc.mount(source.encode(), target.encode(), fstype.encode(), 0, None) == 0:
        return "ok"
    return errno_name(ctypes.get_errno())


def unmount(target: str) -> None:
    """umount2(2) of `target` with MNT_DETACH."""
    _libc.umount2(target.encode(), MNT_DETACH)


def kernel_probe(root: str) -> dict:
    """What this process may do: for a BPF map's creation, a device
    program's load, a cgroup2 mount at <root>/cgroup2 and a bpffs mount at
    <root>/bpffs, "ok" or the errno's name. The mounts that succeed stay
    for the caller to undo (``unmount``)."""
    probe = {}
    for name, make in (("map_create", lambda: map_create(max_entries=1)),
                       ("prog_load", lambda: prog_load(
                           build_device_program(DEFAULT_CONTAINER_RULES)))):
        try:
            os.close(make())
            probe[name] = "ok"
        except BpfError as exc:
            probe[name] = errno_name(exc.errno)
    for name, fstype in (("cgroup2", "cgroup2"), ("bpffs", "bpf")):
        target = os.path.join(root, name)
        os.makedirs(target)
        probe[f"{name}_mount"] = mount(fstype, target)
    return probe


# --- per-tenant device-access telemetry (the read side) ---

PROGRAM_SWAPS = REGISTRY.counter(
    "tpumounter_ebpf_program_swaps_total",
    "Device-program replacement cycles (grant/revoke). Telemetry "
    "collection reads maps only and must never move this counter")

MAP_GRANTS = REGISTRY.counter(
    "tpumounter_ebpf_map_grants_total",
    "Grants/revokes applied as pure policy-map writes — the O(1) warm "
    "path that must never move tpumounter_ebpf_program_swaps_total")

TELEMETRY_OVERFLOW_TENANT = "_overflow"


class DeviceAccessTelemetry:
    """Per-tenant device-access counts, merged from two sources:

      * records of the mount path (``record``): the grant events, the whole
        signal where no kernel map counts (cgroup v1, fake backends);
      * kernel readers: each V2DeviceController attaches a callable that
        reads its per-cgroup maps (attempt counts bumped by the program
        itself) with lookups, which swap no program and reset nothing.

    Beyond `max_tenants` distinct tenants, new ones fold into "_overflow",
    so a churning namespace cannot grow the exposition without bound."""

    def __init__(self, max_tenants: int = 256):
        self.max_tenants = max_tenants
        self._lock = threading.Lock()
        self._counts: dict[tuple[str, str], float] = {}  # (tenant, kind)
        self._readers: list = []

    def _bucket(self, tenant: str) -> str:
        tenants = {t for t, _ in self._counts}
        if tenant in tenants or len(tenants) < self.max_tenants:
            return tenant
        return TELEMETRY_OVERFLOW_TENANT

    def record(self, tenant: str, kind: str, count: float = 1.0) -> None:
        if not tenant or count <= 0:
            return
        with self._lock:
            key = (self._bucket(tenant), kind)
            self._counts[key] = self._counts.get(key, 0.0) + count

    def attach_kernel_reader(self, reader) -> None:
        """reader: () -> {(tenant, kind): count}, read from kernel maps."""
        with self._lock:
            if reader not in self._readers:
                self._readers.append(reader)

    def detach_kernel_reader(self, reader) -> None:
        with self._lock:
            if reader in self._readers:
                self._readers.remove(reader)

    def counts(self) -> dict[tuple[str, str], float]:
        """(tenant, kind) -> count: the records plus every kernel reader's."""
        with self._lock:
            merged = dict(self._counts)
            readers = list(self._readers)
        for reader in readers:
            try:
                for key, value in reader().items():
                    merged[key] = merged.get(key, 0.0) + value
            except Exception as exc:  # noqa: BLE001 — telemetry is advisory
                logger.warning("kernel telemetry reader failed: %s", exc)
        return merged

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


DEVICE_TELEMETRY = DeviceAccessTelemetry()


class _DeviceAccessMetric:
    """The telemetry table as per-tenant series of the registry, collected
    at render."""

    name = "tpumounter_device_access_total"
    help = ("Device-access events by tenant and kind (grant = mount-path "
            "cgroup grant; attempt = in-kernel access check, BPF-map "
            "counted)")

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        counts = DEVICE_TELEMETRY.counts()
        if not counts:
            lines.append(f"{self.name} 0")
        for (tenant, kind), value in sorted(counts.items()):
            lines.append(f"{self.name}{_fmt_labels({'tenant': tenant, 'kind': kind})} {value}")
        return lines

    def reset(self) -> None:
        DEVICE_TELEMETRY.reset()


REGISTRY.register(_DeviceAccessMetric())


# --- the controller ---

@dataclass
class _CgroupState:
    cgroup_fd: int
    original_fds: list[int]
    our_fd: int | None
    # (GPU major, minor) -> that grant's rule group: the GPU's rule and one
    # rw rule a companion (nvidiactl, nvidia-uvm, nvidia-uvm-tools). With
    # the companions inside each GPU's group, revoking one GPU never takes
    # a companion from another GPU that still needs it.
    granted: dict[tuple[int, int], tuple[DeviceRule, ...]]
    base_rules: list[DeviceRule]
    # The per-cgroup attempt-counter map and the tenant ("ns/pod") its
    # counts go to; None where kernel maps are unavailable. Not kept across
    # a restart of the worker: the counts start again at 0.
    telemetry_fd: int | None = None
    tenant: str = ""
    # The per-cgroup policy map the program consults (None: no kernel maps,
    # so each batch swaps a program carrying every rule), and the shadow of
    # its entries, key -> packed policy_value. enumerate_policies() reads
    # the map itself, so a drift between the two shows.
    policy_fd: int | None = None
    policies: dict[int, int] = field(default_factory=dict)


class V2DeviceController:
    """Hot grant and revoke of device access on cgroup v2 by program
    replacement.

    The fds that keep the container's original (runc) programs alive die
    with this process. So where a bpffs pin directory can be made
    (TPUMOUNTER_BPF_PIN_DIR, default /sys/fs/bpf/tpumounter), the originals,
    our program and the policy map are pinned there and the grant state is
    journaled as JSON under TPUMOUNTER_STATE_DIR: a restarted worker opens
    the pins again (BPF_OBJ_GET) and can still revoke and restore exactly.
    Without it the state is this process's only."""

    def __init__(self, pin_dir: str | None = None, state_dir: str | None = None):
        if pin_dir is None:
            pin_dir = os.environ.get("TPUMOUNTER_BPF_PIN_DIR", "/sys/fs/bpf/tpumounter")
        if state_dir is None:
            state_dir = os.environ.get("TPUMOUNTER_STATE_DIR", "/var/lib/tpumounter")
        self.pin_dir = pin_dir
        self.state_dir = state_dir
        self._pinning = self._probe_pin_dir()
        self._state: dict[str, _CgroupState] = {}
        # Serializes grant and revoke (gRPC threads) against gc_dead_cgroups
        # (the reaper): GC closes fds that a revoke in flight would use.
        self._mu = threading.RLock()
        # Where the kernel creates maps, each cgroup's program also counts
        # access attempts into a map that readers read with lookups.
        self._telemetry_maps = probe_map_support()
        if self._telemetry_maps:
            DEVICE_TELEMETRY.attach_kernel_reader(self._kernel_telemetry_counts)
        if self._pinning:
            self._restore_all()

    # --- persistence ---

    def _probe_pin_dir(self) -> bool:
        try:
            os.makedirs(self.pin_dir, exist_ok=True)
            os.makedirs(self.state_dir, exist_ok=True)
            return True
        except OSError as exc:
            logger.info("bpffs pinning unavailable (%s); v2 grant state is in-process only", exc)
            return False

    @staticmethod
    def _key(cgroup_dir: str) -> str:
        return hashlib.sha1(cgroup_dir.encode()).hexdigest()[:16]

    def _journal_path(self, cgroup_dir: str) -> str:
        return os.path.join(self.state_dir, self._key(cgroup_dir) + ".json")

    def _persist(self, cgroup_dir: str, st: _CgroupState) -> None:
        if not self._pinning:
            return
        key = self._key(cgroup_dir)
        try:
            for i, fd in enumerate(st.original_fds):
                pin = os.path.join(self.pin_dir, f"{key}-orig-{i}")
                if not os.path.exists(pin):
                    obj_pin(pin, fd)
            ours_pin = os.path.join(self.pin_dir, f"{key}-ours")
            if st.our_fd is not None:
                # Pin the new one, then rename over the old: unlinking first
                # would open a window with no pin of ours at all, after
                # which a restarted worker could never detach our program.
                # No dot in the name: bpffs refuses one (EPERM), so the
                # reference's "-ours.new" never pins on a real bpffs.
                tmp_pin = ours_pin + "-new"
                if os.path.exists(tmp_pin):
                    os.unlink(tmp_pin)
                obj_pin(tmp_pin, st.our_fd)
                os.replace(tmp_pin, ours_pin)
            if st.policy_fd is not None:
                # A restarted worker opens the same kernel map that the
                # still-attached program reads.
                pmap_pin = os.path.join(self.pin_dir, f"{key}-pmap")
                if not os.path.exists(pmap_pin):
                    obj_pin(pmap_pin, st.policy_fd)
            record = {
                "cgroup_dir": cgroup_dir,
                "n_orig": len(st.original_fds),
                "granted": [[maj, minor, [[r.type, r.major, r.minor, r.access] for r in group]]
                            for (maj, minor), group in st.granted.items()],
                "base_rules": [[r.type, r.major, r.minor, r.access] for r in st.base_rules],
                "policies": [[mkey, value] for mkey, value in st.policies.items()],
            }
            with open(self._journal_path(cgroup_dir), "w") as f:
                json.dump(record, f)
        except (BpfError, OSError) as exc:
            logger.warning("cannot persist v2 grant state for %s: %s", cgroup_dir, exc)

    def _unpersist(self, cgroup_dir: str, n_orig: int) -> None:
        if not self._pinning:
            return
        key = self._key(cgroup_dir)
        for name in [f"{key}-orig-{i}" for i in range(n_orig)] + [f"{key}-ours", f"{key}-pmap"]:
            try:
                os.unlink(os.path.join(self.pin_dir, name))
            except FileNotFoundError:
                pass
            except OSError as exc:
                logger.warning("cannot unpin %s: %s", name, exc)
        try:
            os.unlink(self._journal_path(cgroup_dir))
        except OSError:
            pass

    def _restore_all(self) -> None:
        """After a restart of the worker: open the pinned objects again."""
        try:
            entries = os.listdir(self.state_dir)
        except OSError:
            return
        for name in entries:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.state_dir, name)
            opened: list[int] = []
            record = None
            try:
                with open(path) as f:
                    record = json.load(f)
                cgroup_dir = record["cgroup_dir"]
                key = self._key(cgroup_dir)
                cgroup_fd = os.open(cgroup_dir, os.O_RDONLY | os.O_DIRECTORY)
                opened.append(cgroup_fd)
                original_fds = []
                for i in range(record["n_orig"]):
                    fd = obj_get(os.path.join(self.pin_dir, f"{key}-orig-{i}"))
                    opened.append(fd)
                    original_fds.append(fd)
                our_fd = None
                ours_pin = os.path.join(self.pin_dir, f"{key}-ours")
                if os.path.exists(ours_pin):
                    our_fd = obj_get(ours_pin)
                    opened.append(our_fd)
                policy_fd = None
                policies: dict[int, int] = {}
                pmap_pin = os.path.join(self.pin_dir, f"{key}-pmap")
                if os.path.exists(pmap_pin):
                    policy_fd = obj_get(pmap_pin)
                    opened.append(policy_fd)
                    policies = {int(k): int(v) for k, v in record.get("policies", [])}
                granted: dict[tuple[int, int], tuple[DeviceRule, ...]] = {}
                for entry in record["granted"]:
                    maj, minor, tail = entry[0], entry[1], entry[2]
                    if isinstance(tail, str):  # a journal from before companions
                        granted[(maj, minor)] = (DeviceRule("c", maj, minor, tail),)
                    else:
                        granted[(maj, minor)] = tuple(DeviceRule(t, m, n, a)
                                                      for t, m, n, a in tail)
                base_rules = [DeviceRule(t, maj, minor, access)
                              for t, maj, minor, access in record.get("base_rules", [])]
                self._state[cgroup_dir] = _CgroupState(
                    cgroup_fd=cgroup_fd, original_fds=original_fds, our_fd=our_fd,
                    granted=granted, base_rules=base_rules, policy_fd=policy_fd,
                    policies=policies)
                logger.info("restored v2 grant state for %s (%d grant(s))", cgroup_dir,
                            len(granted))
            except (OSError, BpfError, KeyError, ValueError, TypeError) as exc:
                # Not restorable (most often the container went while the
                # worker was down): release everything, the fds and the
                # pins (else each such container would keep its programs
                # pinned for good), then drop the journal.
                logger.warning("cannot restore v2 state %s: %s; dropping", path, exc)
                for fd in opened:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                known = isinstance(record, dict) and "cgroup_dir" in record
                key = self._key(record["cgroup_dir"]) if known else name[:-len(".json")]
                n_orig = record.get("n_orig", 64) if isinstance(record, dict) else 64
                for pin in ([f"{key}-orig-{i}" for i in range(n_orig)]
                            + [f"{key}-ours", f"{key}-ours-new", f"{key}-pmap"]):
                    try:
                        os.unlink(os.path.join(self.pin_dir, pin))
                    except OSError:
                        pass
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _get_state(self, cgroup_dir: str, base_rules: list[DeviceRule] | None) -> _CgroupState:
        st = self._state.get(cgroup_dir)
        if st is not None:
            return st
        cgroup_fd = os.open(cgroup_dir, os.O_RDONLY | os.O_DIRECTORY)
        original_fds = []
        try:
            for prog_id in prog_query(cgroup_fd):
                original_fds.append(prog_get_fd_by_id(prog_id))
        except BpfError as exc:
            # Fail: with no originals in hand, ours would be attached beside
            # runc's without its detach, and under ALLOW_MULTI (an AND) the
            # granted GPU would still be denied, a grant that does nothing.
            for fd in original_fds:
                os.close(fd)
            os.close(cgroup_fd)
            raise BpfError(exc.errno or 0, f"cannot query existing device progs on "
                                           f"{cgroup_dir} ({exc}); refusing to grant blindly"
                           ) from exc
        telemetry_fd = None
        policy_fd = None
        if self._telemetry_maps:
            try:
                telemetry_fd = map_create()
            except BpfError as exc:
                logger.warning("telemetry map create failed for %s: %s (userspace counting "
                               "only)", cgroup_dir, exc)
            try:
                policy_fd = map_create(name="tpum_policy")
            except BpfError as exc:
                logger.warning("policy map create failed for %s: %s (static-rule grants "
                               "with program swaps)", cgroup_dir, exc)
        st = _CgroupState(cgroup_fd=cgroup_fd, original_fds=original_fds, our_fd=None,
                          granted={}, base_rules=list(base_rules or []),
                          telemetry_fd=telemetry_fd, policy_fd=policy_fd)
        self._state[cgroup_dir] = st
        return st

    def _rules(self, st: _CgroupState) -> list[DeviceRule]:
        out = list(DEFAULT_CONTAINER_RULES) + st.base_rules
        if st.policy_fd is not None:
            # The grants live in the policy map: the static set is base +
            # defaults only, fixed for the cgroup's life, so one program
            # load serves every grant.
            return out
        seen: set[DeviceRule] = set(out)
        for group in st.granted.values():
            for rule in group:
                if rule not in seen:
                    seen.add(rule)
                    out.append(rule)
        return out

    def _swap_program(self, st: _CgroupState) -> None:
        PROGRAM_SWAPS.inc()
        new_fd = prog_load(build_device_program(self._rules(st), telemetry_map_fd=st.telemetry_fd,
                                                policy_map_fd=st.policy_fd))
        try:
            prog_attach(st.cgroup_fd, new_fd)
        except BpfError:
            os.close(new_fd)
            raise
        # detach what the new program supersedes
        stale = [st.our_fd] if st.our_fd is not None else list(st.original_fds)
        for fd in stale:
            try:
                prog_detach(st.cgroup_fd, fd)
            except BpfError as exc:
                logger.warning("detach of superseded device prog failed: %s", exc)
        if st.our_fd is not None:
            os.close(st.our_fd)
        st.our_fd = new_fd

    def has_state(self, cgroup_dir: str) -> bool:
        """Does this cgroup have grant state already (its base rules were
        taken at its first grant and are fixed now)?"""
        with self._mu:
            return cgroup_dir in self._state

    def enumerate_grants(self) -> dict[str, set[tuple[int, int]]]:
        """cgroup dir -> the (major, minor) GPUs granted there. After a
        restart this is what _restore_all brought back: what survives a
        crash."""
        with self._mu:
            return {cg: set(st.granted) for cg, st in self._state.items() if st.granted}

    def enumerate_policies(self) -> dict[str, dict[int, int]]:
        """cgroup dir -> {device key: packed policy value}, read from the
        kernel's map (not the shadow) wherever there is one."""
        out: dict[str, dict[int, int]] = {}
        with self._mu:
            for cg, st in self._state.items():
                if st.policy_fd is None:
                    continue
                entries: dict[int, int] = {}
                for mkey in map_keys(st.policy_fd):
                    value = map_lookup(st.policy_fd, mkey)
                    if value is not None:
                        entries[mkey] = value
                out[cg] = entries
        return out

    @staticmethod
    def _live_keys(st: _CgroupState) -> set[int]:
        return {telemetry_key(r.major, r.minor) for group in st.granted.values() for r in group
                if r.major is not None and r.minor is not None}

    def orphan_policy_keys(self) -> dict[str, list[int]]:
        """Map entries that no tracked grant refers to (left by a crash
        between a map write and the journal's, or by another writer).
        Detection only: gc_policy_orphans() removes them."""
        out: dict[str, list[int]] = {}
        with self._mu:
            for cg, st in self._state.items():
                if st.policy_fd is None:
                    continue
                live = self._live_keys(st)
                orphans = [k for k in map_keys(st.policy_fd) if k not in live]
                if orphans:
                    out[cg] = orphans
        return out

    def gc_policy_orphans(self) -> int:
        """Delete the orphaned policy-map entries; returns how many."""
        removed = 0
        with self._mu:
            for cg, orphans in self.orphan_policy_keys().items():
                st = self._state[cg]
                for mkey in orphans:
                    map_delete(st.policy_fd, mkey)
                    st.policies.pop(mkey, None)
                    removed += 1
                self._persist(cg, st)
                logger.info("GC'd %d orphan policy entr(ies) on %s", len(orphans), cg)
        return removed

    def _seed_telemetry(self, st: _CgroupState, devs: list[GpuDevice], tenant: str) -> None:
        """Remember the tenant and seed the telemetry keys (the program
        skips keys not seeded). BPF_NOEXIST keeps a counting key's value
        across re-grants."""
        if tenant:
            st.tenant = tenant
        if st.telemetry_fd is None:
            return
        for dev in devs:
            try:
                map_update(st.telemetry_fd, telemetry_key(dev.major, dev.minor), 0,
                           flags=BPF_NOEXIST)
            except BpfError as exc:
                logger.warning("telemetry key seed for %d:%d failed: %s", dev.major, dev.minor,
                               exc)

    @staticmethod
    def _map_total(map_fd: int) -> float:
        total = 0.0
        for key in map_keys(map_fd):
            value = map_lookup(map_fd, key)
            if value:
                total += value
        return total

    def _kernel_telemetry_counts(self) -> dict[tuple[str, str], float]:
        """The kernel reader of DEVICE_TELEMETRY: per-tenant attempt counts
        from every tracked cgroup's map, by lookups only. Under _mu: a
        revoke or GC closes telemetry fds, and a lookup on a recycled fd
        number would read another cgroup's map."""
        out: dict[tuple[str, str], float] = {}
        with self._mu:
            for cg, st in self._state.items():
                if st.telemetry_fd is None:
                    continue
                total = self._map_total(st.telemetry_fd)
                if total:
                    key = (st.tenant or cg, "attempt")
                    out[key] = out.get(key, 0.0) + total
        return out

    def grant(self, cgroup_dir: str, dev: GpuDevice, base_rules: list[DeviceRule] | None = None,
              tenant: str = "", policy: dict[str, tuple[int, int]] | None = None) -> None:
        with self._mu:
            self._grant_many_locked(cgroup_dir, [dev], base_rules, tenant=tenant, policy=policy)

    def grant_many(self, cgroup_dir: str, devs: list[GpuDevice],
                   base_rules: list[DeviceRule] | None = None, tenant: str = "",
                   policy: dict[str, tuple[int, int]] | None = None) -> None:
        """Grant a batch of GPUs: policy-map entries where the kernel has
        maps, one program swap otherwise.

        Map path: the first grant on a cgroup loads and attaches our program
        once (base rules + the policy-map lookup); every grant after it,
        this whole batch included, is one map update a GPU (and one a
        companion not yet present), and
        `tpumounter_ebpf_program_swaps_total` does not move. `policy` maps a
        GPU's uuid to (QoS weight, token budget); a GPU without one gets
        weight 0 and POLICY_UNMETERED (a whole-GPU grant). Legacy path: our
        program carries every rule, one swap a batch. Both are all or
        nothing: a failure puts the tracked grants back as they were."""
        with self._mu:
            self._grant_many_locked(cgroup_dir, devs, base_rules, tenant=tenant, policy=policy)

    @staticmethod
    def _policy_for(dev: GpuDevice, policy: dict[str, tuple[int, int]] | None) -> int:
        if policy and dev.uuid in policy:
            weight, tokens = policy[dev.uuid]
            return policy_value(weight, tokens)
        return policy_value(0, POLICY_UNMETERED)

    def _grant_many_locked(self, cgroup_dir: str, devs: list[GpuDevice],
                           base_rules: list[DeviceRule] | None = None, tenant: str = "",
                           policy: dict[str, tuple[int, int]] | None = None) -> None:
        st = self._get_state(cgroup_dir, base_rules)
        self._seed_telemetry(st, devs, tenant)
        priors = {}
        for dev in devs:
            key = (dev.major, dev.minor)
            priors[key] = st.granted.get(key)
            st.granted[key] = (device_rule(dev),) + tuple(
                DeviceRule("c", comp.major, comp.minor, "rw") for comp in dev.companions)
        try:
            if st.policy_fd is not None:
                if st.our_fd is None:
                    # once: attach the program that consults the map; the
                    # grants themselves are the map writes below
                    self._swap_program(st)
                prior_entries = dict(st.policies)
                try:
                    for dev in devs:
                        mkey = telemetry_key(dev.major, dev.minor)
                        value = self._policy_for(dev, policy)
                        map_update(st.policy_fd, mkey, value)
                        st.policies[mkey] = value
                        for comp in dev.companions:
                            ckey = telemetry_key(comp.major, comp.minor)
                            if ckey not in st.policies:
                                cval = policy_value(0, POLICY_UNMETERED)
                                map_update(st.policy_fd, ckey, cval)
                                st.policies[ckey] = cval
                    MAP_GRANTS.inc(float(len(devs)))
                except BpfError:
                    # Undo the entries this batch added or changed: the
                    # attached program over the restored map is exactly the
                    # policy from before the batch.
                    for mkey in list(st.policies):
                        if mkey not in prior_entries:
                            map_delete(st.policy_fd, mkey)
                            st.policies.pop(mkey, None)
                        elif st.policies[mkey] != prior_entries[mkey]:
                            map_update(st.policy_fd, mkey, prior_entries[mkey])
                            st.policies[mkey] = prior_entries[mkey]
                    raise
            else:
                self._swap_program(st)
        except BpfError:
            for key, prior in priors.items():
                if prior is None:
                    st.granted.pop(key, None)
                else:
                    st.granted[key] = prior
            if not st.granted and st.our_fd is None:
                self._close_state(cgroup_dir)
            raise
        self._persist(cgroup_dir, st)
        logger.info("cgroup v2: granted %d GPU rule group(s) on %s via %s", len(devs), cgroup_dir,
                    "map update (no swap)" if st.policy_fd is not None and st.our_fd is not None
                    else "program swap")

    def update_policy(self, cgroup_dir: str, dev: GpuDevice, weight: int,
                      tokens: int = POLICY_UNMETERED) -> None:
        """Re-weight or refill a grant in place: one map update, no swap."""
        with self._mu:
            st = self._state.get(cgroup_dir)
            if st is None or st.policy_fd is None:
                raise BpfError(0, f"no policy map for {cgroup_dir}; cannot update policy in place")
            mkey = telemetry_key(dev.major, dev.minor)
            if (dev.major, dev.minor) not in st.granted:
                raise BpfError(0, f"device {dev.major}:{dev.minor} not granted on {cgroup_dir}")
            value = policy_value(weight, tokens)
            map_update(st.policy_fd, mkey, value)
            st.policies[mkey] = value
            MAP_GRANTS.inc()
            self._persist(cgroup_dir, st)

    def revoke(self, cgroup_dir: str, dev: GpuDevice) -> None:
        with self._mu:
            self._revoke_locked(cgroup_dir, dev)

    def _revoke_locked(self, cgroup_dir: str, dev: GpuDevice) -> None:
        st = self._state.get(cgroup_dir)
        if st is None:
            logger.warning("revoke on untracked cgroup %s; no-op", cgroup_dir)
            return
        st.granted.pop((dev.major, dev.minor), None)
        if st.policy_fd is not None:
            # Delete the GPU's entry, then every companion entry that no
            # remaining group refers to: one left behind would keep kernel
            # access to a shared node the pod no longer holds a GPU for.
            mkey = telemetry_key(dev.major, dev.minor)
            map_delete(st.policy_fd, mkey)
            st.policies.pop(mkey, None)
            live = self._live_keys(st)
            for okey in [k for k in st.policies if k not in live]:
                map_delete(st.policy_fd, okey)
                st.policies.pop(okey, None)
            MAP_GRANTS.inc()
            if st.granted:
                self._persist(cgroup_dir, st)
                return
        elif st.granted:
            self._swap_program(st)
            self._persist(cgroup_dir, st)
            return
        # The last grant went: put the original programs back, exactly.
        restored = 0
        for fd in st.original_fds:
            try:
                prog_attach(st.cgroup_fd, fd)
                restored += 1
            except BpfError as exc:
                logger.error("cannot restore original device prog: %s", exc)
        if restored < len(st.original_fds):
            # Keep the state, and the fds that keep the originals alive, for
            # a retry of the revoke: closing them would free the kernel's
            # last reference to the runtime's policy.
            raise BpfError(0, f"restored only {restored}/{len(st.original_fds)} original "
                              f"device prog(s) on {cgroup_dir}; state kept for retry")
        if st.our_fd is not None:
            try:
                prog_detach(st.cgroup_fd, st.our_fd)
            except BpfError as exc:
                logger.warning("detach of our device prog failed: %s", exc)
            os.close(st.our_fd)
            st.our_fd = None
        self._unpersist(cgroup_dir, len(st.original_fds))
        self._close_state(cgroup_dir)
        logger.info("cgroup v2: revoked c %d:%d on %s (restored %d orig prog(s))", dev.major,
                    dev.minor, cgroup_dir, restored)

    def gc_dead_cgroups(self) -> list[str]:
        """Drop the grant state of cgroups whose directory is gone.

        A granted container can die while the worker lives on: the kernel
        destroys the cgroup and its programs, but our fds, pins and journal
        would stay, since no revoke comes. Returns the cgroup dirs
        collected."""
        with self._mu:
            dead = [cg for cg in list(self._state) if not os.path.isdir(cg)]
            for cg in dead:
                st = self._state[cg]
                self._unpersist(cg, len(st.original_fds))
                self._close_state(cg)
                logger.info("GC'd v2 grant state for dead cgroup %s (%d grant(s) released)",
                            cg, len(st.granted))
            return dead

    def _close_state(self, cgroup_dir: str) -> None:
        st = self._state.pop(cgroup_dir, None)
        if st is None:
            return
        for fd in st.original_fds:
            os.close(fd)
        if st.our_fd is not None:
            os.close(st.our_fd)
        if st.telemetry_fd is not None:
            # Fold the map's last counts into the table before the map goes,
            # so the exported per-tenant counter stays monotonic.
            try:
                total = self._map_total(st.telemetry_fd)
                if total:
                    DEVICE_TELEMETRY.record(st.tenant or cgroup_dir, "attempt", total)
            except Exception as exc:  # noqa: BLE001 — telemetry is advisory
                logger.warning("final telemetry harvest for %s failed: %s", cgroup_dir, exc)
            os.close(st.telemetry_fd)
        if st.policy_fd is not None:
            os.close(st.policy_fd)
        os.close(st.cgroup_fd)

    def close(self) -> None:
        DEVICE_TELEMETRY.detach_kernel_reader(self._kernel_telemetry_counts)
        with self._mu:
            for cgroup_dir in list(self._state):
                self._close_state(cgroup_dir)
