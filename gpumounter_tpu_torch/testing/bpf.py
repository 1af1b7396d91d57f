"""FakeBpf: a stand-in for the kernel's bpf(2) under a v2 device controller.

``with FakeBpf(maps=...).installed(ebpf):`` replaces the bpf(2) wrappers of
an eBPF module: this package's ``cgroup/ebpf.py``, or any module of the
same surface (the parity tests install one into the reference's too).
Program and map "fds" are real /dev/null fds, so that the controller's fd
lifecycle runs as it is; programs are ids (ours from 100, in load order),
maps are dicts numbered in creation order, and a pin is a file naming what
it pins, so that os.replace and os.unlink on pins behave as on bpffs and a
restarted controller opens the same object again. Knobs make one call
fail: ``fail_query`` (cgroup paths, "*" for all), ``fail_attach`` (prog
ids), ``fail_update`` (the number of map updates that succeed first).
``bpffs_names=True`` refuses a pin whose name holds a dot, as bpffs does
(EPERM); by default any name pins.

``verdict`` answers an access as the kernel would, every attached program
run by an interpreter; ``observe`` reads what a run left behind in terms
that do not depend on fd numbers.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import struct


def normalize(prog: bytes, fd_to_map: dict[int, int]) -> bytes:
    """The program with the imm of each map-fd ld_imm64 replaced by the
    map's number."""
    out = bytearray(prog)
    for i in range(0, len(prog), 8):
        op, regbyte, off, imm = struct.unpack("<BBhi", prog[i:i + 8])
        if op == 0x18 and regbyte >> 4 == 1:
            out[i:i + 8] = struct.pack("<BBhi", op, regbyte, off, fd_to_map[imm])
    return bytes(out)


class FakeBpf:
    def __init__(self, maps: bool = False, bpffs_names: bool = False):
        self.maps_supported = maps
        self.bpffs_names = bpffs_names
        self.next_id = 100
        self.fd2prog: dict[int, int] = {}
        self.progs: dict[int, bytes] = {}         # prog id -> normalized bytes
        self.loaded: set[int] = set()             # ids of the programs loaded here
        self.attached: dict[str, list[int]] = {}  # cgroup path -> prog ids
        self.map_objs: list[dict[int, int]] = []
        self.fd2map: dict[int, int] = {}          # fd -> map number
        self.fail_query: set[str] = set()
        self.fail_attach: set[int] = set()
        self.fail_update: int | None = None

    def _new_fd(self) -> int:
        fd = os.open("/dev/null", os.O_RDONLY)
        self.fd2prog.pop(fd, None)  # a number closed and given out again
        self.fd2map.pop(fd, None)
        return fd

    @staticmethod
    def _cg_of(cgroup_fd: int) -> str:
        return os.readlink(f"/proc/self/fd/{cgroup_fd}")

    def preattach(self, cgroup_dir: str, prog_id: int, insns: bytes | None = None) -> None:
        """A program the runtime attached before any grant (runc's); with
        its `insns`, ``verdict`` can run it."""
        self.attached.setdefault(os.path.realpath(cgroup_dir), []).append(prog_id)
        if insns is not None:
            self.progs[prog_id] = insns

    @contextlib.contextmanager
    def installed(self, ebpf):
        """`ebpf`'s bpf(2) wrappers replaced by this kernel's, for the
        block; the originals come back after it."""
        err = ebpf.BpfError

        def prog_load(insns, name="x"):
            pid = self.next_id
            self.next_id += 1
            self.loaded.add(pid)
            self.progs[pid] = normalize(insns, self.fd2map)
            fd = self._new_fd()
            self.fd2prog[fd] = pid
            return fd

        def prog_attach(cg_fd, fd, flags=0):
            pid = self.fd2prog[fd]
            if pid in self.fail_attach:
                raise err(errno.EPERM, f"BPF_PROG_ATTACH({pid}): refused")
            self.attached.setdefault(self._cg_of(cg_fd), []).append(pid)

        def prog_detach(cg_fd, fd):
            self.attached[self._cg_of(cg_fd)].remove(self.fd2prog[fd])

        def prog_query(cg_fd, max_progs=64):
            if self.fail_query & {"*", self._cg_of(cg_fd)}:
                raise err(errno.EPERM, "BPF_PROG_QUERY: Operation not permitted")
            return list(self.attached.get(self._cg_of(cg_fd), []))

        def prog_get_fd_by_id(pid):
            fd = self._new_fd()
            self.fd2prog[fd] = pid
            return fd

        def map_create(key_size=8, value_size=8, max_entries=1024, name="tpum_telemetry"):
            if not self.maps_supported:
                raise err(errno.EPERM, "BPF_MAP_CREATE: Operation not permitted")
            fd = self._new_fd()
            self.fd2map[fd] = len(self.map_objs)
            self.map_objs.append({})
            return fd

        def map_update(map_fd, key, value=0, flags=0):
            if self.fail_update is not None:
                if self.fail_update <= 0:
                    raise err(errno.ENOMEM, "BPF_MAP_UPDATE_ELEM: Cannot allocate memory")
                self.fail_update -= 1
            table = self.map_objs[self.fd2map[map_fd]]
            if flags & ebpf.BPF_NOEXIST and key in table:
                return
            table[key] = value

        def obj_pin(path, fd):
            if self.bpffs_names and "." in os.path.basename(path):
                raise err(errno.EPERM, f"BPF_OBJ_PIN({path}): Operation not permitted")
            what = f"map:{self.fd2map[fd]}" if fd in self.fd2map else f"prog:{self.fd2prog[fd]}"
            with open(path, "w") as f:
                f.write(what)

        def obj_get(path):
            with open(path) as f:
                kind, ref = f.read().split(":")
            fd = self._new_fd()
            if kind == "map":
                self.fd2map[fd] = int(ref)
            else:
                self.fd2prog[fd] = int(ref)
            return fd

        stubs = {
            "prog_load": prog_load, "prog_attach": prog_attach, "prog_detach": prog_detach,
            "prog_query": prog_query, "prog_get_fd_by_id": prog_get_fd_by_id,
            "map_create": map_create, "map_update": map_update,
            "map_delete": lambda fd, key: self.map_objs[self.fd2map[fd]].pop(key, None),
            "map_lookup": lambda fd, key: self.map_objs[self.fd2map[fd]].get(key),
            "map_keys": lambda fd, limit=4096: list(self.map_objs[self.fd2map[fd]])[:limit],
            "obj_pin": obj_pin, "obj_get": obj_get,
            "probe_map_support": lambda: self.maps_supported,
        }
        saved = {name: getattr(ebpf, name) for name in stubs}
        try:
            for name, fn in stubs.items():
                setattr(ebpf, name, fn)
            yield self
        finally:
            for name, fn in saved.items():
                setattr(ebpf, name, fn)

    def verdict(self, interpret, cgroup_dir: str, dev_type: int, access: int, major: int,
                minor: int) -> int:
        """The kernel's answer to one access: every attached program must
        allow it (ALLOW_MULTI). `interpret` runs one program
        (``cgroup/policy.py``'s ``interpret_device_program``)."""
        programs = self.attached.get(os.path.realpath(cgroup_dir), [])
        unknown = [p for p in programs if p not in self.progs]
        if unknown:
            raise ValueError(f"programs {unknown} attached to {cgroup_dir} have no code here")
        maps = dict(enumerate(self.map_objs))
        return int(all(interpret(self.progs[p], maps, dev_type, access, major, minor)
                       for p in programs))

    def describe(self, pid: int):
        return ("ours", pid, self.progs[pid].hex()) if pid in self.loaded else ("orig", pid)

    def observe(self, ctl, root: str, cgroups: dict[str, str]) -> dict:
        """What a run left behind, by cgroup name: the attached programs,
        the maps, the pins and journals under `root` (its bpffs/ and
        state/), and the controller's own views."""
        paths = {name: os.path.realpath(path) for name, path in cgroups.items()}
        names = {path: name for name, path in paths.items()}
        state_dir = os.path.join(root, "state")
        journals = {}
        for fname in sorted(os.listdir(state_dir)) if os.path.isdir(state_dir) else []:
            with open(os.path.join(state_dir, fname)) as f:
                journals[fname] = json.load(f)
        pin_dir = os.path.join(root, "bpffs")
        return {
            "attached": {name: [self.describe(p) for p in self.attached.get(path, [])]
                         for name, path in paths.items()},
            "policy_maps": {names[cg]: dict(self.map_objs[self.fd2map[st.policy_fd]])
                            for cg, st in ctl._state.items() if st.policy_fd is not None},
            "telemetry_maps": {names[cg]: dict(self.map_objs[self.fd2map[st.telemetry_fd]])
                               for cg, st in ctl._state.items()
                               if st.telemetry_fd is not None},
            "pins": sorted(os.listdir(pin_dir)) if os.path.isdir(pin_dir) else [],
            "journals": journals,
            "tracked": sorted(names[cg] for cg in ctl._state),
            "grants": {names[cg]: sorted(g) for cg, g in ctl.enumerate_grants().items()},
            "policies": {names[cg]: p for cg, p in ctl.enumerate_policies().items()},
            "orphans": {names[cg]: k for cg, k in ctl.orphan_policy_keys().items()},
            "loads": len(self.loaded),
        }
