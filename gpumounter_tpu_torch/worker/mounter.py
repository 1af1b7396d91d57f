"""Mount mechanics: the hot-plug of a GPU into a running container.

The counterpart of ``TpuMounter`` in ``gpumounter_tpu/worker/mounter.py``,
and of the original's ``pkg/util/util.go``:

  * ``mount_many`` (MountGPU, util.go:17-71): container -> cgroup path ->
    device permission -> first cgroup PID -> mknod in its namespace;
  * ``unmount_many`` (UnmountGPU, util.go:73-150): busy gate unless
    forced -> revoke -> remove the nodes -> kill the holders when forced;
  * ``holder_pids`` (GetPodGPUProcesses, util.go:152-196): cgroup PIDs
    that hold the device;
  * ``can_mount`` (CanMount, util.go:207-226).

Every container of the pod is handled, with docker and containerd IDs;
the batch is granted first, then injected, and a failure anywhere undoes
the whole batch. A batch enters the target's namespace once, to mount or to
unmount. A ``MountTarget`` can also be a plain directory with no
cgroup or namespace, for dry runs.

The grant goes through the controller of the host's cgroup version: v1's
``devices.allow``, or on v2 the eBPF device program (``cgroup/ebpf.py``),
which replaces the container's own program and so must carry the devices
the container was started with (``_v2_base_rules``). Mounts and unmounts
move the registry's mount series (``utils/metrics.py``).

Each phase is a span (``obs/trace.py``): ``mount.cgroup_grant``,
``mount.mknod``, ``mount.verify`` and ``mount.rollback``;
``unmount.cgroup_revoke`` and ``unmount.device_remove``. The failpoint sites
(``faults/registry.py``) are the reference's: ``worker.mount.before_grant``,
``after_grant``, ``mknod`` (once a GPU), ``rollback`` (once a grant undone),
``worker.addgpu.rollback.skip`` and ``worker.unmount.before_revoke``. An
injected ``CrashError`` is re-raised before any undo, as a process that
died would run none, and leaves the batch's ledger txn open for the
restart's replay (``worker/ledger.py``, ``worker/resync.py``): a mount batch
is one txn, committed success or rolled-back; an unmount is one txn a GPU,
committed success or error. One namespace entry a batch means one ``mount.mknod``
and one ``unmount.device_remove`` span a batch, whose ``device`` attribute
names every UUID in it, where the reference has one a GPU; the
``worker.mount.mknod`` site still fires a GPU at a time before the entry,
and the GPUs before one that fails are injected, then the failure raised,
as the reference's GPUs before it are. A grant whose undo fails posts the
Warning Event ``GPUMountRollbackFailed`` on the pod when the mounter has a
Kubernetes client.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gpumounter_tpu_torch.allocator.allocator import MountType
from gpumounter_tpu_torch.cgroup import (
    container_cgroup_dir,
    detect_cgroup_driver,
    detect_cgroup_version,
    device_controller,
    get_cgroup_pids,
)
from gpumounter_tpu_torch.cgroup.ebpf import (
    DEFAULT_CONTAINER_RULES,
    DEVICE_TELEMETRY,
    POLICY_UNMETERED,
    DeviceRule,
)
from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import DeviceBackend, scan_proc_for_device
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.faults.failpoints import CrashError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.nsutil import ns as nsutil
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import (
    MOUNT_LATENCY,
    MOUNT_ROLLBACK_FAILURES,
    MOUNT_TOTAL,
    PHASE_LATENCY,
    UNMOUNT_TOTAL,
)
from gpumounter_tpu_torch.utils.timing import PhaseTimer

logger = get_logger("mounter")

# The char devices runc's default spec grants rwm in every container, taken
# from DEFAULT_CONTAINER_RULES (which the v2 program always carries), so the
# two cannot drift apart.
_RUNC_DEFAULT_RWM: frozenset[tuple[int, int | None]] = frozenset(
    (r.major, r.minor) for r in DEFAULT_CONTAINER_RULES
    if r.type == "c" and "r" in r.access and r.major is not None)


def _fold_access(major: int, minor: int, mode: int) -> str:
    """The access of a base rule folded from a node of the container's
    /dev. runc's default devices keep rwm; any other node gets r and w from
    its permission bits (a blanket rwm could give a read-only node write
    for the life of the grant). mknod is covered for every device by the
    defaults' `c *:* m` and `b *:* m`."""
    if (major, minor) in _RUNC_DEFAULT_RWM or (major, None) in _RUNC_DEFAULT_RWM:
        return "rwm"
    access = ""
    if mode & 0o444:
        access += "r"
    if mode & 0o222:
        access += "w"
    return access or "r"  # a 000-mode node still must not break a stat-open


class MountError(RuntimeError):
    """A mount or unmount that failed. `unmounted` holds the GPUs of a
    failed unmount batch that were revoked and removed before the failure."""

    def __init__(self, message: str = "", unmounted=()):
        super().__init__(message)
        self.unmounted = list(unmounted)


class GpuBusyError(MountError):
    """The GPU has live holder processes and force was not set."""


@dataclass
class MountTarget:
    """Where a GPU lands: a container (cgroup + namespace) or a bare dir."""

    dev_dir: str = "/dev"            # device dir in the target's mount ns
    cgroup_dirs: list[str] = field(default_factory=list)
    ns_pid: int | None = None        # PID whose mount namespace we enter; None = ours
    description: str = "local"
    pod: Pod | None = None

    @property
    def has_cgroup(self) -> bool:
        return bool(self.cgroup_dirs)


class GpuMounter:
    def __init__(self, backend: DeviceBackend, cfg=None, kube=None, ledger=None):
        """kube: a KubeClient on which a failed grant undo posts its Warning
        Event on the target pod; None posts none. ledger: the worker's
        ``MountLedger``, which journals every batch; None journals none."""
        self.cfg = cfg or Config()
        self.kube = kube
        self.ledger = ledger
        self.backend = backend
        version = self.cfg.cgroup_version
        self.cgroup_version = (detect_cgroup_version(self.cfg.cgroup_root)
                               if version == "auto" else int(version))
        self.controller = device_controller(self.cgroup_version)

    # --- target resolution (util.go:22-50) ---

    def resolve_target(self, pod: Pod) -> MountTarget:
        ids = pod.container_ids()
        if not ids:
            raise MountError(f"pod {pod.namespace}/{pod.name} has no running containers")
        driver = self.cfg.cgroup_driver
        if driver == "auto":
            driver = detect_cgroup_driver(self.cfg.cgroup_root)
        cgroup_dirs = [container_cgroup_dir(pod, cid, runtime,
                                            cgroup_root=self.cfg.cgroup_root,
                                            driver=driver, version=self.cgroup_version)
                       for _, runtime, cid in ids]
        ns_pid = None
        for cg in cgroup_dirs:
            pids = get_cgroup_pids(cg)
            if pids:
                ns_pid = pids[0]
                break
        if ns_pid is None:
            raise MountError(f"no PIDs found in cgroups of {pod.namespace}/{pod.name} "
                             f"(looked in {cgroup_dirs})")
        return MountTarget(dev_dir="/dev", cgroup_dirs=cgroup_dirs, ns_pid=ns_pid,
                           description=f"{pod.namespace}/{pod.name}", pod=pod)

    # --- busy detection (GetPodGPUProcesses, util.go:152-196) ---

    def holder_pids(self, target: MountTarget, dev: GpuDevice) -> list[int]:
        holders = set(self.backend.running_pids(dev))
        # Holders of the target-side node when it is a distinct path (fake
        # dirs, bind-mounted /dev). For a real GPU the rdev scan already
        # covers every alias.
        injected = nsutil.device_node_path(target.dev_dir, dev)
        if injected != dev.device_path:
            holders.update(scan_proc_for_device(None, None, path_hint=injected))
        if not target.has_cgroup:
            return sorted(holders)
        cgroup_pids: set[int] = set()
        for cg in target.cgroup_dirs:
            cgroup_pids.update(get_cgroup_pids(cg))
        return sorted(p for p in holders if p in cgroup_pids)

    # --- policy gate (CanMount, util.go:207-226) ---

    @staticmethod
    def can_mount(mount_type: MountType, is_entire_mount: bool) -> tuple[bool, str]:
        if mount_type == MountType.UNKNOWN:
            return False, "mount type of pod is unknown; refusing"
        if mount_type == MountType.ENTIRE:
            return False, "pod already holds an entire-mount; no further mounts"
        if mount_type == MountType.SINGLE and is_entire_mount:
            return False, "pod holds single-mounts; entire-mount not allowed"
        return True, ""

    # --- mount (MountGPU, util.go:17-71) ---

    def _v2_base_rules(self, target: MountTarget,
                       base_rules: list[DeviceRule] | None) -> list[DeviceRule]:
        """The caller's rules (the pod's own GPUs) and every char device in
        the container's /dev. The v2 program *replaces* the container's
        own, and a device it does not carry is denied for the life of the
        grant; the container's /dev is the whole and honest record of the
        devices it was started with.

        No GPU node of this host becomes a base rule: a node left in /dev
        by an earlier hot mount would keep the container's access to that
        GPU after its revoke. Companions do fold in: alone they grant no
        GPU."""
        rules = list(base_rules or [])
        seen = {(r.major, r.minor) for r in rules}
        own_gpus = {(d.major, d.minor) for d in self.backend.list_devices()}
        scanned = nsutil.scan_container_dev_nodes(target.ns_pid, target.dev_dir)
        folded = 0
        for _, major, minor, mode in scanned:
            if (major, minor) in seen or (major, minor) in own_gpus:
                continue
            seen.add((major, minor))
            rules.append(DeviceRule("c", major, minor, _fold_access(major, minor, mode)))
            folded += 1
        logger.info("v2 base rules for %s: %d caller rule(s) + %d/%d scanned /dev node(s)",
                    target.description, len(base_rules or []), folded, len(scanned))
        return rules

    def mount_many(self, target: MountTarget, devices: list[GpuDevice],
                   base_rules: list[DeviceRule] | None = None,
                   policy: dict[str, tuple[int, int]] | None = None) -> dict:
        """Grant, then inject, a batch of GPUs, all or nothing: a failure
        revokes every rule granted and removes every node injected, then
        raises MountError. Returns the phase timings (ms).

        base_rules: on v2, the rules the pod holds already (its own GPUs),
        which our program must keep. policy: a GPU's uuid -> (weight,
        rate budget) for a fractional grant: a policy-map entry on v2 with
        kernel maps, else an entry of the userspace engine."""
        if not devices:
            return {}
        timer = PhaseTimer()
        granted: list[tuple[str, GpuDevice]] = []
        injected: list[GpuDevice] = []
        uuids = ",".join(d.uuid for d in devices)
        # the intent before the first side effect: a death anywhere in the
        # batch leaves this txn open, naming what the replay converges
        txn = (self.ledger.begin("mount", target=target, devices=devices, policy=policy)
               if self.ledger is not None else None)
        try:
            # a worker that dies here leaves nothing (before) or grants
            # without nodes (after)
            failpoints.fire("worker.mount.before_grant", device=uuids, target=target.description)
            with timer.phase("cgroup_grant"), \
                    trace.span("mount.cgroup_grant", device=uuids, gpus=len(devices),
                               target=target.description):
                self._grant_batch(target, devices, base_rules, granted, policy=policy)
            failpoints.fire("worker.mount.after_grant", device=uuids, target=target.description)
            with timer.phase("device_inject"):
                self._inject_batch(target, devices, injected)
        except CrashError:
            # a simulated death: a real one runs no undo, and its txn stays open
            MOUNT_TOTAL.inc(float(len(devices)), result="error")
            raise
        except Exception as exc:
            self._rollback_batch(target, granted, injected)
            MOUNT_TOTAL.inc(float(len(devices)), result="error")
            if txn is not None:
                # the undo ran (or the chaos failpoint skipped it): this
                # process finished its batch
                self.ledger.commit(txn, "rolled-back")
            if isinstance(exc, MountError):
                raise
            # One type for every lower-layer failure (CgroupError, BpfError,
            # NamespaceError, OSError), so that the caller's rollback of the
            # scheduler's books fires on one exception type.
            raise MountError(f"mount of {uuids} into {target.description}: {exc}") from exc
        MOUNT_TOTAL.inc(float(len(devices)), result="success")
        if txn is not None:
            self.ledger.commit(txn, "success")
        # the exemplar: the batch's trace id on the bucket it landed in
        MOUNT_LATENCY.observe(timer.total(), trace_id=trace.current_trace_id())
        # The grant events of the per-tenant access telemetry: beside the
        # kernel's attempt counts on v2 with maps, the whole signal elsewhere.
        DEVICE_TELEMETRY.record(target.description, "grant", len(devices))
        for phase, seconds in timer.phases.items():
            PHASE_LATENCY.observe(seconds, phase=phase)
        summary = timer.summary_ms()
        logger.info("mounted %d GPU(s) [%s] into %s (%s)", len(devices), uuids,
                    target.description, summary)
        return summary

    def _inject_batch(self, target: MountTarget, devices: list[GpuDevice],
                      injected: list[GpuDevice]) -> None:
        """The batch's nodes in one entry into the target's namespace, then
        the check that the tenant sees them (a mknod into a namespace being
        torn down). The mknod site fires a GPU at a time first; the GPUs
        before one that fails are injected, then its failure is raised.
        `injected` takes the GPUs before their entry, so that the caller's
        rollback also undoes a half-made entry."""
        uuids = ",".join(d.uuid for d in devices)
        ready: list[GpuDevice] = []
        failure: Exception | None = None
        with trace.span("mount.mknod", device=uuids, target=target.description):
            for dev in devices:
                try:
                    failpoints.fire("worker.mount.mknod", device=dev.uuid,
                                    target=target.description)
                except Exception as exc:  # noqa: BLE001 — raised after the entry
                    failure = exc
                    break
                ready.append(dev)
            missing = []
            if ready:
                injected.extend(ready)
                missing = nsutil.inject_device_files(target.dev_dir, ready, pid=target.ns_pid)
            if failure is not None:
                raise failure
        # the helper looked for the nodes in the same entry; this span holds
        # the verdict on its answer
        with trace.span("mount.verify", device=uuids, target=target.description):
            if missing:
                raise MountError(f"injected node(s) {missing} not visible in "
                                 f"{target.description} after mknod")

    def _grant_batch(self, target: MountTarget, devices: list[GpuDevice],
                     base_rules: list[DeviceRule] | None,
                     granted: list[tuple[str, GpuDevice]],
                     policy: dict[str, tuple[int, int]] | None = None) -> None:
        """Grant every GPU on every cgroup of the target, appending to
        `granted` as the rules land, so that the caller undoes exactly what
        took effect. Where no kernel policy map exists (v1, a bare
        directory) a fractional policy goes to the userspace engine."""
        if not target.cgroup_dirs:
            self._engine_policies(target, devices, policy)
            return
        if self.cgroup_version == 2:
            # The controller takes the base rules at a cgroup's first grant
            # only: skip the /dev walk when every cgroup is tracked already.
            if not all(self.controller.has_state(cg) for cg in target.cgroup_dirs):
                base_rules = self._v2_base_rules(target, base_rules)
            for cg in target.cgroup_dirs:
                # One program load at a cgroup's first grant; every later
                # grant is a map write. The tenant names the cgroup's
                # in-kernel access counts.
                self.controller.grant_many(cg, devices, base_rules=base_rules,
                                           tenant=target.description, policy=policy)
                granted.extend((cg, d) for d in devices)
        else:
            self._engine_policies(target, devices, policy)
            for cg in target.cgroup_dirs:
                for dev in devices:
                    self.controller.grant(cg, dev)
                    granted.append((cg, dev))

    @staticmethod
    def _engine_policies(target: MountTarget, devices: list[GpuDevice],
                         policy: dict[str, tuple[int, int]] | None) -> None:
        """Fractional policies into the userspace engine, where no kernel
        policy map exists; the scope is the target's "ns/pod"."""
        if not policy:
            return
        for dev in devices:
            if dev.uuid not in policy:
                continue
            weight, rate_budget = policy[dev.uuid]
            tokens = POLICY_UNMETERED if int(rate_budget) <= 0 else int(rate_budget)
            POLICY_ENGINE.set_policy(target.description, dev.major, dev.minor, int(weight),
                                     tokens)

    def _rollback_batch(self, target: MountTarget,
                        granted: list[tuple[str, GpuDevice]],
                        injected: list[GpuDevice]) -> None:
        """Undo a failed batch: kill whatever opened an injected node in the
        meantime (a revoke only gates later opens), remove the nodes,
        revoke the rules. Each undo step that fails is logged and the rest
        still run; the caller raises the failure that started it. The
        worker.addgpu.rollback.skip failpoint skips it whole: the leak the
        chaos harness must detect."""
        if failpoints.value("worker.addgpu.rollback.skip", False):
            logger.error("batch rollback SKIPPED by failpoint; %d grant(s) / %d injected "
                         "node(s) leaked", len(granted), len(injected))
            return
        with trace.span("mount.rollback", cgroups=len(granted), injected=len(injected)):
            holders: set[int] = set()
            for dev in injected:
                try:
                    holders.update(self.holder_pids(target, dev))
                except Exception as exc:  # noqa: BLE001 — the undo goes on
                    logger.error("rollback holder scan of %s failed: %s", dev.uuid, exc)
            try:
                nsutil.remove_device_files(target.dev_dir, injected, pid=target.ns_pid)
            except Exception as exc:  # noqa: BLE001 — the undo goes on
                logger.error("rollback node removal of %s failed: %s",
                             [d.uuid for d in injected], exc)
            for cg, dev in granted:
                try:
                    failpoints.fire("worker.mount.rollback", cgroup=cg, device=dev.uuid)
                    self.controller.revoke(cg, dev)
                except Exception as exc:  # noqa: BLE001 — the undo goes on
                    self._rollback_failed(target, dev, cg, exc)
            if holders:
                logger.warning("rollback killing %d holder PID(s): %s", len(holders),
                               sorted(holders))
                nsutil.kill_pids_in_ns(sorted(holders), pid=target.ns_pid)

    def _rollback_failed(self, target: MountTarget, dev: GpuDevice, cgroup: str,
                         exc: Exception) -> None:
        """A grant undo failed: the container keeps kernel access to a GPU
        the scheduler is about to book again. The counter is what an alert
        reads; the Warning Event is what `kubectl describe pod` shows."""
        MOUNT_ROLLBACK_FAILURES.inc()
        logger.error("grant rollback of %s on %s failed: %s; the container keeps kernel "
                     "access to the GPU", dev.uuid, cgroup, exc)
        if self.kube is not None and target.pod is not None:
            from gpumounter_tpu_torch.k8s.events import post_pod_event
            post_pod_event(
                self.kube, target.pod, "GPUMountRollbackFailed",
                f"could not revoke {dev.uuid} from cgroup {cgroup} after a failed mount "
                f"({exc}); the container retains kernel access to the GPU — revoke "
                f"manually or restart the pod",
                event_type="Warning", component="tpumounter-worker")

    # --- unmount (UnmountGPU, util.go:73-150) ---

    def unmount_many(self, target: MountTarget, devices: list[GpuDevice],
                     force: bool = False) -> dict:
        """Revoke, then remove, a batch of GPUs, every node in one entry into
        the target's namespace; when forced, kill their holders after. A
        holder of any GPU refuses the whole batch with GpuBusyError, before
        anything is touched, unless forced. Any other failure raises
        MountError, whose `unmounted` holds the GPUs done before it.
        Returns the phase timings (ms).

        The unmount series counts GPUs, as the reference counts its one-GPU
        unmounts: a failure counts those done as success, the rest as
        error. With a ledger each GPU is a txn of its own, committed the same
        way, so that a failure part way leaves the reference's net holdings;
        the txns are all logged after the busy gate (a busy batch has none)
        and before the entry, and closed after it, where the reference's
        alternate a GPU at a time."""
        timer = PhaseTimer()
        with timer.phase("busy_check"):
            busy = {dev.uuid: pids for dev in devices
                    if (pids := self.holder_pids(target, dev))}
        if busy and not force:
            UNMOUNT_TOTAL.inc(float(len(devices)), result="busy")
            raise GpuBusyError(f"GPU(s) held in {target.description} (UUID: PIDs): {busy}; "
                               "use force")
        uuids = ",".join(d.uuid for d in devices)
        # one txn a GPU, as the reference journals its one-GPU unmounts, all
        # logged after the read-only busy gate and before the first mutation
        txns = ([self.ledger.begin("unmount", target=target, devices=[dev]) for dev in devices]
                if self.ledger is not None else [])
        done: list[GpuDevice] = []
        try:
            failpoints.fire("worker.unmount.before_revoke", device=uuids,
                            target=target.description)
            with timer.phase("cgroup_revoke"), \
                    trace.span("unmount.cgroup_revoke", device=uuids,
                               target=target.description):
                for cg in target.cgroup_dirs:
                    for dev in devices:
                        self.controller.revoke(cg, dev)
            with timer.phase("device_remove"), \
                    trace.span("unmount.device_remove", device=uuids,
                               target=target.description):
                try:
                    nsutil.remove_device_files(target.dev_dir, devices, pid=target.ns_pid)
                except OSError as exc:
                    paths = [nsutil.device_node_path(target.dev_dir, d) for d in devices]
                    if exc.filename in paths:
                        done = devices[:paths.index(exc.filename)]
                    raise
            # A GPU whose holders outlive a failed kill stays booked.
            done = [d for d in devices if d.uuid not in busy]
            if busy:
                with timer.phase("kill_holders"):
                    nsutil.kill_pids_in_ns(sorted({p for pids in busy.values() for p in pids}),
                                           pid=target.ns_pid)
            done = list(devices)
        except CrashError:
            UNMOUNT_TOTAL.inc(float(len(devices)), result="error")
            raise  # a simulated death: no wrapping, no cleanup, the txns open
        except Exception as exc:
            if done:
                UNMOUNT_TOTAL.inc(float(len(done)), result="success")
            UNMOUNT_TOTAL.inc(float(len(devices) - len(done)), result="error")
            # the GPUs done leave the holdings, as the reference's one-GPU
            # unmounts before a failure do
            unmounted = {d.uuid for d in done}
            for dev, txn in zip(devices, txns):
                self.ledger.commit(txn, "success" if dev.uuid in unmounted else "error")
            raise MountError(f"unmount of {uuids} from {target.description}: {exc}",
                             unmounted=done) from exc
        UNMOUNT_TOTAL.inc(float(len(devices)), result="success")
        for txn in txns:
            self.ledger.commit(txn, "success")
        # A revoked GPU's entry in the userspace engine must not outlive its
        # grant (on v2 the controller's revoke deletes the kernel map's).
        for dev in devices:
            POLICY_ENGINE.clear_policy(target.description, dev.major, dev.minor)
        for phase, seconds in timer.phases.items():
            PHASE_LATENCY.observe(seconds, phase=phase)
        summary = timer.summary_ms()
        logger.info("unmounted %d GPU(s) [%s] from %s (%s)", len(devices), uuids,
                    target.description, summary)
        return summary
