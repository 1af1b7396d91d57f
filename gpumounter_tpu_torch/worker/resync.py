"""The ledger's replay: a restarted worker converged against what is there.

The counterpart of ``gpumounter_tpu/worker/resync.py``. A worker that died in
the middle of ``mount_many`` leaves the node in one of the states its ledger
(``worker/ledger.py``) brackets: nothing yet, grants without nodes, some
nodes injected, or everything done and the done record unwritten. Nobody
else can clean this up, since the grants live behind the kubelet's back. On
start the new worker replays every open txn against three sources:

  * the controller's grants (``V2DeviceController.enumerate_grants``, the
    state its bpffs pins carried over the death; v1 has no such view);
  * the injected nodes, in the recorded target directory, through the
    recorded namespace PID while that process lives;
  * the scheduler's books: the kubelet's view of which slave pods still
    hold which GPUs.

Per open txn:

  mount, bookings intact  the master got no answer, but the GPUs are still
                          booked to the pod: the mount is driven forward
                          (grant and mknod are idempotent) and closed
                          ``replayed-completed``;
  mount, bookings gone    undone: the nodes removed, the grants revoked,
                          the txn's remaining slave pods deleted; closed
                          ``replayed-rolled-back``;
  unmount                 finished (an unmount that began was meant to
                          happen): closed ``replayed-unmounted``.

Each txn's nodes go in one entry into the namespace (the entry is an exec of
the compiled helper, ``native/nsexec.cpp``), not one a GPU. Then the fractional policies
are re-armed in the userspace engine, and the net holdings are reconciled
with the books: GPUs the ledger holds for a pod the books no longer back
(the pod went while the worker was down) are forgotten with a durable
correction, so that books == mounts == ledger holds after events the dead
worker never saw. Last, the deferred slave releases are retried.
"""

from __future__ import annotations

import os

from gpumounter_tpu_torch.cgroup.ebpf import POLICY_UNMETERED
from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
from gpumounter_tpu_torch.k8s.client import NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.nsutil import ns as nsutil
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.worker.mounter import MountTarget

logger = get_logger("worker.resync")

LEDGER_REPLAYS = REGISTRY.counter(
    "tpumounter_ledger_replays_total",
    "Open ledger transactions converged at worker startup, by outcome")

_SUMMARY_KEY = {"replayed-completed": "completed", "replayed-rolled-back": "rolled_back",
                "replayed-unmounted": "unmounted"}


def _live_pid(pid) -> int | None:
    """The recorded namespace PID, only while that process exists: nodes
    must not land in a PID recycled after a reboot."""
    if pid is None:
        return None
    try:
        return int(pid) if os.path.exists(f"/proc/{int(pid)}") else None
    except (TypeError, ValueError):
        return None


class LedgerResync:
    """The one replay at start of a ``GpuMountService``'s ledger."""

    def __init__(self, service):
        self.service = service
        self.ledger = service.ledger
        self.mounter = service.mounter
        self.collector = service.collector
        self.allocator = service.allocator
        self.kube = service.kube

    def replay_once(self) -> dict:
        """Converge every open txn, then reconcile the holdings. Returns a
        summary (the daemon logs it). Never raises: a txn whose replay fails
        stays open for the next start rather than stop the worker serving."""
        summary = {"open": 0, "completed": [], "rolled_back": [], "unmounted": [],
                   "holdings_corrected": 0}
        if self.ledger is None:
            return summary
        try:
            self.collector.update_status()
        except Exception as exc:  # noqa: BLE001 — without the books, "no booking" and
            # "kubelet unreachable" look alike, and a rollback would undo healthy mounts
            logger.error("resync collector refresh failed (%s); replay deferred, open "
                         "transactions left for the next restart", exc)
            summary["open"] = len(self.ledger.open_transactions())
            summary["deferred"] = True
            return summary
        open_txns = self.ledger.open_transactions()
        summary["open"] = len(open_txns)
        for txn in open_txns:
            try:
                outcome = (self._replay_mount(txn) if txn.get("op") == "mount"
                           else self._replay_unmount(txn))
            except Exception as exc:  # noqa: BLE001 — the other txns still replay
                logger.error("replay of txn %s failed (%s); left open for the next restart",
                             txn.get("txn"), exc)
                continue
            LEDGER_REPLAYS.inc(outcome=outcome)
            summary[_SUMMARY_KEY[outcome]].append(txn.get("txn"))
        summary["holdings_corrected"] = self._reconcile_holdings()
        summary["share_policies_replayed"] = self._replay_share_policies()
        # the restart is a natural retry of the releases a failure deferred
        retry = getattr(self.service, "retry_pending_releases", None)
        releases = retry() if retry is not None else {}
        summary["releases_completed"] = releases.get("completed", 0)
        summary["releases_pending"] = releases.get("pending", 0)
        if summary["open"] or summary["holdings_corrected"] or summary["releases_completed"] \
                or summary["releases_pending"]:
            logger.warning("ledger replay: %s", summary)
        return summary

    # --- what is there ---

    def _booked_uuids(self, namespace: str, pod_name: str) -> set[str]:
        """The GPUs the books give the pod, its slave pods' included; empty
        only when the pod is gone. A failure to read raises: "could not
        read the books" must never pass for "no booking", since the
        rollback it would feed undoes a healthy tenant's mount."""
        try:
            pod = Pod(self.kube.get_pod(namespace, pod_name))
        except NotFoundError:
            return set()
        slaves = {s.name for s in self.allocator.slave_pods_for(pod)}
        devices = self.collector.get_pod_devices(pod_name, namespace, slave_pod_names=slaves,
                                                 refresh=False)
        return {d.uuid for d in devices}

    def _txn_devices(self, txn: dict) -> list:
        devices = (self.mounter.backend.device_by_uuid(c["uuid"]) for c in txn.get("chips", []))
        return [d for d in devices if d is not None]

    @staticmethod
    def _txn_target(txn: dict) -> MountTarget:
        return MountTarget(dev_dir=txn.get("dev_dir") or "/dev",
                           cgroup_dirs=list(txn.get("cgroup_dirs") or []),
                           ns_pid=_live_pid(txn.get("ns_pid")),
                           description=txn.get("target") or
                           f"{txn.get('namespace')}/{txn.get('pod')}")

    # --- convergence ---

    def _replay_mount(self, txn: dict) -> str:
        namespace, pod_name = txn.get("namespace", ""), txn.get("pod", "")
        booked = self._booked_uuids(namespace, pod_name)
        chips = txn.get("chips", [])
        devices = self._txn_devices(txn)
        if chips and booked >= {c["uuid"] for c in chips} and len(devices) == len(chips):
            # every GPU still booked to the pod: the death ate the answer, not
            # the allocation; grant and mknod absorb whatever half landed
            try:
                pod = Pod(self.kube.get_pod(namespace, pod_name))
                target = self.mounter.resolve_target(pod)
                # a fractional txn is granted again at the weight and budget
                # the dead worker promised, not as a whole GPU
                policy = {c["uuid"]: (int(c["share"]["weight"]), int(c["share"]["rate_budget"]))
                          for c in chips if isinstance(c.get("share"), dict)}
                self.mounter.mount_many(target, devices, policy=policy or None)
                self.ledger.commit(txn["txn"], "replayed-completed")
                logger.warning("replayed mount txn %s forward: %d GPU(s) onto %s (bookings "
                               "were intact)", txn["txn"], len(devices), target.description)
                return "replayed-completed"
            except Exception as exc:  # noqa: BLE001 — the API's, the RPC's and the
                # mount's failures all take the rollback below
                logger.warning("forward replay of %s failed (%s); rolling back instead",
                               txn["txn"], exc)
        self._undo_mount(txn, devices)
        self.ledger.commit(txn["txn"], "replayed-rolled-back")
        return "replayed-rolled-back"

    def _replay_unmount(self, txn: dict) -> str:
        """An unmount that was logged was meant to happen: finish it."""
        self._undo_mount(txn, self._txn_devices(txn))
        self.ledger.commit(txn["txn"], "replayed-unmounted")
        return "replayed-unmounted"

    def _undo_mount(self, txn: dict, devices: list) -> None:
        """Remove what landed, revoke what was granted, free the txn's
        bookings: the books then agree with the (empty) mounts."""
        target = self._txn_target(txn)
        self._remove_nodes(target, devices)
        self._revoke_txn_grants(txn, devices)
        self._release_txn_slaves(txn)

    @staticmethod
    def _remove_nodes(target: MountTarget, devices: list) -> None:
        """Every node in one namespace entry; a node that fails is logged and
        the entry goes on with the ones after it (a node already gone is
        fine)."""
        left = list(devices)
        while left:
            try:
                nsutil.remove_device_files(target.dev_dir, left, pid=target.ns_pid)
                return
            except Exception as exc:  # noqa: BLE001 — the undo goes on
                paths = [nsutil.device_node_path(target.dev_dir, d) for d in left]
                failed = paths.index(exc.filename) if getattr(exc, "filename", None) in paths \
                    else len(left) - 1
                logger.error("replay node removal of %s failed: %s", left[failed].uuid, exc)
                left = left[failed + 1:]

    def _revoke_txn_grants(self, txn: dict, devices: list) -> None:
        """Revoke the txn's GPUs on its cgroups, only where the controller's
        state shows the grant, so that the replay never revokes a grant
        another pod shares on that cgroup."""
        controller = self.mounter.controller
        enumerate_grants = getattr(controller, "enumerate_grants", None)
        live = enumerate_grants() if enumerate_grants is not None else {}
        for cg in txn.get("cgroup_dirs", []):
            granted_here = live.get(cg)
            for dev in devices:
                if granted_here is not None and (dev.major, dev.minor) not in granted_here:
                    continue
                try:
                    controller.revoke(cg, dev)
                except Exception as exc:  # noqa: BLE001 — the undo goes on
                    logger.error("replay grant revoke of %s on %s failed: %s", dev.uuid, cg, exc)

    def _release_txn_slaves(self, txn: dict) -> None:
        slaves = sorted({c.get("slave") for c in txn.get("chips", []) if c.get("slave")})
        if not slaves:
            return
        try:
            self.allocator.delete_slave_pods(slaves, wait=False)
            logger.info("replay released %d slave booking(s): %s", len(slaves), slaves)
        except Exception as exc:  # noqa: BLE001 — the reaper sweeps what is left
            logger.error("replay slave release failed (the reaper will sweep): %s", exc)

    # --- fractional grants ---

    def _replay_share_policies(self) -> int:
        """Re-arm the userspace policy engine from the ledger's fractional
        grants. Kernel policy maps come back through their bpffs pins; on a
        host without them a restarted worker enforces again the weights and
        budgets it promised, instead of un-metering every share."""
        replayed = 0
        for (namespace, pod_name), shares in self.ledger.share_holdings().items():
            scope = f"{namespace}/{pod_name}"
            for uuid, (weight, rate_budget) in sorted(shares.items()):
                dev = self.mounter.backend.device_by_uuid(uuid)
                if dev is None:
                    logger.warning("share policy for %s on %s not replayed: GPU unknown to "
                                   "this backend", uuid, scope)
                    continue
                tokens = POLICY_UNMETERED if rate_budget <= 0 else rate_budget
                POLICY_ENGINE.set_policy(scope, dev.major, dev.minor, weight, tokens)
                replayed += 1
        return replayed

    # --- ledger == books ---

    def _reconcile_holdings(self) -> int:
        """Forget holdings the books no longer back: a pod deleted while
        the worker was down took its nodes along, and no unmount txn ever
        closed them."""
        corrected = 0
        for (namespace, pod_name), held in self.ledger.net_holdings().items():
            try:
                booked = self._booked_uuids(namespace, pod_name)
            except Exception as exc:  # noqa: BLE001 — skip, do not forget
                logger.warning("holdings check for %s/%s deferred (books unreadable: %s)",
                               namespace, pod_name, exc)
                continue
            stale = held - booked
            if stale:
                self.ledger.forget_holding(namespace, pod_name, stale)
                corrected += len(stale)
                logger.warning("ledger holdings corrected for %s/%s: %d GPU(s) no longer "
                               "booked (%s)", namespace, pod_name, len(stale), sorted(stale))
        return corrected
