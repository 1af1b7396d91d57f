"""SlaveReaper: the slave pods whose owner is gone, deleted.

The counterpart of ``gpumounter_tpu/worker/reaper.py``. The original relies
on OwnerReferences for crash consistency (allocator.go:202-212), but its
slave pods live in ``gpu-pool`` and their owners elsewhere, and Kubernetes
refuses owner references across namespaces: the garbage collector takes
such an owner as absent and deletes the dependent, freeing GPUs that are
still hot-mounted. The allocator therefore sets none (``allocator/
allocator.py``), and this loop on the worker takes their place. It deletes
a slave pod (label ``app=gpu-pool``) whose recorded owner (the annotations
``tpumounter.io/owner`` and ``owner-namespace``, the labels as a fallback,
and the label ``owner-uid``) no longer exists, was recreated under a new
UID, or has finished. Each pass first collects the grant state of dead
cgroups (``V2DeviceController.gc_dead_cgroups``) where the controller has
it. An owner's death returns its GPUs to the books within one interval.
"""

from __future__ import annotations

import threading

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("reaper")

#: the slave pods' label (``allocator/allocator.py``)
SLAVE_SELECTOR = "app=gpu-pool"


class SlaveReaper:
    def __init__(self, kube: KubeClient, cfg=None, interval_s: float = 15.0,
                 device_controller=None):
        """device_controller: the mounter's cgroup controller; where it has
        ``gc_dead_cgroups`` (v2), each pass calls it first."""
        self.kube = kube
        self.cfg = cfg or Config()
        self.interval_s = interval_s
        self.device_controller = device_controller
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def reap_once(self) -> list[str]:
        """One pass; returns the names of the slave pods deleted."""
        gc = getattr(self.device_controller, "gc_dead_cgroups", None)
        if gc is not None:
            try:
                gc()
            except Exception as exc:  # noqa: BLE001 — the loop lives on
                logger.warning("cgroup grant GC failed: %s", exc)
        deleted: list[str] = []
        try:
            slaves = self.kube.list_pods(self.cfg.pool_namespace, label_selector=SLAVE_SELECTOR)
        except Exception as exc:  # noqa: BLE001 — the loop lives on
            logger.warning("reaper list failed: %s", exc)
            return deleted
        for slave_json in slaves:
            slave = Pod(slave_json)
            # the whole identity is in the annotations (a label value is cut
            # at 63 characters); the labels are the fallback
            owner = (slave.annotations.get("tpumounter.io/owner")
                     or slave.labels.get("tpumounter.io/owner", ""))
            owner_ns = (slave.annotations.get("tpumounter.io/owner-namespace")
                        or slave.labels.get("tpumounter.io/owner-namespace", ""))
            owner_uid = slave.labels.get("tpumounter.io/owner-uid", "")
            if not owner or not owner_ns:
                continue  # not ours: leave it alone
            try:
                owner_pod = Pod(self.kube.get_pod(owner_ns, owner))
                orphaned = ((owner_uid and owner_pod.uid != owner_uid)  # recreated
                            or owner_pod.phase in ("Succeeded", "Failed"))  # finished
            except NotFoundError:
                orphaned = True
            except Exception as exc:  # noqa: BLE001
                logger.warning("reaper owner check %s/%s failed: %s", owner_ns, owner,
                               exc)
                continue
            if not orphaned:
                continue
            logger.info("reaping orphan slave pod %s (owner %s/%s gone)", slave.name, owner_ns,
                        owner)
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, slave.name, grace_period_seconds=0)
                deleted.append(slave.name)
            except Exception as exc:  # noqa: BLE001
                logger.warning("reap delete %s failed: %s", slave.name, exc)
        return deleted

    def _loop(self) -> None:
        # the first pass at once: a restarted worker may have missed owners'
        # deaths
        self.reap_once()
        while not self._stop.wait(self.interval_s):
            self.reap_once()

    def start(self) -> "SlaveReaper":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="slave-reaper")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
