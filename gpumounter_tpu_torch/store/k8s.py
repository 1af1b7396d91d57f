"""KubeMasterStore: the master's state on the cluster's objects.

The counterpart of ``gpumounter_tpu/store/k8s.py``: intents as the
``tpumounter.io/desired-chips`` annotations (``elastic/intents.py``), a
migration's journal as ``tpumounter.io/migration`` on its source pod
(``migrate/journal.py``), the registry as the labelled worker pods, the
pool pods by node, and the health state as an annotation on the
``tpumounter-health`` lease (CAS on its resourceVersion). Annotation stamps
and journals are merge patches through ``patch_pod_with_retry``
(K8S_WRITE_ATTEMPTS). Lists and scans let a failure propagate: the cache
above answers from its copy, where swallowing would hand it a fresh empty
answer.
"""

from __future__ import annotations

import json
from collections.abc import Iterator

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient, patch_pod_with_retry
from gpumounter_tpu_torch.k8s.errors import ConflictError, NotFoundError, classify_exception
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.store.base import MasterStore
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("store.k8s")


class KubeMasterStore(MasterStore):
    def __init__(self, kube: KubeClient, cfg=None):
        self.kube = kube
        self.cfg = cfg or Config()

    # --- the worker registry ---

    def list_worker_pods(self) -> list[dict]:
        return self.kube.list_pods(self.cfg.worker_namespace,
                                   label_selector=self.cfg.worker_label_selector)

    def watch_worker_pods(self, timeout_s: float = 60.0) -> Iterator[tuple[str, dict]]:
        return self.kube.watch_pods(self.cfg.worker_namespace,
                                    label_selector=self.cfg.worker_label_selector,
                                    timeout_s=timeout_s)

    # --- intents ---

    def put_intent(self, namespace: str, pod_name: str, intent) -> None:
        self.kube.patch_pod(namespace, pod_name,
                            {"metadata": {"annotations": intent.to_annotations()}})

    def get_intent(self, namespace: str, pod_name: str):
        from gpumounter_tpu_torch.elastic.intents import Intent
        return Intent.from_annotations(Pod(self.kube.get_pod(namespace, pod_name)).annotations)

    def delete_intent(self, namespace: str, pod_name: str) -> bool:
        from gpumounter_tpu_torch.elastic.intents import (
            ANNOT_DESIRED,
            ANNOT_MIN,
            ANNOT_PRIORITY,
            ANNOT_REPLACED,
        )
        had = ANNOT_DESIRED in Pod(self.kube.get_pod(namespace, pod_name)).annotations
        self.kube.patch_pod(namespace, pod_name, {"metadata": {"annotations": {
            ANNOT_DESIRED: None, ANNOT_MIN: None, ANNOT_PRIORITY: None, ANNOT_REPLACED: None}}})
        return had

    def list_intents(self) -> list[tuple[str, str, object]]:
        from gpumounter_tpu_torch.elastic.intents import Intent, IntentError
        out = []
        for pod_json in self.kube.list_pods():
            pod = Pod(pod_json)
            try:
                intent = Intent.from_annotations(pod.annotations)
            except IntentError as exc:
                logger.warning("skipping malformed intent on %s/%s: %s", pod.namespace,
                               pod.name, exc)
                continue
            if intent is not None:
                out.append((pod.namespace, pod.name, intent))
        return out

    # --- migration journals ---

    def scan_journals(self) -> list[dict]:
        from gpumounter_tpu_torch.migrate.journal import parse_journal
        out = []
        for pod_json in self.kube.list_pods():
            journal = parse_journal(Pod(pod_json).annotations)
            if journal is not None:
                out.append(journal)
        return out

    def save_journal(self, journal: dict) -> None:
        from gpumounter_tpu_torch.migrate.journal import ANNOT_JOURNAL, dump
        src = journal["source"]
        patch_pod_with_retry(self.kube, src["namespace"], src["pod"],
                             {"metadata": {"annotations": {ANNOT_JOURNAL: dump(journal)}}},
                             attempts=self.cfg.k8s_write_attempts,
                             base_s=self.cfg.k8s_write_retry_base_s)

    # --- the recovery plane ---

    def get_node(self, node_name: str) -> dict | None:
        try:
            return self.kube.get_node(node_name)
        except (NotFoundError, NotImplementedError):
            return None
        except Exception as exc:  # noqa: BLE001 — readiness is advisory
            logger.warning("node read %s failed: %s", node_name, classify_exception(exc))
            return None

    def list_pool_pods(self, node_name: str) -> list[dict]:
        return self.kube.list_pods(self.cfg.pool_namespace,
                                   field_selector=f"spec.nodeName={node_name}")

    # --- the health plane: the quarantine set on a lease ---

    HEALTH_LEASE = "tpumounter-health"
    ANNOT_HEALTH = "tpumounter.io/health-state"

    def load_health_state(self) -> dict | None:
        try:
            lease = self.kube.get_lease(self.cfg.worker_namespace, self.HEALTH_LEASE)
        except NotFoundError:
            return None
        except Exception as exc:  # noqa: BLE001 — fail open: rebuilt from live telemetry
            logger.warning("health-state read failed: %s", classify_exception(exc))
            return None
        raw = (lease.get("metadata", {}).get("annotations") or {}).get(self.ANNOT_HEALTH)
        if not raw:
            return None
        try:
            state = json.loads(raw)
        except ValueError:
            logger.warning("health-state annotation is malformed; ignoring")
            return None
        return state if isinstance(state, dict) else None

    def save_health_state(self, state: dict) -> None:
        payload = json.dumps(state, sort_keys=True)
        namespace = self.cfg.worker_namespace
        for _ in range(max(1, int(self.cfg.k8s_write_attempts))):
            try:
                lease = self.kube.get_lease(namespace, self.HEALTH_LEASE)
            except NotFoundError:
                try:
                    self.kube.create_lease(namespace, {
                        "metadata": {"name": self.HEALTH_LEASE, "namespace": namespace,
                                     "annotations": {self.ANNOT_HEALTH: payload}},
                        "spec": {}})
                    return
                except ConflictError:
                    continue  # another replica made it: read again
            meta = lease.setdefault("metadata", {})
            meta.setdefault("annotations", {})[self.ANNOT_HEALTH] = payload
            try:
                # the GET's resourceVersion rides along: a CAS
                self.kube.update_lease(namespace, self.HEALTH_LEASE, lease)
                return
            except (ConflictError, NotFoundError):
                continue
        logger.warning("health-state write did not land after %d attempts",
                       self.cfg.k8s_write_attempts)

    # --- annotation stamps ---

    def stamp_annotation(self, namespace: str, pod_name: str, annotation: str,
                         payload: str | None) -> None:
        patch_pod_with_retry(self.kube, namespace, pod_name,
                             {"metadata": {"annotations": {annotation: payload}}},
                             attempts=self.cfg.k8s_write_attempts,
                             base_s=self.cfg.k8s_write_retry_base_s)
