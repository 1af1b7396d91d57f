"""Intents: a pod's declared GPU count, persisted as annotations on the pod.

The counterpart of ``gpumounter_tpu/elastic/intents.py``. The original
GPUMounter is imperative only (one /addgpu a mount); here a client declares
the count it wants and a reconciler converges on it. The pod is the record:
the intent lives in ``tpumounter.io/desired-chips``, ``min-chips`` and
``priority`` (the reference's keys, kept as they are: they are persisted),
so it survives a master's restart, ``kubectl annotate`` is a client, and
deleting the pod deletes the intent. ``IntentStore`` is the CRUD over a
``MasterStore`` backend (``store/``), by default the list-backed one.
"""

from __future__ import annotations

from dataclasses import dataclass

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("elastic.intents")

ANNOT_DESIRED = "tpumounter.io/desired-chips"
ANNOT_MIN = "tpumounter.io/min-chips"
ANNOT_PRIORITY = "tpumounter.io/priority"
#: stamped by the reconciler after a heal; the tenant's watcher restores on it
ANNOT_REPLACED = "tpumounter.io/chip-replaced"


class IntentError(ValueError):
    """A malformed intent (HTTP 400)."""


@dataclass(frozen=True)
class Intent:
    desired_chips: int
    #: the floor under pressure: at or above it the pod is "degraded", not
    #: "failed"; 0 means the desired count is best effort
    min_chips: int = 0
    #: higher first when the queue is contended
    priority: int = 0

    def validate(self, max_chips: int) -> "Intent":
        if not 0 <= self.desired_chips <= max_chips:
            raise IntentError(f"desired_chips must be 0..{max_chips}, got {self.desired_chips}")
        if not 0 <= self.min_chips <= self.desired_chips:
            raise IntentError(f"min_chips must be 0..desired_chips ({self.desired_chips}), "
                              f"got {self.min_chips}")
        return self

    @classmethod
    def from_annotations(cls, annotations: dict[str, str]) -> "Intent | None":
        raw = annotations.get(ANNOT_DESIRED)
        if raw is None:
            return None
        try:
            return cls(desired_chips=int(raw), min_chips=int(annotations.get(ANNOT_MIN, "0")),
                       priority=int(annotations.get(ANNOT_PRIORITY, "0")))
        except ValueError as exc:
            raise IntentError(f"malformed intent annotations: {exc}")

    def to_annotations(self) -> dict[str, str]:
        return {ANNOT_DESIRED: str(self.desired_chips), ANNOT_MIN: str(self.min_chips),
                ANNOT_PRIORITY: str(self.priority)}

    def to_json(self) -> dict:
        return {"desiredChips": self.desired_chips, "minChips": self.min_chips,
                "priority": self.priority}

    @classmethod
    def from_json(cls, payload: dict) -> "Intent":
        if not isinstance(payload, dict):
            raise IntentError('body must be a JSON object with "desiredChips"')
        try:
            desired = int(payload["desiredChips"])
            minimum = int(payload.get("minChips", 0))
            priority = int(payload.get("priority", 0))
        except KeyError:
            raise IntentError('missing required field "desiredChips"')
        except (TypeError, ValueError) as exc:
            raise IntentError(f"intent fields must be integers: {exc}")
        return cls(desired_chips=desired, min_chips=minimum, priority=priority)


class IntentStore:
    """CRUD over the intent annotations, through a MasterStore backend.
    NotFoundError when the pod does not exist."""

    def __init__(self, kube: KubeClient, cfg=None, backend=None):
        self.kube = kube
        self.cfg = cfg or Config()
        if backend is None:
            from gpumounter_tpu_torch.store.k8s import KubeMasterStore
            backend = KubeMasterStore(kube, self.cfg)
        self.backend = backend

    def put(self, namespace: str, pod_name: str, intent: Intent) -> Intent:
        intent.validate(self.cfg.max_gpu_per_request)
        self.backend.put_intent(namespace, pod_name, intent)
        logger.info("intent set: %s/%s desired=%d min=%d priority=%d", namespace, pod_name,
                    intent.desired_chips, intent.min_chips, intent.priority)
        return intent

    def get(self, namespace: str, pod_name: str) -> Intent | None:
        return self.backend.get_intent(namespace, pod_name)

    def delete(self, namespace: str, pod_name: str) -> bool:
        """Drop the intent and the heal marker; the pod keeps its GPUs
        (deletion ends management, it unmounts nothing). Whether an intent
        was there."""
        had = self.backend.delete_intent(namespace, pod_name)
        if had:
            logger.info("intent deleted: %s/%s", namespace, pod_name)
        return had

    def list(self) -> list[tuple[str, str, Intent]]:
        """Every (namespace, pod, intent) of the cluster, one LIST."""
        return self.backend.list_intents()
