"""MasterStore: the master's whole durable state, behind one interface.

The counterpart of ``gpumounter_tpu/store/base.py``. Everything a master
knows must be rebuildable from here alone, so that a restarted replica (or
one that takes another's work over) reads the same view from the cluster,
and a fresh instance reads back what another wrote (the restart-resume
parity of ``tests/test_torch_store.py``).

Errors: a method that names a pod raises NotFoundError when it does not
exist; the list-backed store lets an outage propagate from a list or scan,
so that the cache above it can answer from its copy.
"""

from __future__ import annotations

import abc
from collections.abc import Iterator
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # the type only: no import cycle at run time
    from gpumounter_tpu_torch.elastic.intents import Intent


class MasterStore(abc.ABC):
    """The master's durable state."""

    # --- the worker registry ---

    @abc.abstractmethod
    def list_worker_pods(self) -> list[dict]:
        """Every worker pod (the API's JSON): the registry's priming LIST."""

    @abc.abstractmethod
    def watch_worker_pods(self, timeout_s: float = 60.0) -> Iterator[tuple[str, dict]]:
        """The worker pods' ADDED, MODIFIED and DELETED events."""

    # --- intents ---

    @abc.abstractmethod
    def put_intent(self, namespace: str, pod_name: str, intent: "Intent") -> None: ...

    @abc.abstractmethod
    def get_intent(self, namespace: str, pod_name: str) -> "Intent | None": ...

    @abc.abstractmethod
    def delete_intent(self, namespace: str, pod_name: str) -> bool:
        """Drop the intent and the heal marker; whether an intent was there."""

    @abc.abstractmethod
    def list_intents(self) -> list[tuple[str, str, "Intent"]]:
        """Every (namespace, pod, intent) of the cluster."""

    # --- migration journals ---

    @abc.abstractmethod
    def scan_journals(self) -> list[dict]:
        """Every migration journal of the cluster, terminal ones too."""

    @abc.abstractmethod
    def save_journal(self, journal: dict) -> None:
        """Persist the journal on its source pod (NotFoundError when the
        pod is gone)."""

    # --- the recovery plane ---

    def get_node(self, node_name: str) -> dict | None:
        """The Node, or None where the backend has no view of nodes."""
        return None

    def list_pool_pods(self, node_name: str) -> list[dict]:
        """Every pool pod (slave and warm holder) on the node."""
        return []

    # --- the health plane ---

    def load_health_state(self) -> dict | None:
        """The quarantine set a previous master persisted, or None."""
        return None

    def save_health_state(self, state: dict) -> None:
        """Persist the quarantine set (best effort)."""

    # --- for /apihealth, and the owner's shutdown ---

    def payload(self) -> dict:
        """What /apihealth shows of the store (nothing for a plain backend)."""
        return {}

    def close(self) -> None:
        """Stop what the store runs and release what it holds; idempotent."""

    # --- annotation stamps ---

    @abc.abstractmethod
    def stamp_annotation(self, namespace: str, pod_name: str, annotation: str,
                         payload: str | None) -> None:
        """Write (payload) or clear (None) one annotation, with bounded
        retries. NotFoundError when the pod is gone."""
