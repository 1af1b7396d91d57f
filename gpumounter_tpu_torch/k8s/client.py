"""The surface of a Kubernetes client that the mount path uses.

The counterpart of ``KubeClient`` in ``gpumounter_tpu/k8s/client.py``: pods
get / create / delete / list / patch and a watch, with ``wait_for_pod``
composed on top. The REST client that speaks to an API server comes with
the transport; ``k8s/fake.py`` implements this surface in memory.
"""

from __future__ import annotations

import abc
import time
from collections.abc import Iterator

from gpumounter_tpu_torch.k8s.errors import NotFoundError
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("k8s")


class KubeClient(abc.ABC):
    """The surface both the REST client and the fake implement."""

    @abc.abstractmethod
    def get_pod(self, namespace: str, name: str) -> dict: ...

    @abc.abstractmethod
    def create_pod(self, namespace: str, manifest: dict) -> dict: ...

    @abc.abstractmethod
    def delete_pod(self, namespace: str, name: str, grace_period_seconds: int = 0) -> None: ...

    @abc.abstractmethod
    def list_pods(self, namespace: str | None = None, label_selector: str = "",
                  field_selector: str = "") -> list[dict]: ...

    @abc.abstractmethod
    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        """RFC 7386 merge-patch: dicts merge recursively, an explicit None
        deletes the key."""

    @abc.abstractmethod
    def watch_pods(self, namespace: str, *, label_selector: str = "",
                   field_selector: str = "", timeout_s: float = 60.0,
                   ) -> Iterator[tuple[str, dict]]:
        """Yield (event_type, pod_json) until timeout. Types: ADDED,
        MODIFIED, DELETED. The subscription is made at the call, before
        the first event is read."""

    def wait_for_pod(self, namespace: str, name: str, predicate,
                     timeout_s: float) -> dict | None:
        """Wait until predicate(pod_json) is truthy; None on timeout.

        Watch-driven, where the original busy-polls the pod's phase with no
        sleep (checkCreateState/checkDeleteState, allocator.go:246-317).
        For a wait on deletion, predicate(None) is True on the DELETED
        event or an absent pod.
        """
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            # Subscribe FIRST, then read the current state: an event that
            # lands between the two is already queued on the open watch.
            watch = self.watch_pods(namespace,
                                    field_selector=f"metadata.name={name}",
                                    timeout_s=min(remaining, 30.0))
            try:
                pod = self.get_pod(namespace, name)
            except NotFoundError:
                pod = None
            if predicate(pod):
                return pod if pod is not None else {"__deleted__": True}
            for etype, obj in watch:
                if etype == "DELETED":
                    if predicate(None):
                        return {"__deleted__": True}
                    continue
                if predicate(obj):
                    return obj
                if time.monotonic() >= deadline:
                    return None
