"""The few pieces of the control plane's Kubernetes layer that the tenant's
watchers touch, kept here because the port imports nothing of the JAX
package.

``kube`` stays duck-typed as it is there: an object with ``get_pod``,
``watch_pods`` and ``patch_pod``, raising errors that carry the API's HTTP
``status``. This module reads those errors by their status alone.
"""

from __future__ import annotations

import logging
import socket
import threading
from collections.abc import Callable

logger = logging.getLogger(__name__)

#: transport-level failures: the API server could not be reached, or the
#: connection to it was lost.
_TRANSPORT_EXCS = (ConnectionError, BrokenPipeError, socket.timeout,
                   TimeoutError, socket.gaierror, OSError)

#: OSError subclasses that are local failures (an unreadable token file, a
#: bad path), never evidence that the API server is unreachable.
_LOCAL_OS_EXCS = (FileNotFoundError, PermissionError, NotADirectoryError,
                  IsADirectoryError, FileExistsError, ProcessLookupError)


def pod_annotations(pod: dict) -> dict[str, str]:
    """The annotations of a pod object (API JSON), {} when it has none."""
    return pod.get("metadata", {}).get("annotations", {}) or {}


def _api_status(exc: BaseException) -> int | None:
    """The HTTP status an API error carries; None for any other error."""
    status = getattr(exc, "status", None)
    if isinstance(status, int) and not isinstance(exc, OSError):
        return status
    return None


def is_not_found(exc: BaseException) -> bool:
    """The API answered 404: the object is gone."""
    return _api_status(exc) == 404


def is_outage(exc: BaseException) -> bool:
    """Does this failure count as evidence that the API server is degraded
    or unreachable, as against a healthy server answering 4xx? A 5xx or
    status-0 API error, or a transport failure that is not a local one."""
    status = _api_status(exc)
    if status is not None:
        return status >= 500 or status == 0
    transport = (isinstance(exc, _TRANSPORT_EXCS)
                 and not isinstance(exc, _LOCAL_OS_EXCS))
    return transport or type(exc).__module__.startswith(("http.", "ssl"))


def watch_pod(kube, namespace: str, pod_name: str,
              deliver: Callable[[dict[str, str]], None],
              stop: threading.Event, watch_timeout_s: float,
              what: str) -> None:
    """Blocking loop of the tenant's watchers: deliver(annotations) for the
    pod as it is after each (re)subscribe and for every watch event, until
    `stop` is set or the pod is deleted. A failure (an outage, a raising
    `deliver`) re-subscribes after a second.

    It subscribes first, then re-reads the pod: a stamp made while the
    previous watch was down is caught by the re-read, one made after it is
    already queued on the open watch."""
    while not stop.is_set():
        try:
            watch = kube.watch_pods(
                namespace, field_selector=f"metadata.name={pod_name}",
                timeout_s=watch_timeout_s)
            try:
                pod = kube.get_pod(namespace, pod_name)
            except Exception as exc:
                if not is_not_found(exc):
                    raise
                logger.info("pod %s/%s deleted; %s watch ends",
                            namespace, pod_name, what)
                return
            deliver(pod_annotations(pod))
            for etype, pod_json in watch:
                if stop.is_set():
                    return
                if etype == "DELETED":
                    logger.info("pod %s/%s deleted; %s watch ends",
                                namespace, pod_name, what)
                    return
                deliver(pod_annotations(pod_json))
        except Exception as exc:  # noqa: BLE001 — keep watching; an
            # outage is routine (the re-subscribe + re-read absorbs it),
            # anything else deserves the louder line.
            (logger.info if is_outage(exc) else logger.warning)(
                "%s watch failed (%s); retrying", what, exc)
            stop.wait(1.0)
