"""Best-effort Kubernetes Events on pods.

The counterpart of ``gpumounter_tpu/k8s/events.py``, whole: the worker posts
``GPUMounted``, ``GPUUnmounted``, ``GPUMountFailed`` and
``GPUMountRollbackFailed`` (the reference's ``TPU*``), the slice coordinator
``GPUSliceRollback``.

The reference writes logs only (SURVEY.md §5 "no events on the Pod");
here every control-plane component surfaces outcomes where operators
actually look — `kubectl describe pod`. One shared manifest builder so
the worker, the elastic reconciler, the slice coordinator, and the
migration orchestrator emit the same shape under different `source`
components. Failures are logged and swallowed: events are advisory and
must never fail the operation they describe.
"""

from __future__ import annotations

import secrets
import time

from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("k8s.events")


def post_pod_event(kube, pod: Pod, reason: str, message: str,
                   event_type: str = "Normal",
                   component: str = "tpumounter") -> None:
    ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    manifest = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            "name": f"{pod.name[:200]}.tpumounter.{secrets.token_hex(4)}",
            "namespace": pod.namespace,
        },
        "involvedObject": {"kind": "Pod", "name": pod.name,
                           "namespace": pod.namespace, "uid": pod.uid},
        "reason": reason,
        "message": message[:1024],
        "type": event_type,
        "source": {"component": component},
        "firstTimestamp": ts,
        "lastTimestamp": ts,
        "count": 1,
    }
    try:
        kube.create_event(pod.namespace, manifest)
        posted = True
    except Exception as exc:  # noqa: BLE001 — events are advisory
        posted = False
        logger.debug("event post failed: %s", exc)
    # The flight recorder's timeline keeps the Event even when the API
    # post failed — during an outage the timeline is exactly where an
    # operator will look for what the cluster never got to see.
    from gpumounter_tpu_torch.obs.flight import FLIGHT
    FLIGHT.record("event", f"{reason}: {message}"[:240],
                  namespace=pod.namespace, pod=pod.name, reason=reason,
                  event_type=event_type, component=component,
                  posted=posted)
