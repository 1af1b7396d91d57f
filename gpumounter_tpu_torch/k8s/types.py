"""Thin typed view over Kubernetes Pod JSON.

The counterpart of ``gpumounter_tpu/k8s/types.py``: raw API JSON (dicts)
end to end, wrapped in this accessor class where convenient. The original
GPUMounter uses client-go's corev1.Pod structs.
"""

from __future__ import annotations

from typing import Any


class Pod:
    def __init__(self, obj: dict):
        self.obj = obj

    # --- metadata ---
    @property
    def name(self) -> str:
        return self.obj.get("metadata", {}).get("name", "")

    @property
    def namespace(self) -> str:
        return self.obj.get("metadata", {}).get("namespace", "")

    @property
    def uid(self) -> str:
        return self.obj.get("metadata", {}).get("uid", "")

    @property
    def labels(self) -> dict[str, str]:
        return self.obj.get("metadata", {}).get("labels", {}) or {}

    @property
    def annotations(self) -> dict[str, str]:
        return self.obj.get("metadata", {}).get("annotations", {}) or {}

    @property
    def owner_references(self) -> list[dict]:
        return self.obj.get("metadata", {}).get("ownerReferences", []) or []

    # --- spec ---
    @property
    def node_name(self) -> str:
        return self.obj.get("spec", {}).get("nodeName", "")

    @property
    def containers(self) -> list[dict]:
        return self.obj.get("spec", {}).get("containers", []) or []

    # --- status ---
    @property
    def phase(self) -> str:
        return self.obj.get("status", {}).get("phase", "")

    @property
    def pod_ip(self) -> str:
        return self.obj.get("status", {}).get("podIP", "")

    @property
    def container_statuses(self) -> list[dict]:
        return self.obj.get("status", {}).get("containerStatuses", []) or []

    @property
    def conditions(self) -> list[dict]:
        return self.obj.get("status", {}).get("conditions", []) or []

    def container_ids(self) -> list[tuple[str, str, str]]:
        """All containers as (name, runtime, container_id).

        The original GPUMounter uses only ContainerStatuses[0] and assumes the
        "docker://" prefix (pkg/util/util.go:22-23); we handle every
        container and both docker:// and containerd:// prefixes
        (SURVEY.md §7 "fix the warts").
        """
        out = []
        for cs in self.container_statuses:
            cid = cs.get("containerID", "")
            if "://" in cid:
                runtime, _, raw = cid.partition("://")
            else:
                runtime, raw = "", cid
            if raw:
                out.append((cs.get("name", ""), runtime, raw))
        return out

    def unschedulable_reason(self) -> str | None:
        """Reason string if the pod is Pending-Unschedulable.

        The original's checkCreateState detects PodReasonUnschedulable to map to
        InsufficientGPU (allocator.go:246-281).
        """
        if self.phase != "Pending":
            return None
        for cond in self.conditions:
            if cond.get("type") == "PodScheduled" and cond.get("status") == "False":
                if cond.get("reason") == "Unschedulable":
                    return cond.get("message") or "Unschedulable"
        return None

    @property
    def qos_class(self) -> str:
        return self.obj.get("status", {}).get("qosClass", "")

    def resource_limit(self, resource: str) -> int:
        """Sum of a named resource limit across containers."""
        total = 0
        for c in self.containers:
            limits = (c.get("resources") or {}).get("limits") or {}
            val = limits.get(resource)
            if val is not None:
                total += int(str(val))
        return total

    def __repr__(self) -> str:
        return f"Pod({self.namespace}/{self.name} phase={self.phase!r} node={self.node_name!r})"


def match_label_selector(labels: dict[str, str], selector: str) -> bool:
    """Equality-based selector matching: "k=v,k2=v2" (subset used by us)."""
    if not selector:
        return True
    for clause in selector.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if "!=" in clause:
            k, _, v = clause.partition("!=")
            if labels.get(k.strip()) == v.strip():
                return False
        elif "==" in clause:
            k, _, v = clause.partition("==")
            if labels.get(k.strip()) != v.strip():
                return False
        elif "=" in clause:
            k, _, v = clause.partition("=")
            if labels.get(k.strip()) != v.strip():
                return False
        else:  # bare key: existence
            if clause not in labels:
                return False
    return True


def get_nested(obj: dict, *path: str, default: Any = None) -> Any:
    cur: Any = obj
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur
