"""Tenant-side hook for reconciler heals.

When the control plane's elastic reconciler replaces a dead device it
stamps `tpumounter.io/chip-replaced` on the owner pod. The running PyTorch
process must react: the replacement is another device, which CUDA cannot
open in a process that enumerated the old set, so the tenant packs its
state and hands over to a new process image (HotResumable + handoff). This
module is the trigger: watch the annotation and call back on each heal.

    def on_heal(marker):
        state = HotResumable.pack(params, optimizer_state_tree(opt))
        handoff(state, CKPT)   # the new image: wait_for_gpus, load, restore

    watch_chip_replacements(kube, "default", "trainer", on_heal)
"""

from __future__ import annotations

import json
import logging
import threading
from collections.abc import Callable

from gpumounter_tpu_torch.torchside._kube import is_not_found, pod_annotations, watch_pod

logger = logging.getLogger(__name__)

#: stamped by the control plane, read here: the name must match it
ANNOT_REPLACED = "tpumounter.io/chip-replaced"


def chip_replacement(annotations: dict[str, str]) -> dict | None:
    """Parse the heal marker ({generation, removed, added, at}) or None."""
    raw = annotations.get(ANNOT_REPLACED)
    if not raw:
        return None
    try:
        marker = json.loads(raw)
    except ValueError:
        logger.warning("unparseable %s annotation: %r", ANNOT_REPLACED, raw)
        return None
    return marker if isinstance(marker, dict) else None


def watch_chip_replacements(kube, namespace: str, pod_name: str,
                            on_replace: Callable[[dict], None],
                            stop: threading.Event | None = None,
                            watch_timeout_s: float = 30.0) -> None:
    """Blocking loop: invoke on_replace(marker) every time the heal
    marker's generation advances. The marker present at start is the
    baseline — only NEW heals fire (a restarted tenant already enumerated
    the current device set)."""
    stop = stop or threading.Event()
    try:
        pod = kube.get_pod(namespace, pod_name)
    except Exception as exc:
        if not is_not_found(exc):
            raise
        logger.warning("pod %s/%s not found; nothing to watch",
                       namespace, pod_name)
        return
    baseline = chip_replacement(pod_annotations(pod))
    state = {"generation":
             int(baseline.get("generation", 0)) if baseline else 0}

    def _deliver(annots: dict[str, str]) -> None:
        marker = chip_replacement(annots)
        if marker is None:
            return
        generation = int(marker.get("generation", 0))
        if generation > state["generation"]:
            state["generation"] = generation
            logger.info("device heal observed (generation %d): %s",
                        generation, marker)
            on_replace(marker)

    watch_pod(kube, namespace, pod_name, _deliver, stop, watch_timeout_s,
              "heal")
