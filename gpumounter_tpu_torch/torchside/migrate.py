"""Tenant-side hook for live migrations.

The control plane's migration orchestrator signals the tenant through the
`tpumounter.io/migration-phase` annotation: "quiesce" on the source pod
before the drain, "resume" on the destination pod after the re-mount. The
tenant's half is the HotResumable pack / save / load / restore cycle,
split across two pods:

    # source-pod process
    def on_quiesce(signal):
        state = HotResumable.pack(params, optimizer_state_tree(opt))
        state.save(SHARED_CKPT)          # crosses pods via shared storage

    # destination-pod process, started on its new devices
    def on_resume(signal):
        wait_for_gpus(len(signal["chips"]))
        params, opt_tree = HotResumable.load(SHARED_CKPT).restore("cuda")

    watch_migration(kube, ns, pod, on_quiesce, on_resume)

After each callback returns, the watcher acks by stamping
`tpumounter.io/migration-ack`; the control plane reads it back, so the
orchestrator knows the state is packed before it pulls the devices (and
closes the downtime clock when the restore lands).

A checkpoint-assisted drain adds an optional third signal between quiesce
and drain:

    def on_checkpoint(signal):
        # confirm the pack from on_quiesce is durable host-side — the
        # orchestrator drains no device until this acks
        state.save(SHARED_CKPT)

    watch_migration(kube, ns, pod, on_quiesce, on_resume,
                    on_checkpoint=on_checkpoint)

A tenant without an on_checkpoint handler marks the signal seen but does
NOT ack it: the orchestrator times out and falls back to the classic
cold-restore drain, never blocking on a hookless tenant.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections.abc import Callable

from gpumounter_tpu_torch.torchside._kube import is_outage, watch_pod

logger = logging.getLogger(__name__)

# The control plane stamps and reads these names: they must match it.
ANNOT_PHASE = "tpumounter.io/migration-phase"
ANNOT_ACK = "tpumounter.io/migration-ack"

#: signal phase -> (callback slot, ack phase)
_PHASE_MAP = {"quiesce": ("on_quiesce", "quiesced"),
              "checkpoint": ("on_checkpoint", "checkpointed"),
              "resume": ("on_resume", "resumed")}


def migration_signal(annotations: dict[str, str]) -> dict | None:
    """Parse the migration-phase signal ({id, phase, ...}) or None."""
    raw = annotations.get(ANNOT_PHASE)
    if not raw:
        return None
    try:
        signal = json.loads(raw)
    except ValueError:
        logger.warning("unparseable %s annotation: %r", ANNOT_PHASE, raw)
        return None
    return signal if isinstance(signal, dict) and signal.get("id") else None


def watch_migration(kube, namespace: str, pod_name: str,
                    on_quiesce: Callable[[dict], None],
                    on_resume: Callable[[dict], None] | None = None,
                    stop: threading.Event | None = None,
                    watch_timeout_s: float = 30.0,
                    ack: bool = True,
                    on_checkpoint: Callable[[dict], None] | None = None,
                    ) -> None:
    """Blocking loop mirroring watch_chip_replacements: invoke the phase
    callback each time the migration signal changes, then (ack=True)
    stamp the ack annotation the orchestrator is polling for.

    Unlike the heal watcher there is NO baseline skip: a signal already
    present at start is delivered. A tenant process that (re)starts
    mid-migration must still pack or restore — the orchestrator is
    waiting on exactly that ack, whereas a heal marker present at startup
    describes a device set the fresh process already enumerated.
    Duplicate (id, phase) observations fire once.
    """
    stop = stop or threading.Event()
    state: dict = {"last": None}

    def _deliver(annotations: dict[str, str]) -> None:
        signal = migration_signal(annotations)
        if signal is None:
            return
        phase = signal.get("phase")
        key = (signal["id"], phase)
        if key == state["last"]:
            return
        if phase not in _PHASE_MAP:
            state["last"] = key  # terminal phases ("done") dedupe too
            return
        slot, ack_phase = _PHASE_MAP[phase]
        callback = {"on_quiesce": on_quiesce,
                    "on_checkpoint": on_checkpoint,
                    "on_resume": on_resume}[slot]
        logger.info("migration %s: %s signal received", signal["id"], phase)
        if callback is None:
            # No handler for this phase: record it seen but do NOT ack — an
            # ack claims the work (pack/restore) happened, and a phantom
            # "resumed" would close the orchestrator's downtime clock on a
            # restore that never ran.
            state["last"] = key
            return
        # A raising callback (devices not visible yet, a failed restore)
        # propagates to the watch loop, which re-subscribes and re-reads:
        # the signal is marked consumed only AFTER the callback returns, so
        # it is retried instead of dropped with its ack.
        callback(signal)
        state["last"] = key
        if ack:
            marker = {"id": signal["id"], "phase": ack_phase,
                      "at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}
            try:
                kube.patch_pod(namespace, pod_name, {
                    "metadata": {"annotations": {
                        ANNOT_ACK: json.dumps(marker)}}})
                logger.info("migration %s: acked %s", signal["id"],
                            ack_phase)
            except Exception as exc:  # noqa: BLE001 — the orchestrator
                # times out and falls back either way; an outage means the
                # next watch iteration likely fails too, so say which.
                logger.warning("migration ack failed (%s): %s",
                               "api outage" if is_outage(exc)
                               else "api error", exc)

    watch_pod(kube, namespace, pod_name, _deliver, stop, watch_timeout_s,
              "migration")
