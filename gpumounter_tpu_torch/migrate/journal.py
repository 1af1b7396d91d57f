"""The migration journal: a live migration's crash-safe state, one
annotation on the source pod.

The counterpart of ``gpumounter_tpu/migrate/journal.py``; the annotation
keys and the journal's fields are the reference's, kept as they are (they
are persisted). The pod is the record: an interrupted migration is
resumable after a master's restart (the new master scans for journals that
are not terminal), and deleting the source pod deletes it.

  tpumounter.io/migration        the journal's JSON (source pod)
  tpumounter.io/migration-lock   {"id", "role"} on the destination in flight
  tpumounter.io/migration-phase  {"id", "phase"}: the tenant's signal
  tpumounter.io/migration-ack    {"id", "phase"}: the tenant's answer
"""

from __future__ import annotations

import json
import time

ANNOT_JOURNAL = "tpumounter.io/migration"
ANNOT_LOCK = "tpumounter.io/migration-lock"
ANNOT_PHASE = "tpumounter.io/migration-phase"
ANNOT_ACK = "tpumounter.io/migration-ack"

#: the machine's phases in order ("checkpoint" only when asked for); "done"
#: is terminal
PHASES = ("quiesce", "checkpoint", "drain", "remount", "resume", "verify")
PHASE_DONE = "done"

#: terminal outcomes (journal["outcome"]; None in flight)
OUTCOMES = ("succeeded", "rolled-back", "failed", "aborted")


def new_journal(mid: str, source_ns: str, source_pod: str, dest_ns: str, dest_pod: str) -> dict:
    now = time.time()
    return {
        "id": mid,
        "source": {"namespace": source_ns, "pod": source_pod},
        "destination": {"namespace": dest_ns, "pod": dest_pod},
        "phase": PHASES[0],
        "outcome": None,
        "error": None,
        "chips": [],          # the UUIDs drained from the source
        "dest_before": None,  # the destination's GPUs before (the remount's diff)
        "dest_chips": [],     # the UUIDs mounted on the destination
        "quiesced": None,     # the tenant acked the quiesce in time
        "checkpoint": False,  # a checkpoint-assisted drain was asked for
        "checkpointed": None,  # the tenant acked its pack in time
        "resumed": None,      # the destination's tenant acked the resume
        "downtime_started_at": None,
        "downtime_s": None,
        "phase_durations_s": {},
        "created_at": now,
        "updated_at": now,
    }


def parse_journal(annotations: dict[str, str]) -> dict | None:
    raw = annotations.get(ANNOT_JOURNAL)
    if not raw:
        return None
    try:
        journal = json.loads(raw)
    except ValueError:
        return None
    return journal if isinstance(journal, dict) and journal.get("id") else None


def migration_active(annotations: dict[str, str], kube=None) -> str | None:
    """The id of the migration holding this pod (source or destination), or
    None. With `kube`, a destination's lock is checked against its source's
    journal and is stale (None) when that migration ended or is gone; an
    outage proves nothing, and the lock stands."""
    journal = parse_journal(annotations)
    if journal is not None and journal.get("outcome") is None:
        return str(journal["id"])
    raw = annotations.get(ANNOT_LOCK)
    if not raw:
        return None
    try:
        lock = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(lock, dict) or not lock.get("id"):
        return None
    mid = str(lock["id"])
    source = lock.get("source")
    if kube is None or not (isinstance(source, dict) and source.get("pod")):
        return mid
    from gpumounter_tpu_torch.k8s.errors import NotFoundError, classify_exception
    from gpumounter_tpu_torch.k8s.types import Pod
    try:
        src_journal = parse_journal(Pod(kube.get_pod(source.get("namespace", "default"),
                                                     source["pod"])).annotations)
    except NotFoundError:
        return None  # the source (and its journal) is gone: stale
    except Exception as exc:  # noqa: BLE001 — sorted before deciding
        if isinstance(classify_exception(exc), NotFoundError):
            return None
        return mid  # an outage cannot prove the lock stale
    if src_journal is None or src_journal.get("id") != mid \
            or src_journal.get("outcome") is not None:
        return None
    return mid


def dump(journal: dict) -> str:
    journal["updated_at"] = time.time()
    return json.dumps(journal, separators=(",", ":"))
